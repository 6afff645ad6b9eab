"""Device-memory tracking (counterpart of GPUMemTracker, GPUutils.h:36-71).

The reference keeps static byte counters per subsystem (graph, colorer,
misc) — call sites mostly commented out.  Here the live numbers come from
the runtime: per-device memory stats plus a helper to size this framework's
own structures analytically.
"""

from __future__ import annotations

import jax


def device_memory_stats(device=None) -> dict:
    """Bytes in use / limit for a device (empty dict when the backend
    doesn't expose memory_stats, e.g. CPU)."""
    device = device or jax.devices()[0]
    stats = getattr(device, "memory_stats", lambda: None)()
    if not stats:
        return {}
    return {
        "bytes_in_use": stats.get("bytes_in_use", 0),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use", 0),
        "bytes_limit": stats.get("bytes_limit", 0),
    }


def estimate_run_bytes(
    n_nodes: int,
    max_degree: int,
    n_colors: int,
    block: int = 256,
    n_chains: int = 1,
) -> dict:
    """Analytic footprint of one MCMC chain run — the numbers the
    reference's tracker would report for its cudaMallocs
    (coloringMCMC_main.cu:27-53).  Note the reference's dominant
    allocation, the nnodes×nCol bool colorsChecker, does not exist here
    (occupancy is blockwise, SURVEY §10 hard part 3)."""
    ints = 4
    ell = n_nodes * max_degree * ints          # neighbor matrix
    nc = n_nodes * max_degree * ints           # gathered neighbor colors
    vectors = 5 * n_nodes * ints               # colors/star/taboo/unif/flags
    block_occ = block * n_colors * 5 * ints    # per-block working set
    total = (ell + nc + vectors) * n_chains + block_occ
    return {
        "ell_bytes": ell,
        "gather_bytes": nc,
        "vector_bytes": vectors * n_chains,
        "kernel_block_bytes": block_occ,
        "total_bytes": total,
        "reference_colors_checker_bytes": n_nodes * n_colors,  # what the
        # reference would have allocated (coloringMCMC_main.cu:39)
    }
