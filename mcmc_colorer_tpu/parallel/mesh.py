"""Device-mesh and multi-host plumbing.

The reference is single-process/single-GPU with no communication backend
(SURVEY §2.3 item 7).  This framework scales along two axes instead:

* ``chains`` — independent MCMC chains (embarrassingly parallel; pooled
  statistics via ``psum``-style cross-chain reductions),
* ``shards`` — vertex partitions of one chain (halo colors exchanged with
  ``all_gather`` per sweep, conflict counts and histograms ``psum``-ed).

Collectives ride ICI within a pod slice; multi-host runs initialise
`jax.distributed` first.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up (`jax.distributed.initialize`).  No-op when the
    runtime is already initialised or single-process args are absent."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialised


def factor_mesh(n_devices: int, prefer_chains: int | None = None) -> tuple[int, int]:
    """Split a device count into (chains, shards).  Prefers the requested
    chain count when it divides; otherwise the most balanced factoring
    with chains ≥ shards."""
    if prefer_chains and n_devices % prefer_chains == 0:
        return prefer_chains, n_devices // prefer_chains
    best = (n_devices, 1)
    c = int(n_devices**0.5)
    while c >= 1:
        if n_devices % c == 0:
            best = (n_devices // c, c)
            break
        c -= 1
    return best


def make_mesh(
    chains: int | None = None,
    shards: int | None = None,
    devices=None,
) -> Mesh:
    """Build a 2D ``(chains, shards)`` mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if chains is None and shards is None:
        chains, shards = factor_mesh(n)
    elif chains is None:
        chains = n // shards
    elif shards is None:
        shards = n // chains
    if chains * shards != n:
        raise ValueError(
            f"mesh {chains}x{shards} != {n} devices"
        )
    import numpy as np

    return Mesh(
        np.asarray(devices).reshape(chains, shards), ("chains", "shards")
    )
