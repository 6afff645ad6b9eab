"""Multi-host dryrun: 2 jax.distributed processes driving ONE sharded
ensemble over a mesh that spans both.

The reference is single-process/single-GPU (SURVEY §2.3 item 7); this
framework's multi-host story is `parallel/mesh.py:initialize_distributed`
+ the (chains, shards) shard_map of `parallel/sharded.py`.  This script
validates the full path on CPU: each process exposes 4 virtual CPU devices, the two
coordinate through a localhost jax.distributed coordinator, and the 2x4
mesh's ``chains`` axis crosses the process boundary — every collective
(psum'd conflict counts, tiled all_gather halos, pooled annealing, the
`process_allgather` host readbacks) runs across processes exactly as it
would across hosts (BASELINE.md config 5).

Also exercised: ensemble checkpoint save from BOTH processes (allgathered
shards → complete file on every host) and resume.

Usage:
    python scripts/dryrun_multihost.py              # launcher: spawns 2
    python scripts/dryrun_multihost.py --process-id N --nproc 2  # worker
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

PORT = int(os.environ.get("MC_DRYRUN_PORT", "12931"))


def worker(process_id: int, nproc: int, ckpt_dir: str) -> None:
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    import jax

    from mcmc_colorer_tpu.parallel.mesh import initialize_distributed

    initialize_distributed(
        coordinator_address=f"localhost:{PORT}",
        num_processes=nproc,
        process_id=process_id,
    )
    assert len(jax.devices()) == 4 * nproc, jax.devices()
    assert len(jax.local_devices()) == 4

    import numpy as np

    from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu.graph.generate import erdos_renyi
    from mcmc_colorer_tpu.models.base import check_coloring
    from mcmc_colorer_tpu.parallel.mesh import make_mesh
    from mcmc_colorer_tpu.parallel.sharded import (
        AnnealConfig,
        ShardedMCMCColorer,
    )

    # identical graph on every process (same seed, deterministic sampler)
    g = erdos_renyi(600, 0.05, seed=12, use_native=False)
    params = MCMCParams(
        n_colors=g.max_degree,
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=True,
    )
    # chains axis = nproc -> each process owns one chain row; the shards
    # axis stays intra-process (ICI analogue); chain collectives cross DCN
    mesh = make_mesh(chains=nproc, shards=4)
    colorer = ShardedMCMCColorer(
        g, params, mesh, n_chains=2 * nproc, anneal=AnnealConfig(enabled=True)
    )
    best, summaries = colorer.run(seed=3)
    assert len(summaries) == 2 * nproc
    assert best.extra["final_conflicts"] == 0, summaries
    assert check_coloring(g, best.colors)

    # ensemble checkpoint: every process writes a complete file
    ckpt = os.path.join(ckpt_dir, f"ens_p{process_id}.npz")
    state = colorer.init_state(seed=3)
    import jax.numpy as jnp

    state = colorer._jit_segment(
        colorer._sharded_neighbors(), colorer._adj_strip, state, jnp.int32(2)
    )
    colorer.save_checkpoint(state, ckpt)
    resumed, _ = colorer.run(seed=0, resume_from=ckpt)
    assert check_coloring(g, resumed.colors)
    assert np.array_equal(resumed.colors, best.colors), (
        "resume diverged from the straight-through run"
    )
    print(f"[p{process_id}] MULTIHOST DRYRUN PASSED", flush=True)


def launcher(nproc: int, ckpt_dir: str) -> int:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                os.path.abspath(__file__),
                "--process-id",
                str(i),
                "--nproc",
                str(nproc),
                "--ckpt-dir",
                ckpt_dir,
            ],
            env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(nproc)
    ]
    ok = True
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        passed = f"[p{i}] MULTIHOST DRYRUN PASSED" in out
        ok &= passed and p.returncode == 0
        if not passed or p.returncode != 0:
            print(f"--- process {i} (rc={p.returncode}) ---\n{out}")
    print("MULTIHOST DRYRUN:", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="/tmp")
    args = ap.parse_args(argv)
    if args.process_id is None:
        return launcher(args.nproc, args.ckpt_dir)
    worker(args.process_id, args.nproc, args.ckpt_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
