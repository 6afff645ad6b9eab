"""Measure the sharded path's per-sweep collective volume from compiled HLO.

Real multi-chip wall-clock is unmeasurable on this one-chip image, but the
*communication volume* the design would put on ICI is a compile-time fact:
this script jits one sharded segment on the 8-virtual-device CPU mesh and
walks the optimized HLO for collective ops (all-gather, all-reduce,
collective-permute, reduce-scatter), summing their output bytes.  Each op
inside the sweep while_loop executes once per iteration, so the sums are
bytes per sweep (per chip, receive side).  Feeds the weak-scaling model in
PERF.md (BASELINE.md's >=70% criterion).

Usage: python scripts/collective_volume.py [n] [p]
"""

import os
import re
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu.graph.generate import erdos_renyi
from mcmc_colorer_tpu.parallel.mesh import make_mesh
from mcmc_colorer_tpu.parallel.sharded import ShardedMCMCColorer

_DTYPE_BYTES = {
    "f32": 4, "s32": 4, "u32": 4, "s8": 1, "u8": 1, "pred": 1,
    "f16": 2, "bf16": 2, "s64": 8, "u64": 8, "f64": 8,
}

_COLLECTIVES = (
    "all-gather", "all-reduce", "collective-permute", "reduce-scatter",
    "all-to-all",
)


def shape_bytes(shape_str: str) -> int:
    m = re.match(r"(\w+)\[([\d,]*)\]", shape_str)
    if not m:
        return 0
    dt, dims = m.group(1), m.group(2)
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dt, 4)


def collective_bytes(hlo_text: str) -> dict:
    out = {}
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.match(r"%?\S+ = (\(?[^)]*\)?[^ ]*) (\w[\w.-]*)\(", line)
        if not m:
            continue
        op = m.group(2)
        name = None
        for c in _COLLECTIVES:
            if op == c or op.startswith(c + "-start") or op.startswith(c + "."):
                name = c
        if name is None:
            continue
        shapes = re.findall(r"(\w+\[[\d,]*\])", m.group(1))
        b = sum(shape_bytes(s) for s in shapes)
        out[name] = out.get(name, 0) + b
    return out


def measure(colorer, label):
    state = colorer.init_state(seed=1)
    lowered = colorer._jit_segment.lower(
        colorer._sharded_neighbors(),
        colorer._adj_strip,
        state,
        jnp.int32(4),
    )
    txt = lowered.compile().as_text()
    vol = collective_bytes(txt)
    total = sum(vol.values())
    print(f"{label}: per-sweep collective bytes/chip = {total:,}")
    for k, v in sorted(vol.items()):
        print(f"    {k}: {v:,}")
    return total


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8000
    p = float(sys.argv[2]) if len(sys.argv) > 2 else 0.01
    g = erdos_renyi(n, p, seed=7)
    params = MCMCParams(
        n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC
    )
    mesh = make_mesh(chains=2, shards=4)
    print(f"graph n={g.n} m={g.n_edges} maxdeg={g.max_degree}; mesh 2x4")
    for backend in ("xla", "matmul"):
        c = ShardedMCMCColorer(g, params, mesh, n_chains=2, backend=backend)
        total = measure(c, f"backend={backend:>6}")
        n_pad = c._n_pad
        print(
            f"    model: all_gather(star) = n_pad*4 = {4*n_pad:,} bytes "
            f"+ small psums; measured/model ratio {total/(4*n_pad):.2f}"
        )
    c = ShardedMCMCColorer(
        g, params, mesh, n_chains=2, backend="xla", active_cap=128
    )
    measure(c, "backend=xla+active(128)")


if __name__ == "__main__":
    main()
