"""Smoke run of the balanced colorer on one NVIDIA GPU (or four, --multi).

Drives the system's main path once at the deployment the README's quick
start and ``bench.py`` define — the hash-defined Erdős–Rényi graph
ER(n=100,000, p=0.01), palette = max degree (~1,150 colors),
balance-dynamic proposal with tailcut, run to a valid coloring — and
checks every result against the repo's own references.  One process
holds the card; the CLI runs in-process (``cli.main``).

Phases, each reported on its own lines:

- ``device``: fails unless JAX's default backend is the GPU; prints the
  device kind and count, the allocator limit and ``nvidia-smi``'s name
  and power limit.
- ``nc``: the neighbor-color counts of the deployment's packed adjacency
  (n_pad 100,352, 3,200 words, n_col_pad 1,152) through the program's
  packed path, compared by exact integer equality with a dense int8
  contraction of the unpacked matrix; median time per call of each,
  ``memory_analysis()``, and where the optimized HLO sends the
  contraction.
- ``resident``: the CLI's ``--resident`` run, full sweeps and ``--active``,
  checked against the host re-derivation of the graph; time to solution
  split into compile, graph generation and chain + tailcut.
- ``gather``: a host-generated ER(100k, 0.01) uploaded as ELL: MCMC on
  the gather and the dense-adjacency backends, Luby, GFF and VFF, all
  checked; BA(100k, m=16) on the bucketed layout; per-sweep times.
- ``--multi`` (four cards): the resident graph sharded over a 1x4
  (chains, shards) mesh and a 2x2 ensemble with pooled annealing,
  compared with the same spec on a 1x1 mesh on card 0; per-card memory
  in use.  With this option no other phase runs.

Any failure ends the run with a non-zero exit.  The last line of standard
output is one JSON object naming the device.

Run: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import re
import statistics
import sys
import tempfile
import time

N, P, SEED = 100_000, 0.01, 1


def log(msg: str) -> None:
    print(msg, flush=True)


class CompileTimer:
    """Sums XLA backend compile durations reported through
    ``jax.monitoring`` while active."""

    def __init__(self):
        import jax

        self.total = 0.0
        self.active = False
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_kw):
        if self.active and "backend_compile" in event:
            self.total += duration

    @contextlib.contextmanager
    def measure(self):
        self.total, self.active = 0.0, True
        try:
            yield self
        finally:
            self.active = False


def phase_device(n_devices: int) -> dict:
    import jax

    from mcmc_colorer_tpu.utils.devinfo import device_record

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (backend "
            f"{jax.default_backend()!r})"
        )
    dev = device_record()
    if dev["count"] < n_devices:
        raise SystemExit(
            f"chip_smoke: needs {n_devices} GPUs, JAX sees {dev['count']}"
        )
    log(f"[device] kind {dev['kind']!r} count {dev['count']}")
    for d in jax.devices():
        log(f"[device] {d} bytes_limit {d.memory_stats()['bytes_limit']}")
    return dev


def _median_ms(fn, *args, reps: int = 10) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # warm-up (compile)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def gemm_route(hlo: str) -> tuple[str, bool]:
    """(route, unpack_fused) of the contraction in optimized GPU HLO:
    'cublas' for a cuBLAS/cuBLASLt custom call, 'triton_gemm' for a
    Triton gemm fusion, else 'other'.  The unpack is fused only when a
    Triton gemm fusion's computation holds the shift of the bit
    extraction; a library call takes materialised operands."""
    if re.search(r'custom_call_target="__cublas', hlo):
        return "cublas", False
    fused_calls = re.findall(
        r"fusion\(.*calls=(%[\w.\-]+).*__triton_gemm", hlo
    )
    if not fused_calls:
        return "other", False
    bodies = re.split(r"\n(?=%|ENTRY)", hlo)
    for name in fused_calls:
        for body in bodies:
            if body.startswith(name + " ") and "shift-right-logical" in body:
                return "triton_gemm", True
    return "triton_gemm", False


def _unpack_dense(adj, n_pad: int):
    """[n_pad, n_pad] int8 0/1 matrix of a packed adjacency, band by band
    into one donated buffer."""
    import jax
    import jax.numpy as jnp

    rows, words = adj.shape
    band = 6272 if rows % 6272 == 0 else rows
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :, None]

    @jax.jit
    def unpack(pk):
        r = pk.shape[0]
        bits = (pk.reshape(r, words // 128, 1, 128) >> shifts) & 1
        return bits.astype(jnp.int8).reshape(r, words * 32)[:, :n_pad]

    fill = jax.jit(
        lambda a, pk, r0: jax.lax.dynamic_update_slice(
            a, unpack(pk), (r0, 0)
        ),
        donate_argnums=(0,),
    )
    a = jnp.zeros((rows, n_pad), jnp.int8)
    for r0 in range(0, rows, band):
        a = fill(a, jax.lax.dynamic_slice_in_dim(adj, r0, band), r0)
    return a


def phase_nc(n: int = N, p: float = P, seed: int = SEED) -> dict:
    import jax
    import jax.numpy as jnp

    from mcmc_colorer_tpu.models.mcmc_resident import _round_up
    from mcmc_colorer_tpu.ops.dense_adj import neighbor_color_counts
    from mcmc_colorer_tpu.ops.hashgen import er_packed_on_device

    n_pad = _round_up(n, 2048)
    adj = er_packed_on_device(n, p, seed, n_pad)
    deg = jnp.sum(jax.lax.population_count(adj).astype(jnp.int32), axis=1)
    n_colors = int(jnp.max(deg))
    colors = jax.random.randint(
        jax.random.key(seed), (n_pad,), 0, n_colors, dtype=jnp.int32
    )
    mask = jnp.arange(n_pad) < n
    log(
        f"[nc] packed adjacency {adj.shape} uint32, n_colors {n_colors} "
        f"(n_col_pad {(n_colors + 127) // 128 * 128})"
    )
    packed_nc = jax.jit(
        lambda a, c: neighbor_color_counts(a, c, n_colors, mask)
    )
    compiled = packed_nc.lower(adj, colors).compile()
    route, fused = gemm_route(compiled.as_text())
    log(f"[nc] packed memory_analysis {compiled.memory_analysis()}")
    log(f"[nc] packed contraction route {route}, unpack fused {fused}")
    ref = compiled(adj, colors)
    packed_ms = _median_ms(compiled, adj, colors)
    dense = _unpack_dense(adj, n_pad)
    dense_c = jax.jit(
        lambda a, c: neighbor_color_counts(a, c, n_colors, mask)
    ).lower(dense, colors).compile()
    d_route, _ = gemm_route(dense_c.as_text())
    log(f"[nc] dense memory_analysis {dense_c.memory_analysis()}")
    log(f"[nc] dense contraction route {d_route}")
    got = dense_c(dense, colors)
    if not bool(jnp.array_equal(ref, got)):
        raise AssertionError("packed NC differs from the dense int8 NC")
    dense_ms = _median_ms(dense_c, dense, colors)
    log(f"[nc] packed (XLA unpack + int8 gemm) median {packed_ms:.3f} ms")
    log(f"[nc] dense int8 gemm median {dense_ms:.3f} ms")
    log("[nc] packed == dense: exact")
    del adj, dense, ref, got
    gc.collect()
    return {"packed_ms": packed_ms, "dense_ms": dense_ms, "route": route}


def _run_cli(argv: list[str], timer: CompileTimer) -> tuple[float, str]:
    """cli.main(argv) in-process; returns (wall seconds, stdout)."""
    from mcmc_colorer_tpu import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with timer.measure(), contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"cli.main{argv} returned {rc}:\n{out}")
    for line in out.splitlines():
        if "rep " in line or "materialised" in line:
            log(f"  {line}")
    return wall, out


def _logs(out_dir: str, tag: str) -> list[dict]:
    from mcmc_colorer_tpu.analysis.log_parser import parse_log_file

    paths = sorted(
        os.path.join(out_dir, f)
        for f in os.listdir(out_dir)
        if f.endswith(".log") and f"-{tag}-" in f
    )
    if not paths:
        raise AssertionError(f"no {tag} log in {out_dir}")
    recs = [parse_log_file(pth) for pth in paths]
    for r in recs:
        for key in ("nodes", "execution_time_s", "iterations"):
            if key not in r:
                raise AssertionError(f"{r['path']}: no {key!r} parsed")
    return recs


def phase_resident(timer: CompileTimer, n: int = N, p: float = P,
                   seed: int = SEED) -> dict:
    res = {}
    for mode, extra in (("full", []), ("active", ["--active"])):
        with tempfile.TemporaryDirectory() as tmp:
            argv = [
                "--mcmcgpu", "--simulate", str(p), "-n", str(n),
                "--resident", "--tailcut", "--check", "-S", str(seed),
                "-R", "2", "--outDir", tmp, *extra,
            ]
            wall, out = _run_cli(argv, timer)
            recs = _logs(tmp, "MCMC_GPU")
        m = re.search(r"materialised on device in ([\d.]+)s", out)
        gen_s = float(m.group(1))
        first, warm = recs[0], recs[1]
        res[mode] = {
            "compile_s": timer.total,
            "graph_gen_s": gen_s,
            "chain_tailcut_first_s": first["execution_time_s"],
            "chain_tailcut_s": warm["execution_time_s"],
            "iterations": warm["iterations"],
            "cli_wall_s": wall,
        }
        log(
            f"[resident:{mode}] time to solution: graph generation "
            f"{gen_s:.3f} s + chain+tailcut {warm['execution_time_s']:.3f} s "
            f"(warm repetition; first repetition "
            f"{first['execution_time_s']:.3f} s); XLA compile over the "
            f"whole call {timer.total:.3f} s; {warm['iterations']} "
            f"iterations; CLI wall {wall:.1f} s incl. host check"
        )
    return res


def _sweep_ms(colorer) -> float:
    """Median time of one sweep of a colorer's compiled chain segment,
    each timed call starting from the same initial coloring (far from
    converged, so every call runs exactly one sweep)."""
    import jax
    import jax.numpy as jnp

    carry = colorer._jit_init(colorer.ell, jax.random.key(0))
    one = jnp.int32(1)
    out = jax.block_until_ready(colorer._jit_segment(colorer.ell, carry, one))
    if int(out[3]) - int(carry[3]) != 1:
        raise AssertionError("the timed segment did not run one sweep")
    return _median_ms(colorer._jit_segment, colorer.ell, carry, one)


def phase_gather(timer: CompileTimer, n: int = N, p: float = P,
                 seed: int = SEED, ba_m: int = 16) -> dict:
    from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu.graph.generate import barabasi_albert, erdos_renyi
    from mcmc_colorer_tpu.models.base import check_coloring
    from mcmc_colorer_tpu.models.mcmc import MCMCColorer

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--simulate", str(p), "-n", str(n), "--tailcut",
                  "--check", "-S", str(seed), "--outDir", tmp]
        wall, _ = _run_cli(
            ["--mcmcgpu", "--lubygpu", "--grdffgpu", "--vffgpu",
             "--backend", "xla", *common],
            timer,
        )
        log(f"[gather] xla + Luby/GFF/VFF CLI wall {wall:.1f} s, "
            f"compile {timer.total:.1f} s")
        for tag in ("MCMC_GPU", "LUBY", "GFF", "VFF"):
            _logs(tmp, tag)
    with tempfile.TemporaryDirectory() as tmp:
        wall, _ = _run_cli(
            ["--mcmcgpu", "--backend", "matmul", "--simulate", str(p),
             "-n", str(n), "--tailcut", "--check", "-S", str(seed),
             "--outDir", tmp],
            timer,
        )
        log(f"[gather] matmul CLI wall {wall:.1f} s, "
            f"compile {timer.total:.1f} s")
        _logs(tmp, "MCMC_GPU")
    g = erdos_renyi(n, p, seed=seed)
    params = MCMCParams(
        n_colors=g.max_degree,
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=True,
    )
    for backend in ("xla", "matmul"):
        c = MCMCColorer(g, params, backend=backend)
        res[f"{backend}_sweep_ms"] = _sweep_ms(c)
        kind = "gather" if backend == "xla" else f"{c._adj.dtype} adjacency"
        log(f"[gather] {backend} ({kind}) sweep "
            f"{res[f'{backend}_sweep_ms']:.3f} ms")
        del c
        gc.collect()
    del g
    gc.collect()
    ba = barabasi_albert(n, ba_m, seed=seed)
    bp = MCMCParams(
        n_colors=ba.max_degree,
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=True,
    )
    t0 = time.perf_counter()
    r = MCMCColorer(ba, bp, layout="bucketed").run(seed=seed)
    dt = time.perf_counter() - t0
    if not check_coloring(ba, r.colors):
        raise AssertionError("BA bucketed coloring invalid")
    log(f"[gather] BA({n}, m={ba_m}) bucketed: maxdeg {ba.max_degree}, "
        f"{r.iterations} iterations, {r.extra['tailcut_rounds']} tailcut "
        f"rounds, valid, {dt:.1f} s incl. compile")
    return res


def phase_multi(n: int = N, p: float = P, seed: int = SEED) -> dict:
    import jax
    import numpy as np

    from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu.models.base import check_coloring
    from mcmc_colorer_tpu.ops.hashgen import hash_er_graph
    from mcmc_colorer_tpu.parallel.mesh import make_mesh
    from mcmc_colorer_tpu.parallel.sharded import (
        AnnealConfig,
        ShardedMCMCColorer,
    )

    params = MCMCParams(
        n_colors=0, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True
    )
    host = hash_er_graph(n, p, seed)
    runs = [
        ("1x1", make_mesh(chains=1, shards=1, devices=jax.devices()[:1]),
         False),
        ("1x4", make_mesh(chains=1, shards=4), False),
        ("2x2-anneal", make_mesh(chains=2, shards=2), True),
    ]
    res = {}
    for name, mesh, anneal in runs:
        t0 = time.perf_counter()
        colorer = ShardedMCMCColorer(
            None,
            params,
            mesh,
            anneal=AnnealConfig(enabled=anneal),
            resident_spec=(n, p, seed),
        )
        in_use = [
            (d.memory_stats() or {}).get("bytes_in_use")
            for d in jax.devices()
        ]
        best, _summ = colorer.run(seed=seed)
        dt = time.perf_counter() - t0
        used = len(np.unique(best.colors))
        ok = (
            check_coloring(host, best.colors)
            and best.extra["final_conflicts"] == 0
            and best.iterations <= colorer.params.max_iterations
            and used <= colorer.params.n_colors
        )
        log(
            f"[multi:{name}] iterations {best.iterations}, colors used "
            f"{used}/{colorer.params.n_colors}, tailcut rounds "
            f"{best.extra['tailcut_rounds']}, valid {ok}, {dt:.1f} s incl. "
            f"compile and strip build; bytes_in_use per card {in_use}"
        )
        if not ok:
            raise AssertionError(f"{name}: invalid or out-of-band result")
        res[name] = {"iterations": best.iterations, "used": used,
                     "bytes_in_use": in_use}
        del colorer
        gc.collect()
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--multi",
        action="store_true",
        help="run only the four-card sharded phase",
    )
    args = ap.parse_args(argv)
    dev = phase_device(4 if args.multi else 1)
    from mcmc_colorer_tpu.utils import compcache

    log(f"[device] compile cache {compcache.enable()}")
    t0 = time.perf_counter()
    if args.multi:
        phase_multi()
    else:
        timer = CompileTimer()
        phase_nc()
        phase_resident(timer)
        phase_gather(timer)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(dev["nvidia_smi"] or "nvidia-smi: not found")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev["platform"],
            "kind": dev["kind"],
            "count": dev["count"],
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
