import jax
import numpy as np
import pytest

from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu.models.base import check_coloring
from mcmc_colorer_tpu.parallel.chains import EnsembleMCMCColorer
from mcmc_colorer_tpu.parallel.mesh import factor_mesh, make_mesh
from mcmc_colorer_tpu.parallel.sharded import AnnealConfig, ShardedMCMCColorer


def _params(g, **kw):
    return MCMCParams(n_colors=g.max_degree, **kw)


def test_factor_mesh():
    assert factor_mesh(8) == (4, 2)
    assert factor_mesh(8, prefer_chains=8) == (8, 1)
    assert factor_mesh(7) == (7, 1)
    assert factor_mesh(16, prefer_chains=4) == (4, 4)


def test_make_mesh_axes():
    mesh = make_mesh(chains=4, shards=2)
    assert mesh.shape == {"chains": 4, "shards": 2}


def test_ensemble_local(small_er):
    colorer = EnsembleMCMCColorer(small_er, _params(small_er), n_chains=4)
    best, summaries = colorer.run(seed=13)
    assert len(summaries) == 4
    assert best.extra["final_conflicts"] == 0
    assert check_coloring(small_er, best.colors)
    # best chain is no worse than any other
    assert best.extra["final_conflicts"] <= min(
        s["conflicts"] for s in summaries
    )


def test_ensemble_on_mesh(medium_er):
    mesh = make_mesh(chains=8, shards=1)
    colorer = EnsembleMCMCColorer(
        medium_er, _params(medium_er), n_chains=8, mesh=mesh
    )
    best, summaries = colorer.run(seed=3)
    assert check_coloring(medium_er, best.colors)
    assert best.extra["n_chains"] == 8


def test_sharded_2x4(medium_er):
    mesh = make_mesh(chains=2, shards=4)
    colorer = ShardedMCMCColorer(
        medium_er,
        _params(medium_er, tailcut=True),
        mesh,
        n_chains=4,  # 2 chains per chain-axis element
    )
    best, summaries = colorer.run(seed=17)
    assert len(summaries) == 4
    assert check_coloring(medium_er, best.colors)
    assert best.extra["final_conflicts"] == 0


def test_sharded_matches_single_chip_statistics(small_er):
    """Vertex sharding must not change chain semantics: same proposal
    family, similar convergence behavior."""
    mesh = make_mesh(chains=1, shards=8)
    p = _params(small_er)
    sharded, _ = ShardedMCMCColorer(mesh=mesh, graph=small_er, params=p).run(
        seed=23
    )
    assert check_coloring(small_er, sharded.colors) or sharded.extra[
        "final_conflicts"
    ] > 0
    assert sharded.extra["final_conflicts"] == 0
    assert sharded.iterations <= p.max_iterations


def test_sharded_actually_shards(medium_er):
    """Every shard must own real vertices (regression: padding to
    shards×block once left all real vertices in shard 0, silently making
    vertex sharding a no-op on small graphs)."""
    for shards in (2, 4):
        mesh = make_mesh(
            chains=1, shards=shards, devices=jax.devices()[:shards]
        )
        c = ShardedMCMCColorer(medium_er, _params(medium_er), mesh)
        n_loc = c.ell.n_pad // shards
        assert n_loc < medium_er.n, (
            f"shard size {n_loc} >= n — only shard 0 holds real vertices"
        )


def test_sharded_active_cap(medium_er):
    """Frontier sweeps (active_cap) must preserve the chain contract:
    lock-step convergence to a valid coloring with exact conflict
    bookkeeping (the incremental cnt psum must agree with the full
    recount at the end: conflicts==0 iff check_coloring passes)."""
    mesh = make_mesh(chains=2, shards=4)
    colorer = ShardedMCMCColorer(
        medium_er,
        _params(medium_er, tailcut=True),
        mesh,
        n_chains=2,
        active_cap=128,
    )
    best, summaries = colorer.run(seed=31)
    assert check_coloring(medium_er, best.colors)
    assert best.extra["final_conflicts"] == 0


def test_sharded_active_matches_full_count(small_er):
    """With a cap so large the frontier always fits, active sweeps start
    from iteration 1; the run must still converge and report conflicts
    consistent with an independent recount of the returned coloring."""
    from mcmc_colorer_tpu.models.base import count_conflict_edges

    mesh = make_mesh(chains=1, shards=2, devices=jax.devices()[:2])
    p = _params(small_er)
    colorer = ShardedMCMCColorer(
        small_er, p, mesh, active_cap=10**9
    )
    best, _ = colorer.run(seed=37)
    ell = small_er.to_ell()
    import jax.numpy as jnp

    pad = np.full(ell.n_pad, p.n_colors, np.int32)
    pad[: small_er.n] = best.colors
    recount = int(count_conflict_edges(ell, jnp.asarray(pad)))
    assert best.extra["final_conflicts"] == recount == 0


def test_sharded_hastings(small_er):
    """Metropolis-Hastings acceptance across the (chains, shards) mesh:
    the λ-weighted ratio gates the swap identically on every shard (one
    uniform from the shard-replicated chain key) and the run still
    reaches a valid coloring via the tailcut epilogue."""
    mesh = make_mesh(chains=2, shards=4)
    p = _params(small_er, hastings=True, tailcut=True)
    colorer = ShardedMCMCColorer(small_er, p, mesh, n_chains=2)
    best, summaries = colorer.run(seed=41)
    assert check_coloring(small_er, best.colors)
    assert len(summaries) == 2


def test_sharded_hastings_rejects_active(small_er):
    """Frontier sweeps never materialise the passive set's q, so the
    Hastings ratio is undefined there — must refuse loudly."""
    mesh = make_mesh(chains=2, shards=4)
    with pytest.raises(NotImplementedError):
        ShardedMCMCColorer(
            small_er,
            _params(small_er, hastings=True),
            mesh,
            active_cap=128,
        )


def test_sharded_tailcut_stays_on_mesh(medium_er):
    """The tailcut epilogue runs shard-resident (no flat single-device
    ELL rebuild) and still zeroes the conflicts."""
    from mcmc_colorer_tpu.parallel.sharded import _run_tailcut_sharded

    mesh = make_mesh(chains=1, shards=4, devices=jax.devices()[:4])
    p = MCMCParams(n_colors=max(3, medium_er.max_degree // 3), tailcut=True)
    colorer = ShardedMCMCColorer(medium_er, p, mesh)
    best, _ = colorer.run(seed=43)
    assert check_coloring(medium_er, best.colors)
    assert best.extra["final_conflicts"] == 0


def test_sharded_annealing_runs(medium_er):
    mesh = make_mesh(chains=4, shards=2)
    p = MCMCParams(
        n_colors=max(2, medium_er.max_degree // 2),
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=True,
    )
    colorer = ShardedMCMCColorer(
        medium_er,
        p,
        mesh,
        n_chains=4,
        anneal=AnnealConfig(enabled=True, window=5, boost=4.0),
    )
    best, _ = colorer.run(seed=29)
    assert best.extra["final_eps_scale"] >= 1.0
    assert check_coloring(medium_er, best.colors)


def test_sharded_segmented_matches_single_shot(medium_er):
    """The segmented loop (traced rip_limit) must be bit-identical to the
    single-segment run — the state tuple captures the chain completely."""
    mesh = make_mesh(chains=2, shards=4)
    p = _params(medium_er)
    a, _ = ShardedMCMCColorer(medium_er, p, mesh, n_chains=4).run(seed=5)
    b, _ = ShardedMCMCColorer(medium_er, p, mesh, n_chains=4).run(
        seed=5, segment=3
    )
    assert np.array_equal(a.colors, b.colors)
    assert a.iterations == b.iterations
    assert np.array_equal(a.conflict_trace, b.conflict_trace)


def test_sharded_checkpoint_resume(medium_er, tmp_path):
    """Checkpoint the (chains, shards) ensemble mid-run, reload into a
    FRESH colorer, and finish — the result must equal the uninterrupted
    run exactly (VERDICT r1: ensemble checkpoint/resume)."""
    mesh = make_mesh(chains=2, shards=4)
    p = _params(medium_er)
    ckpt = str(tmp_path / "ens.npz")

    ref, _ = ShardedMCMCColorer(medium_er, p, mesh, n_chains=4).run(seed=9)

    import jax.numpy as jnp

    c1 = ShardedMCMCColorer(medium_er, p, mesh, n_chains=4)
    state = c1.init_state(seed=9)
    state = c1._jit_segment(
        c1._sharded_neighbors(), c1._adj_strip, state, jnp.int32(2)
    )
    c1.save_checkpoint(state, ckpt)

    c2 = ShardedMCMCColorer(medium_er, p, mesh, n_chains=4)
    res, _ = c2.run(seed=0, resume_from=ckpt)  # seed ignored on resume
    assert np.array_equal(ref.colors, res.colors)
    assert res.iterations == ref.iterations


def test_sharded_checkpoint_reshards_to_new_mesh(medium_er, tmp_path):
    """A checkpoint written on a 2x4 mesh resumes on a 4x2 mesh (elastic
    recovery across mesh geometries)."""
    p = _params(medium_er)
    ckpt = str(tmp_path / "ens.npz")
    import jax.numpy as jnp

    c1 = ShardedMCMCColorer(
        medium_er, p, make_mesh(chains=2, shards=4), n_chains=4
    )
    state = c1.init_state(seed=9)
    state = c1._jit_segment(
        c1._sharded_neighbors(), c1._adj_strip, state, jnp.int32(2)
    )
    c1.save_checkpoint(state, ckpt)

    c2 = ShardedMCMCColorer(
        medium_er, p, make_mesh(chains=4, shards=2), n_chains=4
    )
    res, _ = c2.run(seed=0, resume_from=ckpt)
    assert check_coloring(medium_er, res.colors)
    assert res.extra["final_conflicts"] == 0


def test_multihost_two_process_dryrun():
    """TWO jax.distributed processes drive one sharded ensemble over a
    mesh whose chains axis crosses the process boundary — psum/all_gather
    collectives and checkpoint/resume run inter-process, the CPU stand-in
    for a multi-host pod (BASELINE.md config 5; SURVEY §2.3 item 7)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["MC_DRYRUN_PORT"] = "12947"
    r = subprocess.run(
        [sys.executable, os.path.join(root, "scripts", "dryrun_multihost.py")],
        env=env,
        capture_output=True,
        text=True,
        timeout=420,
        cwd=root,
    )
    assert "MULTIHOST DRYRUN: PASSED" in r.stdout, r.stdout[-2000:]


def test_sharded_matmul_backend_bitexact(medium_er):
    """The adjacency-strip backend (each shard contracts its packed
    [n_loc, n_pad] strip) runs the SAME chain as the gather backend:
    identical colors, iterations and conflict traces given one seed."""
    mesh = make_mesh(chains=2, shards=4)
    p = _params(medium_er, tailcut=True)
    r_xla, s_xla = ShardedMCMCColorer(
        medium_er, p, mesh, n_chains=2, backend="xla"
    ).run(seed=29)
    c_mm = ShardedMCMCColorer(
        medium_er, p, mesh, n_chains=2, backend="matmul"
    )
    assert c_mm._adj_strip is not None
    assert c_mm._adj_strip.shape[0] == c_mm._n_pad
    r_mm, s_mm = c_mm.run(seed=29)
    assert check_coloring(medium_er, r_mm.colors)
    assert np.array_equal(r_xla.colors, r_mm.colors)
    assert r_xla.iterations == r_mm.iterations
    assert [s["conflicts"] for s in s_xla] == [s["conflicts"] for s in s_mm]


def test_sharded_matmul_strip_contents(small_er):
    """Per-shard strips decode to exactly the rows of the global packed
    adjacency (same bit order as the single-device build)."""
    from mcmc_colorer_tpu.ops.dense_adj import build_packed_adjacency
    from mcmc_colorer_tpu.parallel.sharded import _build_packed_strips

    mesh = make_mesh(chains=2, shards=4)
    c = ShardedMCMCColorer(
        small_er, _params(small_er), mesh, backend="matmul"
    )
    strips = np.asarray(jax.device_get(c._adj_strip))
    ref = np.asarray(build_packed_adjacency(small_er, c._n_pad))
    assert np.array_equal(strips, ref)


def test_sharded_matmul_hastings(small_er):
    """Hastings over the strip backend: the reverse pass reads NC(star)
    and the run stays well-formed."""
    mesh = make_mesh(chains=2, shards=4)
    p = _params(small_er, hastings=True, max_iterations=20)
    r_mm, _ = ShardedMCMCColorer(
        small_er, p, mesh, n_chains=2, backend="matmul"
    ).run(seed=5)
    r_x, _ = ShardedMCMCColorer(
        small_er, p, mesh, n_chains=2, backend="xla"
    ).run(seed=5)
    assert np.array_equal(r_mm.colors, r_x.colors)
    assert r_mm.iterations == r_x.iterations


def test_sharded_matmul_active_cap(medium_er):
    """active_cap composes with the strip backend: full sweeps ride the
    strip contraction, frontier sweeps the gathers; the run stays valid."""
    mesh = make_mesh(chains=2, shards=4)
    p = _params(medium_er, tailcut=True)
    r, _ = ShardedMCMCColorer(
        medium_er, p, mesh, n_chains=2, backend="matmul", active_cap=128
    ).run(seed=11)
    assert check_coloring(medium_er, r.colors)
