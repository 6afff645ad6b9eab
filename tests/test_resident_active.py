"""Resident × frontier composition (VERDICT r4 item 3): frontier rows
are SLICED from the resident packed adjacency and unpacked to id lists
on device (ops/dense_adj.packed_rows_to_ids) — no stored ELL, no
per-sweep hashing.  Reference analogue: only violating nodes effectively
move at reference ε (coloringMCMC_CPU.cpp:471-479)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu.models.base import check_coloring
from mcmc_colorer_tpu.models.mcmc_resident import ResidentMCMCColorer
from mcmc_colorer_tpu.ops.dense_adj import packed_rows_to_ids
from mcmc_colorer_tpu.ops.hashgen import hash_er_graph


def test_packed_rows_to_ids_matches_host_ell():
    """Unpacked packed-adjacency rows == the sorted host ELL rows."""
    c = ResidentMCMCColorer(700, 0.05, graph_seed=11)
    g = c.host_graph()
    ell = g.to_ell(pad_nodes_to=c.ell.n_pad, pad_degree_to=8)
    n_pad = c.ell.n_pad
    d_row = ((c.max_degree + 7) // 8) * 8
    ids = jnp.asarray([0, 3, 17, 699, 256], jnp.int32)
    bits = jnp.take(c.adj, ids, axis=0)
    rows = np.asarray(packed_rows_to_ids(bits, d_row, n_pad))
    host = np.sort(
        np.asarray(ell.neighbors)[np.asarray(ids)], axis=1
    )[:, :d_row]
    # host ELL pads with n_pad too; sorted ascending both sides
    np.testing.assert_array_equal(rows, host)


def test_active_iteration_bit_matches_ell_rows():
    """_active_iteration with adj_packed == with the real host ELL
    (same key, same state): the two row sources are interchangeable."""
    from mcmc_colorer_tpu.models.mcmc_active import (
        _active_iteration,
        _cnt_of,
    )

    c = ResidentMCMCColorer(700, 0.05, graph_seed=11)
    g = c.host_graph()
    n_pad = c.ell.n_pad
    d_row = ((c.max_degree + 7) // 8) * 8
    ell_host = g.to_ell(pad_nodes_to=n_pad, pad_degree_to=d_row)
    assert ell_host.n_pad == n_pad
    params = MCMCParams(
        n_colors=max(4, c.max_degree // 2),
        proposal=ProposalKind.BALANCE_DYNAMIC,
        taboo_iterations=2,
    )
    key = jax.random.key(7)
    k_c, k_it = jax.random.split(key)
    colors = jnp.where(
        c.ell.node_mask,
        jax.random.randint(k_c, (n_pad,), 0, params.n_colors, jnp.int32),
        jnp.int32(params.n_colors),
    )
    taboo = jnp.zeros((n_pad,), jnp.int32)
    cnt = _cnt_of(ell_host, colors, params=params)
    a = _active_iteration(
        ell_host, colors, taboo, cnt, k_it,
        cap=256, params=params,
    )
    b = _active_iteration(
        c.ell, colors, taboo, cnt, k_it,
        cap=256, params=params,
        adj_packed=c.adj, d_row=d_row,
    )
    for x, y, name in zip(a, b, ("colors", "taboo", "cnt")):
        np.testing.assert_array_equal(
            np.asarray(x), np.asarray(y), err_msg=name
        )


def test_resident_active_end_to_end_valid():
    p0 = ResidentMCMCColorer(1200, 0.04, graph_seed=21)
    params = MCMCParams(
        n_colors=max(4, p0.max_degree * 2 // 3),
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=True,
        max_iterations=80,
    )
    c = ResidentMCMCColorer(
        1200, 0.04, graph_seed=21, params=params, active=True
    )
    r = c.run(seed=5)
    assert r.extra["active"] is True
    assert r.extra["final_conflicts"] == 0
    assert check_coloring(c.host_graph(), r.colors)


def test_resident_active_rejects_ensemble_and_hastings():
    with pytest.raises(NotImplementedError, match="single-chain"):
        ResidentMCMCColorer(600, 0.05, graph_seed=9, n_chains=2, active=True)
    with pytest.raises(NotImplementedError, match="always-accept"):
        ResidentMCMCColorer(
            600, 0.05, graph_seed=9, active=True,
            params=MCMCParams(n_colors=40, hastings=True),
        )


def test_sharded_resident_active_matches_ell_backed():
    """The sharded resident frontier run equals the ELL-backed sharded
    frontier run on the SAME hash graph with the same seeds — the strip
    row-slices are a drop-in for stored neighbor rows."""
    from mcmc_colorer_tpu.parallel.mesh import make_mesh
    from mcmc_colorer_tpu.parallel.sharded import ShardedMCMCColorer

    spec = (1536, 0.03, 7)
    g = hash_er_graph(*spec)
    mesh = make_mesh(chains=2, shards=4)
    # tailcut OFF: the chain itself must be bit-identical; the repair
    # epilogues legitimately differ (strip-native independent-set vs
    # rank-space greedy), so they are excluded from the equality claim
    params = MCMCParams(
        n_colors=max(4, g.max_degree),
        proposal=ProposalKind.BALANCE_DYNAMIC,
        max_iterations=60,
        taboo_iterations=2,
        tailcut=False,
    )
    kw = dict(mesh=mesh, n_chains=2, active_cap=256)
    best_r, _ = ShardedMCMCColorer(
        None, params, resident_spec=spec, **kw
    ).run(seed=4)
    best_e, _ = ShardedMCMCColorer(
        g, params, backend="matmul", **kw
    ).run(seed=4)
    np.testing.assert_array_equal(
        best_r.conflict_trace, best_e.conflict_trace
    )
    np.testing.assert_array_equal(best_r.colors, best_e.colors)
    assert best_r.extra["final_conflicts"] == 0
    assert check_coloring(g, best_r.colors)


def test_resident_active_cap_exit_reports_real_conflicts():
    """Review r5: a run that exhausts max_iterations must report the
    REAL conflict count of its final coloring (and run the enabled
    tailcut against it) — the old loop left conflicts stale (0 when
    phase 1 ate the whole budget), faking convergence."""
    c = ResidentMCMCColorer(
        400, 0.2, graph_seed=5,
        params=MCMCParams(n_colors=3, tailcut=False, max_iterations=3),
        active=True,
    )
    r = c.run(seed=1)
    g = c.host_graph()
    valid = check_coloring(g, r.colors)
    assert r.extra["final_conflicts"] > 0 and not r.converged
    assert not valid
    assert all(x >= 0 for x in r.conflict_trace)
    # with tailcut on and a maxdeg palette (free colors always exist),
    # the repair must actually engage on the cap-exited coloring and
    # finish — not be skipped by a stale conflicts=0
    c2 = ResidentMCMCColorer(
        400, 0.2, graph_seed=5,
        params=MCMCParams(
            n_colors=c.max_degree, tailcut=True, max_iterations=2
        ),
        active=True,
    )
    r2 = c2.run(seed=1)
    assert r2.extra["tailcut_rounds"] >= 1
    assert r2.extra["final_conflicts"] == 0
    assert check_coloring(g, r2.colors)
