"""Adjacency-contraction backend (ops/dense_adj.py, mcmc backend='matmul').

The matmul formulation must be *distribution-identical* to the gather
paths: same occupancy, same proposal q, same inverse-CDF choice given the
same uniforms.  On CPU this is testable bit-exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu.models.base import check_coloring
from mcmc_colorer_tpu.models.mcmc import (
    MCMCColorer,
    _conflict_edges,
    _sweep,
    _sweep_matmul,
    _variant_distribution,
)
from mcmc_colorer_tpu.ops.dense_adj import (
    build_dense_adjacency,
    dense_adj_ok,
    neighbor_color_counts,
)
from mcmc_colorer_tpu.ops.neighbor import color_histogram, neighbor_colors


def _params(g, **kw):
    kw.setdefault("proposal", ProposalKind.BALANCE_DYNAMIC)
    return MCMCParams(n_colors=g.max_degree, **kw)


def test_nc_matches_gather_counts(medium_er):
    g = medium_er
    ell = g.to_ell(pad_nodes_to=128)
    n_col = g.max_degree
    adj = build_dense_adjacency(g, ell.n_pad)
    key = jax.random.key(3)
    colors = jnp.where(
        ell.node_mask,
        jax.random.randint(key, (ell.n_pad,), 0, n_col, jnp.int32),
        jnp.int32(n_col),
    )
    nc = neighbor_color_counts(adj, colors, n_col, ell.node_mask)
    # per-row tally of gathered neighbor colors
    ncg = neighbor_colors(ell.neighbors, jnp.where(ell.node_mask, colors, -1))
    ref = jax.vmap(
        lambda row: jnp.sum(
            row[:, None] == jnp.arange(n_col)[None, :],
            axis=0,
            dtype=jnp.int32,
        )
    )(ncg)
    assert np.array_equal(np.asarray(nc[:, :n_col]), np.asarray(ref))
    assert not np.any(np.asarray(nc[:, n_col:]))  # padded columns zero


def test_sweep_matmul_bitexact_vs_gather_sweep(medium_er):
    """Same uniforms -> identical star colors, taboo and conflict count."""
    g = medium_er
    ell = g.to_ell(pad_nodes_to=128)
    params = _params(g, taboo_iterations=3)
    adj = build_dense_adjacency(g, ell.n_pad)
    key = jax.random.key(9)
    k_c, k_u = jax.random.split(key)
    colors = jnp.where(
        ell.node_mask,
        jax.random.randint(k_c, (ell.n_pad,), 0, params.n_colors, jnp.int32),
        jnp.int32(params.n_colors),
    )
    taboo = jnp.zeros((ell.n_pad,), jnp.int32)
    unif = jax.random.uniform(k_u, (ell.n_pad,), dtype=jnp.float32)
    hist = color_histogram(colors, params.n_colors, ell.node_mask)
    p_eff = _variant_distribution(params, hist, g.n)

    star_g, taboo_g, logq_g = _sweep(
        ell, params, 128, colors, taboo, unif, p_eff
    )
    star_m, taboo_m, logq_m, conf_m, _nc = _sweep_matmul(
        ell, adj, params, 128, colors, taboo, unif, p_eff
    )
    assert np.array_equal(np.asarray(star_g), np.asarray(star_m))
    assert np.array_equal(np.asarray(taboo_g), np.asarray(taboo_m))
    assert np.isclose(float(logq_g), float(logq_m), rtol=1e-6)
    assert int(conf_m) == int(_conflict_edges(ell, colors))


def test_chain_matmul_valid(medium_er):
    c = MCMCColorer(
        medium_er, _params(medium_er, tailcut=True), backend="matmul"
    ).run(seed=21)
    assert check_coloring(medium_er, c.colors)
    assert c.extra["final_conflicts"] == 0


def test_chain_matmul_hastings(small_er):
    p = _params(small_er, hastings=True, tailcut=True)
    c = MCMCColorer(small_er, p, backend="matmul").run(seed=5)
    assert check_coloring(small_er, c.colors)


_GB16 = 16 * 1024**3  # the capacity the gates were first sized for


def test_dense_adj_gates(small_er):
    assert not dense_adj_ok(200_000, _GB16)
    assert not dense_adj_ok(1024, _GB16, d_mean=3.0)  # tiny gather volume
    assert dense_adj_ok(102_400, _GB16, d_mean=1000.0)
    with pytest.raises(ValueError):
        MCMCColorer(
            small_er, _params(small_er), backend="matmul", layout="bucketed"
        )


def _unpack(packed: np.ndarray, n_cols: int) -> np.ndarray:
    """Decode the packed_bit_coords layout back to a dense 0/1 matrix."""
    from mcmc_colorer_tpu.ops.dense_adj import packed_bit_coords

    word, bit = packed_bit_coords(np.arange(n_cols, dtype=np.int64))
    return ((packed[:, word] >> bit[None, :].astype(np.uint32)) & 1).astype(
        np.int8
    )


def test_packed_adj_build_matches_dense(medium_er):
    """The uint32 bit layout decodes to exactly the dense 0/1 matrix."""
    from mcmc_colorer_tpu.ops.dense_adj import (
        build_packed_adjacency,
        packed_adj_words,
    )

    g = medium_er
    ell = g.to_ell(pad_nodes_to=128)
    packed = np.asarray(build_packed_adjacency(g, ell.n_pad))
    assert packed.shape == (ell.n_pad, packed_adj_words(ell.n_pad))
    dense = np.asarray(build_dense_adjacency(g, ell.n_pad))
    assert np.array_equal(_unpack(packed, ell.n_pad), dense)


def test_packed_nc_matches_dense_nc(medium_er):
    g = medium_er
    ell = g.to_ell(pad_nodes_to=128)
    n_col = g.max_degree
    from mcmc_colorer_tpu.ops.dense_adj import build_packed_adjacency

    adj_d = build_dense_adjacency(g, ell.n_pad)
    adj_p = build_packed_adjacency(g, ell.n_pad)
    key = jax.random.key(7)
    colors = jnp.where(
        ell.node_mask,
        jax.random.randint(key, (ell.n_pad,), 0, n_col, jnp.int32),
        jnp.int32(n_col),
    )
    nc_d = neighbor_color_counts(adj_d, colors, n_col, ell.node_mask)
    nc_p = neighbor_color_counts(adj_p, colors, n_col, ell.node_mask)
    assert np.array_equal(np.asarray(nc_d), np.asarray(nc_p))


def test_packed_nc_multiwindow():
    """Graph wider than one PACKED_K_CHUNK window exercises the
    fori_loop accumulation across unpack windows."""
    from mcmc_colorer_tpu.graph.generate import erdos_renyi
    from mcmc_colorer_tpu.ops.dense_adj import (
        PACKED_K_CHUNK,
        build_packed_adjacency,
    )

    g = erdos_renyi(PACKED_K_CHUNK + 640, 0.002, seed=4)
    ell = g.to_ell(pad_nodes_to=128)
    assert ell.n_pad > PACKED_K_CHUNK
    n_col = g.max_degree
    adj_d = build_dense_adjacency(g, ell.n_pad)
    adj_p = build_packed_adjacency(g, ell.n_pad)
    key = jax.random.key(11)
    colors = jnp.where(
        ell.node_mask,
        jax.random.randint(key, (ell.n_pad,), 0, n_col, jnp.int32),
        jnp.int32(n_col),
    )
    nc_d = neighbor_color_counts(adj_d, colors, n_col, ell.node_mask)
    nc_p = neighbor_color_counts(adj_p, colors, n_col, ell.node_mask)
    assert np.array_equal(np.asarray(nc_d), np.asarray(nc_p))


@pytest.mark.parametrize(
    "n, p, n_colors, strip",
    [
        (1000, 0.05, 100, False),    # one K window, n_col_pad 128
        (1000, 0.05, 1100, False),   # n_col_pad 1152
        (1000, 0.05, 3000, False),   # n_col_pad 3072
        (1000, 0.05, 1100, True),    # strip rows != n_pad
        (4700, 0.01, 100, False),    # two K windows
        (4700, 0.01, 1100, True),
        (4700, 0.01, 3000, True),
    ],
)
def test_packed_nc_windows_palettes_strips(n, p, n_colors, strip):
    """Packed NC (the XLA unpack + int8 contraction) against a plain
    per-edge count, over one and several 4096-column windows, padded
    palettes of 128/1,152/3,072 columns, and a row strip whose height
    differs from n_pad (the sharded formulation)."""
    from mcmc_colorer_tpu.graph.generate import erdos_renyi
    from mcmc_colorer_tpu.ops.dense_adj import build_packed_adjacency

    g = erdos_renyi(n, p, seed=2, use_native=False)
    ell = g.to_ell(pad_nodes_to=128)
    n_pad = ell.n_pad
    adj_p = build_packed_adjacency(g, n_pad)
    rng = np.random.default_rng(n + n_colors)
    colors = rng.integers(0, n_colors, size=n_pad).astype(np.int32)
    colors[n:] = n_colors  # phantom: out of palette
    n_col_pad = (n_colors + 127) // 128 * 128
    want = np.zeros((n_pad, n_col_pad), np.int64)
    src = np.repeat(np.arange(n), np.diff(g.row_ptr))
    np.add.at(want, (src, colors[g.cols]), 1)
    r0, r1 = (128, 384) if strip else (0, n_pad)
    got = neighbor_color_counts(
        adj_p[r0:r1], jnp.asarray(colors), n_colors, ell.node_mask
    )
    assert got.shape == (r1 - r0, n_col_pad)
    np.testing.assert_array_equal(np.asarray(got), want[r0:r1])


def test_sweep_matmul_packed_bitexact(medium_er):
    """The packed adjacency drives the SAME sweep bit-exactly (dtype
    dispatch inside neighbor_color_counts)."""
    from mcmc_colorer_tpu.ops.dense_adj import build_packed_adjacency

    g = medium_er
    ell = g.to_ell(pad_nodes_to=128)
    params = _params(g, taboo_iterations=3)
    adj_d = build_dense_adjacency(g, ell.n_pad)
    adj_p = build_packed_adjacency(g, ell.n_pad)
    key = jax.random.key(13)
    k_c, k_u = jax.random.split(key)
    colors = jnp.where(
        ell.node_mask,
        jax.random.randint(k_c, (ell.n_pad,), 0, params.n_colors, jnp.int32),
        jnp.int32(params.n_colors),
    )
    taboo = jnp.zeros((ell.n_pad,), jnp.int32)
    unif = jax.random.uniform(k_u, (ell.n_pad,), dtype=jnp.float32)
    hist = color_histogram(colors, params.n_colors, ell.node_mask)
    p_eff = _variant_distribution(params, hist, g.n)
    out_d = _sweep_matmul(ell, adj_d, params, 128, colors, taboo, unif, p_eff)
    out_p = _sweep_matmul(ell, adj_p, params, 128, colors, taboo, unif, p_eff)
    for a, b in zip(out_d[:2], out_p[:2]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.isclose(float(out_d[2]), float(out_p[2]), rtol=1e-6)
    assert int(out_d[3]) == int(out_p[3])


def test_packed_duplicate_edges():
    """Duplicate input edges (io keeps them) must not corrupt bit words."""
    from mcmc_colorer_tpu.graph.container import Graph
    from mcmc_colorer_tpu.ops.dense_adj import build_packed_adjacency

    # 0-1 edge duplicated both ways, plus a 0-2 edge
    rows = np.array([0, 0, 0, 1, 1, 2], np.int64)
    cols = np.array([1, 1, 2, 0, 0, 0], np.int64)
    g = Graph.from_edges(3, rows, cols, both_directions_present=True)
    packed = np.asarray(build_packed_adjacency(g, 8))
    ref = np.zeros((8, 8), np.int8)
    ref[0, 1] = ref[0, 2] = ref[1, 0] = ref[2, 0] = 1
    assert np.array_equal(_unpack(packed, 8), ref)


def test_packed_adj_gates():
    from mcmc_colorer_tpu.ops.dense_adj import packed_adj_ok

    assert not packed_adj_ok(102_400, _GB16)   # dense regime: dense wins
    assert not packed_adj_ok(300_000, _GB16)   # above the packed cap
    assert packed_adj_ok(204_800, _GB16, d_mean=500.0)
    # gather already cheaper
    assert not packed_adj_ok(204_800, _GB16, d_mean=50.0)


def test_chain_matmul_packed_valid(medium_er):
    """backend='matmul' with a forced packed adjacency colors validly."""
    from mcmc_colorer_tpu.ops.dense_adj import build_packed_adjacency

    colorer = MCMCColorer(
        medium_er, _params(medium_er, tailcut=True), backend="matmul"
    )
    colorer._adj = build_packed_adjacency(medium_er, colorer.ell.n_pad)
    c = colorer.run(seed=21)
    assert check_coloring(medium_er, c.colors)
    assert c.extra["final_conflicts"] == 0


def test_dense_adj_awkward_pad_factors():
    """n_pad = 128·13 has no 8-way 128-aligned split; the chunk search
    must climb until chunk·n_pad also fits int32 (round-2 regression:
    n_pad=100096 picked chunk=50048 and tripped the int32 assert)."""
    from mcmc_colorer_tpu.graph.generate import erdos_renyi
    from mcmc_colorer_tpu.ops.dense_adj import build_dense_adjacency

    g = erdos_renyi(1600, 0.05, seed=1)
    ell = g.to_ell(pad_nodes_to=128)
    assert ell.n_pad == 1664  # 128 * 13
    a = np.asarray(build_dense_adjacency(g, ell.n_pad))
    ref = np.zeros((ell.n_pad, ell.n_pad), np.int8)
    deg = np.asarray(g.degrees)
    u = np.repeat(np.arange(g.n), deg)
    ref[u, np.asarray(g.cols)] = 1
    assert np.array_equal(a, ref)


def test_ell_builders_match_host_builds(medium_er):
    """The device-side ELL builds (no host edge arrays) are bit-equal to
    the host-scatter builds, including multi-window widths."""
    from mcmc_colorer_tpu.graph.generate import erdos_renyi
    from mcmc_colorer_tpu.ops.dense_adj import (
        PACKED_K_CHUNK,
        build_dense_adjacency_from_ell,
        build_packed_adjacency,
        build_packed_adjacency_from_ell,
    )

    for g in (medium_er, erdos_renyi(PACKED_K_CHUNK + 640, 0.002, seed=4)):
        ell = g.to_ell(pad_nodes_to=128)
        dense_h = np.asarray(build_dense_adjacency(g, ell.n_pad))
        dense_e = np.asarray(build_dense_adjacency_from_ell(ell))
        assert np.array_equal(dense_h, dense_e)
        packed_h = np.asarray(build_packed_adjacency(g, ell.n_pad))
        packed_e = np.asarray(build_packed_adjacency_from_ell(ell))
        assert np.array_equal(packed_h, packed_e)


def test_ell_builder_duplicate_edges():
    """Duplicate edges (set-scatter) stay exact in the ELL packed build."""
    from mcmc_colorer_tpu.graph.container import Graph
    from mcmc_colorer_tpu.ops.dense_adj import (
        build_packed_adjacency_from_ell,
    )

    rows = np.array([0, 0, 0, 1, 1, 2], np.int64)
    cols = np.array([1, 1, 2, 0, 0, 0], np.int64)
    g = Graph.from_edges(3, rows, cols, both_directions_present=True)
    ell = g.to_ell(pad_nodes_to=8)
    packed = np.asarray(build_packed_adjacency_from_ell(ell))
    ref = np.zeros((8, 8), np.int8)
    ref[0, 1] = ref[0, 2] = ref[1, 0] = ref[2, 0] = 1
    assert np.array_equal(_unpack(packed, 8), ref)


def test_get_adjacency_cache(medium_er):
    """One build per (graph, n_pad, kind), shared across colorers."""
    from mcmc_colorer_tpu.ops import dense_adj as da

    g = medium_er
    ell = g.to_ell(pad_nodes_to=128)
    a1 = da.get_adjacency(g, ell.n_pad, "dense", ell=ell)
    a2 = da.get_adjacency(g, ell.n_pad, "dense")
    assert a1 is a2
    p1 = da.get_adjacency(g, ell.n_pad, "packed", ell=ell)
    assert p1 is da.get_adjacency(g, ell.n_pad, "packed", ell=ell)
    assert a1 is not p1
    assert set(g._adj_cache) == {(ell.n_pad, "dense"), (ell.n_pad, "packed")}


def test_build_stats_and_calibration(small_er):
    """get_adjacency fills per-phase stats; warning-free builds (VERDICT
    r3 items 1a and 4)."""
    import warnings

    from mcmc_colorer_tpu.ops.dense_adj import adjacency_nnz, get_adjacency

    g = small_er
    ell = g.to_ell(pad_nodes_to=8)
    stats = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        adj = get_adjacency(g, ell.n_pad, "packed", ell, stats=stats)
        nnz = adjacency_nnz(adj)
    assert nnz == 2 * g.n_edges
    assert stats["cached"] is False
    assert stats["compile_s"] >= 0 and stats["scatter_s"] >= 0
    assert stats["total_s"] >= stats["scatter_s"]
    stats2 = {}
    get_adjacency(g, ell.n_pad, "packed", ell, stats=stats2)
    assert stats2["cached"] is True


def test_simple_certified_skips_nnz_check(small_er):
    """Generator graphs are certified simple: the multigraph nnz pass is
    skipped (VERDICT r3 item 1d) — while imported graphs still pay it
    (test_matmul_refuses_duplicate_edges)."""
    from unittest import mock

    from mcmc_colorer_tpu.ops import dense_adj

    g = small_er
    assert getattr(g, "simple_certified", False)
    g.__dict__.pop("_adj_cache", None)
    ell = g.to_ell(pad_nodes_to=8)
    with mock.patch.object(
        dense_adj, "check_adjacency_complete",
        side_effect=AssertionError("must not be called"),
    ):
        dense_adj.get_adjacency(g, ell.n_pad, "dense", ell)


def test_matmul_refuses_duplicate_edges():
    """The 0/1 adjacency cannot represent multigraphs: get_adjacency
    verifies nnz == 2m and refuses (review r3 — silent divergence from
    the gather backends otherwise)."""
    from mcmc_colorer_tpu.graph.container import Graph
    from mcmc_colorer_tpu.ops.dense_adj import get_adjacency

    rows = np.array([0, 0, 0, 1, 1, 2], np.int64)
    cols = np.array([1, 1, 2, 0, 0, 0], np.int64)
    g = Graph.from_edges(3, rows, cols, both_directions_present=True)
    ell = g.to_ell(pad_nodes_to=8)
    with pytest.raises(ValueError, match="duplicate edges"):
        get_adjacency(g, ell.n_pad, "packed", ell)
