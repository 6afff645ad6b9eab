"""Device-resident hash-graph pipeline (ops/hashgen, models/mcmc_resident).

The hash graph exists in three independent renditions — numpy oracle,
threaded C++ enumerator, device bit-packed generator — which must agree
bit-for-bit; the resident colorer must produce valid colorings checked
against the HOST rendition (an end-to-end proof that the device ran the
same graph it never received)."""

import numpy as np
import pytest

from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu.models.base import check_coloring
from mcmc_colorer_tpu.models.mcmc_resident import (
    ResidentMCMCColorer,
    conflicts_from_packed,
)
from mcmc_colorer_tpu.ops import hashgen


def _unpack_cols(adj, n_pad):
    """Unpack [n_pad, words] packed bits to a dense bool [n_pad, k_total]
    using the packed_bit_coords order."""
    words = adj.shape[1]
    k_total = words * 32
    dense = np.zeros((adj.shape[0], k_total), bool)
    a = np.asarray(adj)
    for b in range(32):
        bits = ((a >> np.uint32(b)) & 1).astype(bool)
        w = np.arange(words)
        cols = (w // 128) * 4096 + b * 128 + (w % 128)
        dense[:, cols] |= bits
    return dense


def test_hash_three_way_agreement():
    n, p, seed = 700, 0.03, 13
    e_ref = hashgen.hash_edges_reference(n, p, seed)
    # C++ enumerator (skips gracefully when the native lib is absent)
    from mcmc_colorer_tpu.graph import native

    if native.available():
        g = native.generate_er_hash(n, hashgen.er_threshold(p), seed)
        u = np.repeat(np.arange(g.n), g.degrees)
        v = g.cols
        mask = u < v
        e_cpp = np.stack([u[mask], v[mask]], axis=1)
        e_cpp = e_cpp[np.lexsort((e_cpp[:, 1], e_cpp[:, 0]))]
        assert np.array_equal(e_ref, e_cpp)
    # device packed generator
    n_pad = 768
    adj = hashgen.er_packed_on_device(n, p, seed, n_pad, row_chunk=256)
    dense = _unpack_cols(adj, n_pad)
    got = np.argwhere(np.triu(dense[:n, :n], k=1))
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    assert np.array_equal(got, e_ref)
    # nothing outside the real vertex square
    assert dense[:, n:].sum() == 0 and dense[n:, :].sum() == 0
    # degrees/popcounts agree with the edge set
    deg = np.asarray(hashgen.degrees_from_packed(adj))
    assert deg.astype(np.int64).sum() == 2 * e_ref.shape[0]


def test_hash_er_graph_matches_oracle():
    g = hashgen.hash_er_graph(300, 0.05, 5)
    e_ref = hashgen.hash_edges_reference(300, 0.05, 5)
    assert g.n_edges == e_ref.shape[0]
    assert getattr(g, "simple_certified", False)


def test_conflicts_from_packed_matches_gather():
    import jax.numpy as jnp

    from mcmc_colorer_tpu.models.mcmc import _conflict_edges

    n, p, seed = 500, 0.05, 7
    g = hashgen.hash_er_graph(n, p, seed)
    ell = g.to_ell(pad_nodes_to=512)
    adj = hashgen.er_packed_on_device(n, p, seed, ell.n_pad, row_chunk=256)
    rng = np.random.default_rng(0)
    colors = jnp.where(
        ell.node_mask,
        jnp.asarray(rng.integers(0, 7, ell.n_pad).astype(np.int32)),
        jnp.int32(7),
    )
    c_nc = int(conflicts_from_packed(adj, colors, 7, ell.node_mask))
    c_gather = int(_conflict_edges(ell, colors))
    assert c_nc == c_gather > 0


def test_resident_colorer_valid_vs_host_graph():
    c = ResidentMCMCColorer(1200, 0.04, graph_seed=21)
    r = c.run(seed=3)
    g = c.host_graph()
    assert g.n_edges == c.n_edges and g.max_degree == c.max_degree
    assert r.extra["final_conflicts"] == 0
    assert r.extra["resident"] is True
    assert check_coloring(g, r.colors)


def test_resident_tailcut_tight_palette():
    """A palette at maxdeg/2 leaves real work for the NC tailcut; the
    independent-set repair must still end conflict-free and valid."""
    c0 = ResidentMCMCColorer(1200, 0.04, graph_seed=21)
    p = MCMCParams(
        n_colors=max(4, c0.max_degree // 2),
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=True,
        max_iterations=60,
    )
    c = ResidentMCMCColorer(1200, 0.04, graph_seed=21, params=p)
    r = c.run(seed=5)
    assert r.extra["final_conflicts"] == 0
    assert r.extra["tailcut_rounds"] >= 1
    assert check_coloring(c.host_graph(), r.colors)


def test_resident_rejects_oversize():
    """The packed adjacency is O(n^2/8) bytes: past the device's memory
    cap the constructor must refuse with a pointer to the scalable paths,
    not attempt a 100+ GB allocation."""
    with pytest.raises(ValueError, match="packed-adjacency memory cap"):
        ResidentMCMCColorer(
            1_000_000, 0.001, graph_seed=1, capacity=16 * 1024**3
        )


def test_resident_ratio_and_stats_shim():
    c = ResidentMCMCColorer(600, 0.05, graph_seed=9, num_col_ratio=2.0)
    from mcmc_colorer_tpu.config import default_n_colors

    assert c.params.n_colors == default_n_colors(c.max_degree, 2.0)
    s = c.stats_graph()
    assert s.n == 600 and s.n_edges == c.n_edges
    assert s.max_degree == c.max_degree
    assert s.degrees.shape == (600,)
    assert abs(s.mean_degree - 2 * c.n_edges / 600) < 1e-6


def test_resident_ensemble_best_of_chains():
    """Vmapped resident ensemble: all chains share one adjacency, the
    best chain is valid against the host rendition, and single-chain
    results are untouched by the ensemble machinery."""
    c = ResidentMCMCColorer(800, 0.04, graph_seed=31, n_chains=4)
    best, summaries = c.run_ensemble(seed=9)
    assert len(summaries) == 4
    assert best.extra["chains"] == 4
    assert best.extra["best_chain"] == summaries[best.extra["best_chain"]]["chain"]
    assert best.extra["final_conflicts"] == 0
    g = c.host_graph()
    assert check_coloring(g, best.colors)
    # run() dispatches to the ensemble and returns the same best
    best2 = c.run(seed=9)
    assert np.array_equal(best2.colors, best.colors)
    # chains genuinely differ (independent streams)
    assert len({s["class_std"] for s in summaries}) > 1


# ----------------------- sharded resident (round 4) -----------------------


def _mesh24():
    from mcmc_colorer_tpu.parallel.mesh import make_mesh

    return make_mesh(chains=2, shards=4)


def test_hash_strips_match_ell_built_strips():
    """Per-shard hash-generated strips must be bit-identical to the
    strips built band-wise from the host ELL of the same graph."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mcmc_colorer_tpu.parallel.sharded import (
        _build_packed_strips,
        _put_global,
    )

    n, p, seed = 700, 0.03, 13
    mesh = _mesh24()
    g = hashgen.hash_er_graph(n, p, seed)
    ell = g.to_ell(pad_nodes_to=1024)
    neigh = _put_global(
        np.asarray(ell.neighbors), NamedSharding(mesh, P("shards", None))
    )
    ref = np.asarray(_build_packed_strips(neigh, mesh))
    got = np.asarray(
        hashgen.er_packed_strips_on_device(n, p, seed, ell.n_pad, mesh)
    )
    assert np.array_equal(ref, got)


def test_sharded_resident_matches_classic_strips():
    """The resident sharded chain is bit-identical to the classic
    strip-backend chain on the host rendition of the same hash graph
    (same strips, same NC init, same seeds)."""
    from mcmc_colorer_tpu.parallel.sharded import ShardedMCMCColorer

    mesh = _mesh24()
    n, p, seed = 900, 0.04, 5
    params = MCMCParams(
        n_colors=40,
        proposal=ProposalKind.BALANCE_DYNAMIC,
        max_iterations=6,
    )
    res = ShardedMCMCColorer(
        None, params, mesh, n_chains=4, resident_spec=(n, p, seed)
    )
    g = hashgen.hash_er_graph(n, p, seed)
    cls = ShardedMCMCColorer(
        g, params, mesh, n_chains=4, backend="matmul"
    )
    b_res, s_res = res.run(seed=7)
    b_cls, s_cls = cls.run(seed=7)
    assert np.array_equal(b_res.colors, b_cls.colors)
    assert [s["conflicts"] for s in s_res] == [
        s["conflicts"] for s in s_cls
    ]


def test_sharded_resident_tailcut_valid():
    """Tight palette forces the strip-native independent-set repair;
    the result must be conflict-free and valid vs the host graph."""
    from mcmc_colorer_tpu.models.base import check_coloring
    from mcmc_colorer_tpu.parallel.sharded import ShardedMCMCColorer

    mesh = _mesh24()
    spec = (1200, 0.04, 21)
    c0 = ShardedMCMCColorer(
        None,
        MCMCParams(n_colors=0, tailcut=True),
        mesh,
        n_chains=2,
        resident_spec=spec,
    )
    p = MCMCParams(
        n_colors=max(4, c0.graph.max_degree // 2),
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=True,
        max_iterations=40,
    )
    c = ShardedMCMCColorer(
        None, p, mesh, n_chains=2, resident_spec=spec
    )
    best, _ = c.run(seed=4)
    assert best.extra["final_conflicts"] == 0
    assert check_coloring(c.host_graph(), best.colors)


def test_sharded_resident_rejects_bad_configs():
    from mcmc_colorer_tpu.parallel.sharded import ShardedMCMCColorer

    mesh = _mesh24()
    params = MCMCParams(n_colors=8)
    g = hashgen.hash_er_graph(300, 0.05, 1)
    with pytest.raises(ValueError, match="graph=None"):
        ShardedMCMCColorer(
            g, params, mesh, resident_spec=(300, 0.05, 1)
        )
    with pytest.raises(ValueError, match="matmul"):
        ShardedMCMCColorer(
            None, params, mesh, backend="xla",
            resident_spec=(300, 0.05, 1),
        )
    # resident + active_cap is LEGAL since round 5 (frontier rows are
    # sliced from the packed strip — tests/test_resident_active.py);
    # construction must succeed
    ShardedMCMCColorer(
        None, params, mesh, active_cap=128,
        resident_spec=(300, 0.05, 1),
    )


def test_sharded_resident_hbm_cap_precheck():
    """The per-shard strip HBM bound must refuse BEFORE attempting the
    build (an OOM mid-build is not an error message)."""
    from mcmc_colorer_tpu.parallel.sharded import ShardedMCMCColorer

    with pytest.raises(ValueError, match="GB per shard"):
        ShardedMCMCColorer(
            None,
            MCMCParams(n_colors=64),
            _mesh24(),
            resident_spec=(2_000_000, 0.0001, 1),
        )


def test_resident_luby_matches_classic_and_validates():
    """The resident Luby loop (hash adjacency, shim ELL) must produce
    exactly the classic matmul loop's coloring on the host rendition of
    the same graph, and it must be a valid proper coloring."""
    from mcmc_colorer_tpu.models.luby import LubyColorer

    n, p, seed = 900, 0.04, 17
    res = LubyColorer(None, resident_spec=(n, p, seed))
    r1 = res.run(seed=3)
    g = res.host_graph()
    cls = LubyColorer(g, backend="matmul")
    r2 = cls.run(seed=3)
    assert np.array_equal(r1.colors, r2.colors)
    assert r1.n_colors == r2.n_colors
    assert check_coloring(g, r1.colors)


def test_resident_luby_rejects_bad_configs():
    from mcmc_colorer_tpu.models.luby import LubyColorer

    g = hashgen.hash_er_graph(200, 0.05, 1)
    with pytest.raises(ValueError, match="graph=None"):
        LubyColorer(g, resident_spec=(200, 0.05, 1))
    with pytest.raises(ValueError, match="flat full matmul"):
        LubyColorer(None, active=True, resident_spec=(200, 0.05, 1))
    with pytest.raises(ValueError, match="matmul"):
        LubyColorer(None, backend="xla", resident_spec=(200, 0.05, 1))


def test_hash_graph_er_statistics():
    """The murmur-mix hash must produce a statistically sound G(n, p):
    edge count within 4 sigma of Binomial(n(n-1)/2, p), degree mean and
    variance near Binomial(n-1, p), and no degenerate vertex (the PRNG
    quality claim in ops/hashgen.py's docstring, checked rather than
    asserted)."""
    n, p = 3000, 0.02
    pairs = n * (n - 1) / 2
    for seed in (0, 1, 2):
        g = hashgen.hash_er_graph(n, p, seed)
        mu, sigma = pairs * p, (pairs * p * (1 - p)) ** 0.5
        assert abs(g.n_edges - mu) < 4 * sigma, (seed, g.n_edges, mu)
        degs = g.degrees.astype(np.float64)
        dmu, dvar = (n - 1) * p, (n - 1) * p * (1 - p)
        assert abs(degs.mean() - dmu) < 0.05 * dmu
        assert abs(degs.var() - dvar) < 0.25 * dvar
        # independence smoke: adjacent seeds share ~p^2 of their edges,
        # not more (distinct hash streams)
    e0 = set(map(tuple, hashgen.hash_edges_reference(800, 0.05, 10)))
    e1 = set(map(tuple, hashgen.hash_edges_reference(800, 0.05, 11)))
    overlap = len(e0 & e1) / max(1, len(e0))
    assert overlap < 0.08, overlap  # ~p=0.05 expected under independence


def test_resident_checkpoint_resume_bit_equal(tmp_path):
    """Mid-chain checkpoint + resume equals the uninterrupted run
    bit-for-bit (VERDICT r4 item 5): the graph never enters the
    artifact — it re-derives from (n, p, seed) in the resumed
    colorer's constructor."""
    spec = dict(n=1200, p=0.04, graph_seed=21)
    c0 = ResidentMCMCColorer(**{"n": spec["n"], "p": spec["p"],
                                "graph_seed": spec["graph_seed"]})
    p_full = MCMCParams(
        n_colors=max(4, c0.max_degree * 2 // 3),
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=True,
        max_iterations=60,
    )
    full = ResidentMCMCColorer(
        spec["n"], spec["p"], graph_seed=spec["graph_seed"], params=p_full
    ).run(seed=5)

    ck = str(tmp_path / "resident.npz")
    # "kill" mid-chain: a cap at 2 iterations exits with the chain
    # unfinished; the segment boundary wrote the checkpoint
    pre = ResidentMCMCColorer(
        spec["n"], spec["p"], graph_seed=spec["graph_seed"],
        params=p_full.replace(max_iterations=2),
    )
    r_pre = pre.run(seed=5, checkpoint_path=ck)
    assert r_pre.iterations == 2

    resumed = ResidentMCMCColorer(
        spec["n"], spec["p"], graph_seed=spec["graph_seed"], params=p_full
    ).run(seed=5, resume_from=ck)
    assert resumed.iterations == full.iterations
    np.testing.assert_array_equal(resumed.colors, full.colors)
    assert resumed.extra["final_conflicts"] == full.extra["final_conflicts"]


def test_resident_checkpoint_spec_mismatch(tmp_path):
    c = ResidentMCMCColorer(600, 0.05, graph_seed=9)
    ck = str(tmp_path / "a.npz")
    c.run(seed=1, checkpoint_path=ck)
    other = ResidentMCMCColorer(600, 0.05, graph_seed=10)
    with pytest.raises(AssertionError, match="graph spec mismatch"):
        other.run(seed=1, resume_from=ck)


def test_resident_ensemble_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "ens.npz")
    c0 = ResidentMCMCColorer(800, 0.04, graph_seed=31, n_chains=4)
    p_full = c0.params
    full, _ = c0.run_ensemble(seed=9)

    pre = ResidentMCMCColorer(
        800, 0.04, graph_seed=31, n_chains=4,
        params=p_full.replace(max_iterations=2),
    )
    pre.run_ensemble(seed=9, checkpoint_path=ck)
    resumed, summ = ResidentMCMCColorer(
        800, 0.04, graph_seed=31, n_chains=4, params=p_full
    ).run_ensemble(seed=9, resume_from=ck)
    np.testing.assert_array_equal(resumed.colors, full.colors)
    assert len(summ) == 4


def test_hashgen_stats_split():
    """The stats path splits the one-time generation cost into compile
    and band execution, and builds the same adjacency as the plain path."""
    s = {}
    a = hashgen.er_packed_on_device(1500, 0.02, 3, 2048, 1024, stats=s)
    assert set(s) == {"compile_s", "execute_s", "bands"}
    assert s["compile_s"] >= 0 and s["execute_s"] >= 0 and s["bands"] >= 1
    b = hashgen.er_packed_on_device(1500, 0.02, 3, 2048, 1024)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resident_free_color_trace(monkeypatch):
    """NC-native per-segment free-color stats under TRACE (the resident
    rendition of the reference's getStatsFreeColors lines)."""
    monkeypatch.setenv("MCMC_COLORER_TRACE", "1")
    c = ResidentMCMCColorer(800, 0.04, graph_seed=31)
    r = c.run(seed=3)
    segs = r.extra.get("free_color_trace_segments")
    assert segs
    for mn, mx, avg in segs:
        assert 0 <= mn <= avg <= mx <= c.params.n_colors
