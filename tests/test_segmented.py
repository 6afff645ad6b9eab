"""Segmented execution must be bit-equal to one-shot execution.

Round 2 root-caused the round-1 "kernel faults" to the ~60 s
single-execution wall (utils/segmented.py): every device-resident colorer
loop is now compiled with a traced iteration budget and host-driven in
segments.  These tests drive each loop with budget=1 (the worst case: one
body iteration per device execution) and assert the result is identical to
a single execution — the carry tuples capture the loops completely.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu.graph.generate import erdos_renyi
from mcmc_colorer_tpu.models.base import check_coloring
from mcmc_colorer_tpu.utils import rng as rngu
from mcmc_colorer_tpu.utils.segmented import drive_segments


@pytest.fixture(scope="module")
def g():
    return erdos_renyi(600, 0.02, seed=7)


def _drive(segment_fn, carry, progress, budget=1):
    """Plain fixed-budget host loop (no adaptation — worst case)."""
    steps, done = progress(carry)
    while not done:
        carry = segment_fn(carry, jnp.int32(budget))
        steps, done = progress(carry)
    return carry


def test_mcmc_chain_segment1_equals_oneshot(g):
    from mcmc_colorer_tpu.models.mcmc import (
        _chain_init,
        _chain_segment,
        _run_chain,
        choose_block_size,
    )

    p = MCMCParams(
        n_colors=max(4, g.max_degree // 2),
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=False,
    )
    block = choose_block_size(g.n, p.n_colors)
    ell = g.to_ell(pad_nodes_to=block)
    key = rngu.for_repetition(rngu.root_key(3), 0)

    colors1, rip1, conf1, trace1, _ = jax.jit(
        lambda e, k: _run_chain(e, k, params=p, block=block)
    )(ell, key)

    seg = jax.jit(
        lambda e, c, b: _chain_segment(
            e, c, b, params=p, block=block
        )
    )
    z = p.tailcut_threshold(g.n)
    carry = jax.jit(
        lambda e, k: _chain_init(e, k, params=p, fused=False)
    )(ell, key)
    carry = _drive(
        lambda c, b: seg(ell, c, b),
        carry,
        lambda c: (
            int(c[3]),
            int(c[4]) <= z or int(c[3]) >= p.max_iterations,
        ),
    )
    assert int(carry[3]) == int(rip1)
    assert int(carry[4]) == int(conf1)
    assert np.array_equal(np.asarray(carry[0]), np.asarray(colors1))
    assert np.array_equal(np.asarray(carry[5]), np.asarray(trace1))


def test_mcmc_colorer_run_is_segment_invariant(g):
    """The public runner (adaptive segments) returns the same coloring as
    a forced 1-iteration-per-execution drive."""
    from mcmc_colorer_tpu.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu.utils import segmented

    p = MCMCParams(
        n_colors=max(4, g.max_degree // 2),
        proposal=ProposalKind.STANDARD,
        tailcut=True,
    )
    r_adaptive = MCMCColorer(g, p).run(seed=11)
    old = segmented.SEGMENT_TARGET_S
    try:
        segmented.SEGMENT_TARGET_S = 0.0  # forces budget=1 every segment
        r_forced = MCMCColorer(g, p).run(seed=11)
    finally:
        segmented.SEGMENT_TARGET_S = old
    assert np.array_equal(r_adaptive.colors, r_forced.colors)
    assert r_adaptive.iterations == r_forced.iterations
    assert (
        r_adaptive.extra["tailcut_rounds"] == r_forced.extra["tailcut_rounds"]
    )


def test_tailcut_segment1_equals_oneshot(g):
    from mcmc_colorer_tpu.models.mcmc import (
        _tailcut_any,
        _tailcut_finish,
        _tailcut_init,
        _tailcut_max_rounds,
        _tailcut_segment,
        choose_block_size,
    )

    p = MCMCParams(n_colors=max(4, g.max_degree + 1))
    block = choose_block_size(g.n, p.n_colors)
    ell = g.to_ell(pad_nodes_to=block)
    # a deliberately conflicted coloring
    colors = jnp.asarray(
        np.random.default_rng(0).integers(
            0, 3, size=ell.n_pad, dtype=np.int32
        )
    )
    key = rngu.root_key(5)
    c1, conf1, r1 = jax.jit(
        lambda e, c, k: _tailcut_any(
            e, c, jnp.int32(10), k, params=p, block=block
        )
    )(ell, colors, key)

    cr, ordered = jax.jit(lambda e, c: _tailcut_init(e, c, params=p))(
        ell, colors
    )
    seg = jax.jit(
        lambda e, c, k, b: _tailcut_segment(
            e, c, k, b, params=p, block=block
        )
    )
    tc_max = _tailcut_max_rounds(ell)
    tc = (cr, jnp.int32(10), jnp.int32(0), jnp.bool_(False))
    tc = _drive(
        lambda c, b: seg(ell, c, key, b),
        tc,
        lambda c: (int(c[2]), bool(c[3]) or int(c[2]) >= tc_max),
    )
    c2 = jax.jit(lambda e, c, o: _tailcut_finish(e, c, o, params=p))(
        ell, tc[0], ordered
    )
    assert int(tc[2]) == int(r1)
    assert int(tc[1]) == int(conf1)
    assert np.array_equal(np.asarray(c2), np.asarray(c1))


def test_luby_segment1_equals_oneshot(g):
    from mcmc_colorer_tpu.models.luby import (
        LubyColorer,
        _luby_init,
        _luby_segment,
        _run_luby,
    )

    ell = g.to_ell(pad_nodes_to=8)
    key = rngu.for_repetition(rngu.root_key(9), 0)
    colors1, n1 = jax.jit(_run_luby)(ell, key)

    seg = jax.jit(_luby_segment)
    carry = jax.jit(_luby_init)(ell, key)
    carry = _drive(
        lambda c, b: seg(ell, c, b),
        carry,
        lambda c: (int(c[5]), bool(c[6])),
    )
    assert int(carry[1]) == int(n1)
    assert np.array_equal(np.asarray(carry[0]), np.asarray(colors1))
    # and the public runner agrees
    r = LubyColorer(g).run(seed=9)
    assert r.n_colors == int(n1)
    assert check_coloring(g, r.colors)


def test_luby_bucketed_segment1_equals_oneshot(g):
    from mcmc_colorer_tpu.models.luby import (
        _luby_init,
        _luby_segment_bucketed,
        _run_luby_bucketed,
    )

    g2, _ = g.degree_relabel(descending=True)
    bell = g2.to_ell_bucketed(block=128, min_lane=8)
    key = rngu.for_repetition(rngu.root_key(13), 0)
    colors1, n1 = jax.jit(_run_luby_bucketed)(bell, key)
    seg = jax.jit(_luby_segment_bucketed)
    carry = jax.jit(_luby_init)(bell, key)
    carry = _drive(
        lambda c, b: seg(bell, c, b),
        carry,
        lambda c: (int(c[5]), bool(c[6])),
    )
    assert int(carry[1]) == int(n1)
    assert np.array_equal(np.asarray(carry[0]), np.asarray(colors1))


def test_luby_matmul_equals_gather(g):
    """The dense-adjacency Luby rounds are bit-identical to the
    gather rounds: same coin flips, same higher-degree-wins survival
    (check_conflicts_k, coloringLuby.cu:269-276) including ties."""
    from mcmc_colorer_tpu.models.luby import (
        _luby_init,
        _luby_segment,
        _luby_segment_matmul,
    )
    from mcmc_colorer_tpu.ops.dense_adj import build_dense_adjacency

    ell = g.to_ell(pad_nodes_to=128)
    adj = build_dense_adjacency(g, ell.n_pad)
    uniq = np.unique(np.asarray(g.degrees))
    rank = jnp.asarray(
        np.searchsorted(uniq, np.asarray(ell.degrees)).astype(np.int32)
    )
    key = rngu.for_repetition(rngu.root_key(17), 0)
    c1 = jax.jit(_luby_segment)(ell, _luby_init(ell, key), jnp.int32(2**30))
    c2 = jax.jit(
        lambda e, a, r, c, b: _luby_segment_matmul(
            e, a, r, c, b, n_classes=int(uniq.size)
        )
    )(ell, adj, rank, _luby_init(ell, key), jnp.int32(2**30))
    assert int(c1[1]) == int(c2[1])
    assert int(c1[5]) == int(c2[5])
    assert np.array_equal(np.asarray(c1[0]), np.asarray(c2[0]))


def test_gff_segment1_equals_oneshot(g):
    from mcmc_colorer_tpu.models.greedy_ff import (
        GreedyFFColorer,
        _gff_init,
        _gff_segment,
        _run_gff,
    )

    max_colors = g.max_degree + 1
    from mcmc_colorer_tpu.models.mcmc import choose_block_size

    block = choose_block_size(g.n, max_colors)
    ell = g.to_ell(pad_nodes_to=max(block, 128))
    colors1, rounds1 = jax.jit(
        lambda e: _run_gff(e, max_colors=max_colors, block=block)
    )(ell)
    seg = jax.jit(
        lambda e, c, b: _gff_segment(
            e, c, b, max_colors=max_colors, block=block
        )
    )
    carry = jax.jit(_gff_init)(ell)
    carry = _drive(
        lambda c, b: seg(ell, c, b),
        carry,
        lambda c: (int(c[1]), bool(c[2])),
    )
    assert int(carry[1]) == int(rounds1)
    assert np.array_equal(np.asarray(carry[0]), np.asarray(colors1))
    r = GreedyFFColorer(g).run()
    assert check_coloring(g, r.colors)
    assert r.iterations == int(rounds1)


def test_vff_segment1_equals_oneshot(g):
    from mcmc_colorer_tpu.models.vff import (
        VFFColorer,
        _run_vff,
        _vff_phase2_init,
        _vff_phase2_segment,
    )
    from mcmc_colorer_tpu.models.greedy_ff import _run_gff
    from mcmc_colorer_tpu.models.mcmc import choose_block_size

    max_colors = g.max_degree + 1
    block = choose_block_size(g.n, max_colors)
    ell = g.to_ell(pad_nodes_to=max(block, 128))
    colors1, n_used1, rounds1, loop1 = jax.jit(
        lambda e: _run_vff(e, max_colors=max_colors, block=block)
    )(ell)

    gff_colors, _ = jax.jit(
        lambda e: _run_gff(e, max_colors=max_colors, block=block)
    )(ell)
    seg = jax.jit(
        lambda e, c, b: _vff_phase2_segment(
            e, c, b, max_colors=max_colors, block=block
        )
    )
    carry = jax.jit(
        lambda e, c: _vff_phase2_init(e, c, max_colors=max_colors)
    )(ell, gff_colors)
    carry = _drive(
        lambda c, b: seg(ell, c, b),
        carry,
        lambda c: (int(c[4]), int(c[6]) == 0 or bool(c[5])),
    )
    assert int(carry[4]) == int(rounds1)
    assert bool(carry[5]) == bool(loop1)
    final = gff_colors if bool(carry[5]) else carry[0]
    assert np.array_equal(np.asarray(final), np.asarray(colors1))
    # public runner sanity
    r = VFFColorer(g).run()
    assert check_coloring(g, r.colors)


def test_ensemble_segmented_matches_individual_chains(g):
    """The vmapped segmented ensemble equals per-chain one-shot runs."""
    from mcmc_colorer_tpu.models.mcmc import _run_chain, choose_block_size
    from mcmc_colorer_tpu.parallel.chains import EnsembleMCMCColorer

    p = MCMCParams(
        n_colors=max(4, g.max_degree // 2),
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=True,
    )
    ens = EnsembleMCMCColorer(g, p, n_chains=3)
    best, summaries = ens.run(seed=21)
    assert check_coloring(g, best.colors)

    root = rngu.for_repetition(rngu.root_key(21), 0)
    block = ens.block
    ell = ens.ell
    for c in range(3):
        key = rngu.for_chain(root, jnp.uint32(c))
        colors, rip, conf, _, _ = jax.jit(
            lambda e, k: _run_chain(
                e, k, params=p, block=block
            )
        )(ell, key)
        assert summaries[c]["iterations"] == int(rip)
        assert summaries[c]["conflicts"] == int(conf)


def test_drive_segments_budget_adaptation():
    """The adaptive driver grows budgets toward the target and always
    finishes."""
    calls = []

    def seg(state, budget):
        calls.append(int(budget))
        steps, total = state
        return (min(steps + int(budget), total), total)

    final = drive_segments(
        seg,
        (0, 37),
        lambda s: (s[0], s[0] >= s[1]),
        target_s=1e9,  # no time pressure: budget grows by `grow` each call
    )
    assert final[0] == 37
    # INIT_BUDGET is 1: the first segment must stay under the execution
    # wall even when one iteration costs ~15 s (ER(1M), round 3)
    assert calls[0] == 1
    # growth is bounded by `grow`x per step
    assert all(b <= a * 8 for a, b in zip(calls, calls[1:]))
