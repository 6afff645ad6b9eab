"""Statistical equivalence: the device chain must match the sequential
reference-semantics chain on OUTCOME metrics across seeds (SURVEY §10 hard
part 4) — used colors, iterations-to-converge, balance index — since the
always-accept dynamics have no fixed stationary distribution to compare.
"""

import numpy as np
import pytest

from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu.graph.generate import erdos_renyi
from mcmc_colorer_tpu.models.base import check_coloring
from mcmc_colorer_tpu.models.mcmc import MCMCColorer
from mcmc_colorer_tpu.models.mcmc_sequential import SequentialMCMCColorer

SEEDS = [3, 17, 41, 59, 83]


@pytest.fixture(scope="module")
def er300():
    return erdos_renyi(300, 0.05, seed=123)


def _run_many(colorer_factory, seeds):
    used, iters, bi = [], [], []
    for s in seeds:
        r = colorer_factory().run(seed=s)
        used.append(r.used_colors)
        iters.append(r.iterations)
        bi.append(r.balance_index(0.05))
    return np.array(used), np.array(iters), np.array(bi)


def test_device_matches_sequential_outcomes(er300):
    p = MCMCParams(n_colors=er300.max_degree, proposal=ProposalKind.STANDARD)
    seq_used, seq_iters, seq_bi = _run_many(
        lambda: SequentialMCMCColorer(er300, p), SEEDS
    )
    par_used, par_iters, par_bi = _run_many(
        lambda: MCMCColorer(er300, p), SEEDS
    )
    # both converge within the budget on every seed
    assert (seq_iters <= p.max_iterations).all()
    assert (par_iters <= p.max_iterations).all()
    # used-color means within 15% of each other
    assert abs(seq_used.mean() - par_used.mean()) <= 0.15 * max(
        seq_used.mean(), par_used.mean()
    )
    # balance-index distributions overlap (means within 2 pooled stds)
    pooled = max(np.std(seq_bi) + np.std(par_bi), 1e-9)
    assert abs(seq_bi.mean() - par_bi.mean()) <= 2.0 * pooled + 1.0


def test_conflict_decay_is_monotonic_in_distribution(er300):
    """Conflict traces must decay: mean conflicts at iteration k+3 below
    iteration k for the early phase, across seeds."""
    p = MCMCParams(
        n_colors=max(4, er300.max_degree // 2),
        proposal=ProposalKind.BALANCE_DYNAMIC,
    )
    traces = []
    for s in SEEDS:
        r = MCMCColorer(er300, p).run(seed=s)
        t = r.conflict_trace[r.conflict_trace >= 0]
        traces.append(t)
    heads = np.array([t[0] for t in traces], dtype=float)
    tails = np.array([t[min(3, len(t) - 1)] for t in traces], dtype=float)
    assert tails.mean() < heads.mean()


def test_balance_dynamic_not_worse_than_standard(er300):
    """Non-inferiority: the shipped balance-dynamic proposal must not
    degrade the balance index vs STANDARD.  (Its bias
    p_c = (1−h_c/n)/(nCol−1) is intentionally gentle — near-uniform when
    classes are even, genDynamicDistribution _utils.cu:64-70 — so on
    fast-converging graphs the two are statistically equal.)"""
    n_col = max(4, er300.max_degree // 2)
    bis = {}
    for kind in (ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC):
        p = MCMCParams(n_colors=n_col, proposal=kind, tailcut=True)
        vals = []
        for s in SEEDS:
            r = MCMCColorer(er300, p).run(seed=s)
            assert check_coloring(er300, r.colors)
            vals.append(r.balance_index(0.05))
        bis[kind] = np.mean(vals)
    assert (
        bis[ProposalKind.BALANCE_DYNAMIC]
        <= bis[ProposalKind.STANDARD] * 1.1 + 0.1
    )


def test_hastings_preserves_validity_and_quality(er300):
    """With acceptance gating on, the chain should still converge (it can
    only reject bad moves) and keep the conflict trace non-exploding."""
    p = MCMCParams(
        n_colors=er300.max_degree,
        proposal=ProposalKind.STANDARD,
        hastings=True,
        tailcut=True,
    )
    r = MCMCColorer(er300, p).run(seed=11)
    assert check_coloring(er300, r.colors)
