import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu.models.base import check_coloring
from mcmc_colorer_tpu.models.mcmc import MCMCColorer
from mcmc_colorer_tpu.models.mcmc_active import (
    ActiveMCMCColorer,
    _cnt_of,
)


def _params(g, **kw):
    return MCMCParams(n_colors=g.max_degree, **kw)


@pytest.mark.parametrize(
    "kind", [ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC]
)
def test_active_converges_and_valid(medium_er, kind):
    p = _params(medium_er, proposal=kind, taboo_iterations=2)
    r = ActiveMCMCColorer(medium_er, p).run(seed=7)
    assert r.extra["final_conflicts"] == 0
    assert check_coloring(medium_er, r.colors)
    # conflict trace decays to zero
    assert r.conflict_trace[-1] == 0
    assert r.conflict_trace[0] >= r.conflict_trace[-1]


def test_active_cnt_invariant(small_er):
    """After a run, the incrementally-maintained counts must equal a fresh
    full recount (validates the delta bookkeeping)."""
    p = _params(small_er, taboo_iterations=1)
    colorer = ActiveMCMCColorer(small_er, p)
    r = colorer.run(seed=3)
    ell = colorer.ell
    pad = np.full(ell.n_pad, p.n_colors, np.int32)
    pad[: small_er.n] = r.colors
    cnt = np.asarray(_cnt_of(ell, jnp.asarray(pad), params=p))
    assert (cnt[: small_er.n] == 0).all()  # converged → no conflicts


def test_active_matches_full_statistically(medium_er):
    p = _params(medium_er)
    seeds = [2, 9, 27]
    full = [MCMCColorer(medium_er, p).run(seed=s) for s in seeds]
    act = [ActiveMCMCColorer(medium_er, p).run(seed=s) for s in seeds]
    fu = np.mean([r.used_colors for r in full])
    au = np.mean([r.used_colors for r in act])
    assert abs(fu - au) <= 0.15 * max(fu, au)
    assert all(r.extra["final_conflicts"] == 0 for r in act)


def test_active_with_tailcut_small_palette(medium_er):
    p = MCMCParams(
        n_colors=max(4, medium_er.max_degree // 2),
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=True,
    )
    r = ActiveMCMCColorer(medium_er, p).run(seed=13)
    assert check_coloring(medium_er, r.colors)


def test_active_rejects_hastings(small_er):
    with pytest.raises(NotImplementedError):
        ActiveMCMCColorer(small_er, _params(small_er, hastings=True))


def test_bucket_ladder_rounds_to_tile_multiples():
    """User-supplied min_bucket is rounded to 128 multiples, and the
    ladder ends at n_pad."""
    from mcmc_colorer_tpu.models.mcmc_active import _buckets, pick_cap

    caps = _buckets(4096, min_bucket=100, factor=4)
    assert all(c % 128 == 0 for c in caps)
    assert caps[-1] == 4096
    assert pick_cap(caps, 1) == caps[0]
    assert pick_cap(caps, 4000) == 4096


# ----------------- frontier x bucketed composition --------------------------


def test_active_bucketed_converges_and_valid(medium_er):
    p = _params(medium_er, proposal=ProposalKind.BALANCE_DYNAMIC,
                taboo_iterations=2)
    r = ActiveMCMCColorer(medium_er, p, layout="bucketed").run(seed=7)
    assert r.extra["final_conflicts"] == 0
    assert check_coloring(medium_er, r.colors)
    assert r.conflict_trace[-1] == 0


def test_active_bucketed_skewed_graph_with_tailcut():
    """BA graph — the composition's target workload: frontier iterations
    over per-degree-class rectangles, small palette forcing tailcut."""
    from mcmc_colorer_tpu.graph.generate import barabasi_albert

    g = barabasi_albert(3000, 8, seed=3, use_native=False)
    p = MCMCParams(
        n_colors=max(8, g.max_degree // 4),
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=True,
    )
    r = ActiveMCMCColorer(g, p, layout="bucketed").run(seed=11)
    assert r.extra["final_conflicts"] == 0
    assert check_coloring(g, r.colors)


def test_active_bucketed_matches_flat_statistically(medium_er):
    p = _params(medium_er)
    seeds = [2, 9, 27]
    flat = [ActiveMCMCColorer(medium_er, p).run(seed=s) for s in seeds]
    buck = [
        ActiveMCMCColorer(medium_er, p, layout="bucketed").run(seed=s)
        for s in seeds
    ]
    fu = np.mean([r.used_colors for r in flat])
    bu = np.mean([r.used_colors for r in buck])
    assert abs(fu - bu) <= 0.15 * max(fu, bu)
    assert all(r.extra["final_conflicts"] == 0 for r in buck)
