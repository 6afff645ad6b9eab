"""The XLA proposal sweep (``models/mcmc._sweep``) against a plain numpy
oracle of the reference's parallel resampling step: same formulas, same
uniforms, same inverse-CDF walk.  The oracle works in float64; the XLA
sweep in float32 may pick the neighbouring color only where the uniform
lies within float32 rounding of a CDF boundary.

(The test names date from a fused resampling kernel that was the second
implementation compared here.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu.models.mcmc import (
    _needs_histogram,
    _sweep,
    _variant_distribution,
)
from mcmc_colorer_tpu.ops.neighbor import color_histogram

# float32 CDF sums of ~1e3 terms round at ~1e-6 absolute; a uniform this
# close to a boundary may fall on either side of it
_CDF_TOL = 2e-6


def _oracle_p_eff(params, colors, real):
    """The per-iteration distribution p_eff[c] of each proposal family
    (coloringMCMC_utils.cu:5-21,64-70; orderedIndex permutation of
    coloringMCMC_main.cu:192-198), in float64."""
    n_col, lam = params.n_colors, params.lambda_
    idx = np.arange(n_col, dtype=np.float64)
    hist = np.bincount(colors[real], minlength=n_col)[:n_col]
    kind = params.proposal
    if kind == ProposalKind.STANDARD:
        return None
    if kind == ProposalKind.BALANCE_DYNAMIC:
        return (1.0 - hist / real.sum()) / max(n_col - 1, 1)
    if kind in (ProposalKind.DECREASE_LINE, ProposalKind.BALANCE_LINE):
        base = (n_col - lam * idx) / np.sum(n_col - lam * idx)
    else:
        base = np.exp(-lam * idx) / np.sum(np.exp(-lam * idx))
    if kind in (ProposalKind.BALANCE_LINE, ProposalKind.BALANCE_EXP):
        return base[np.argsort(hist, kind="stable")]
    return base


def _oracle_sweep(params, neighbors, colors, taboo, unif, real):
    """One synchronous proposal sweep, vertex by vertex.  Returns
    (chosen, new_taboo, ambiguous): ``ambiguous`` marks vertices whose
    uniform lies within _CDF_TOL of a CDF boundary."""
    n_col, eps = params.n_colors, params.epsilon
    p_eff = _oracle_p_eff(params, colors, real)
    n_pad = colors.shape[0]
    ext = np.concatenate([colors, [-1]])
    chosen = colors.copy()
    new_taboo = np.zeros_like(taboo)
    ambiguous = np.zeros(n_pad, bool)
    for v in np.nonzero(real)[0]:
        nb = ext[neighbors[v]]
        occ = np.zeros(n_col, bool)
        occ[nb[(nb >= 0) & (nb < n_col)]] = True
        cur = colors[v]
        zn = int(occ.sum())
        zp = n_col - zn
        keep = np.full(n_col, eps)
        keep[cur] = 1.0 - (n_col - 1) * eps
        if zp == 0:
            q = np.zeros(n_col)
            q[cur] = 1.0
        elif occ[cur]:
            kind = params.proposal
            if kind == ProposalKind.STANDARD:
                q = np.where(occ, eps, (1.0 - eps * zn) / zp)
            else:
                reminder = np.sum(p_eff[occ] - eps)
                if kind in (
                    ProposalKind.DECREASE_LINE,
                    ProposalKind.DECREASE_EXP,
                ):
                    lam = params.lambda_
                    j = np.cumsum(~occ) - 1.0
                    if lam == 0.0:
                        w = np.ones(n_col) / zp
                    else:
                        denom = (1 - np.exp(-lam * zp)) / (1 - np.exp(-lam))
                        w = np.exp(-lam * j) / denom
                    q = np.where(occ, eps, p_eff + reminder * w)
                else:
                    q = np.where(occ, eps, p_eff + reminder / zp)
        else:
            q = keep
        cdf = np.cumsum(q)
        c = min(int(np.sum(cdf < unif[v])), n_col - 1)
        ambiguous[v] = bool(np.any(np.abs(cdf - unif[v]) < _CDF_TOL))
        if taboo[v] > 0:
            chosen[v] = cur
            new_taboo[v] = taboo[v] - 1
        else:
            chosen[v] = c
            new_taboo[v] = params.taboo_iterations if c == cur else 0
    return chosen, new_taboo, ambiguous


def _compare_sweep(g, params, seed, init_colors=None):
    block = 128
    ell = g.to_ell(pad_nodes_to=block)
    n_pad = ell.n_pad
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    colors = jnp.where(
        ell.node_mask,
        jax.random.randint(
            k1, (n_pad,), 0, init_colors or params.n_colors, jnp.int32
        ),
        jnp.int32(params.n_colors),
    )
    taboo = jax.random.randint(k2, (n_pad,), 0, 2, jnp.int32)
    unif = jax.random.uniform(k3, (n_pad,), dtype=jnp.float32)
    hist = (
        color_histogram(colors, params.n_colors, ell.node_mask)
        if _needs_histogram(params)
        else None
    )
    p_eff = _variant_distribution(params, hist, ell.n_nodes)
    star_x, taboo_x, _ = _sweep(
        ell, params, block, colors, taboo, unif, p_eff
    )
    real = np.asarray(ell.node_mask)
    want, want_taboo, ambiguous = _oracle_sweep(
        params,
        np.asarray(ell.neighbors),
        np.asarray(colors),
        np.asarray(taboo),
        np.asarray(unif, dtype=np.float64),
        real,
    )
    check = real & ~ambiguous
    assert check.sum() > 0.9 * real.sum()
    np.testing.assert_array_equal(np.asarray(star_x)[check], want[check])
    np.testing.assert_array_equal(
        np.asarray(taboo_x)[check], want_taboo[check]
    )
    # some vertices actually moved: the comparison is not vacuous
    assert (want[real] != np.asarray(colors)[real]).any()


@pytest.mark.parametrize(
    "kind",
    [
        ProposalKind.STANDARD,
        ProposalKind.BALANCE_DYNAMIC,
        ProposalKind.DECREASE_EXP,
        ProposalKind.BALANCE_LINE,
    ],
)
@pytest.mark.parametrize("taboo_iters", [0, 3])
def test_pallas_matches_xla_sweep(medium_er, kind, taboo_iters):
    params = MCMCParams(
        n_colors=medium_er.max_degree,
        proposal=kind,
        taboo_iterations=taboo_iters,
        epsilon=1e-4,
    )
    _compare_sweep(medium_er, params, seed=5)


@pytest.mark.parametrize(
    "kind",
    [
        ProposalKind.STANDARD,
        ProposalKind.BALANCE_DYNAMIC,
        ProposalKind.DECREASE_EXP,
    ],
)
def test_chunked_kernel_wide_palette_matches_xla(kind):
    """A palette of 4,500 colors, far above the degree, from a start that
    uses only its first 16 colors: violating vertices draw from a CDF over
    the whole wide palette."""
    from mcmc_colorer_tpu.graph.generate import erdos_renyi

    g = erdos_renyi(512, 0.05, seed=3, use_native=False)
    params = MCMCParams(
        n_colors=4500,
        proposal=kind,
        taboo_iterations=2,
        epsilon=1e-6,
    )
    _compare_sweep(g, params, seed=7, init_colors=16)
