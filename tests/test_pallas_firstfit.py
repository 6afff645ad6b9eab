"""The XLA first-fit passes (GreedyFF's tentative coloring, VFF's
tentative rebalancing) against a plain numpy oracle: per vertex, the
smallest color that no neighbor holds, optionally restricted to an allow
mask and excluding the vertex's own color.

(The test names date from a first-fit kernel that was the second
implementation compared here.)"""

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_colorer_tpu.models.greedy_ff import _first_fit_pass
from mcmc_colorer_tpu.models.vff import _tentative_rebalance


def _oracle_first_fit(neighbors, colors, n_colors, allow=None, cur=None):
    """[n_pad] smallest eligible color per row, -1 when none."""
    ext = np.concatenate([colors, [-1]])
    out = np.full(colors.shape[0], -1, np.int64)
    for v in range(colors.shape[0]):
        occ = np.zeros(n_colors, bool)
        nb = ext[neighbors[v]]
        occ[nb[(nb >= 0) & (nb < n_colors)]] = True
        elig = ~occ
        if allow is not None:
            elig &= allow
        if cur is not None and 0 <= cur[v] < n_colors:
            elig[cur[v]] = False
        if elig.any():
            out[v] = int(np.argmax(elig))
    return out


def test_first_fit_kernel_matches_xla(medium_er):
    """GreedyFF tentative coloring: every uncolored vertex takes its
    smallest free color, colored vertices keep theirs."""
    g = medium_er
    max_colors = g.max_degree + 1
    block = 128
    ell = g.to_ell(pad_nodes_to=block)
    colors = jax.random.randint(
        jax.random.key(1), (ell.n_pad,), -1, max_colors, dtype=jnp.int32
    )
    got = np.asarray(_first_fit_pass(ell, colors, max_colors, block))
    c = np.asarray(colors)
    ff = _oracle_first_fit(np.asarray(ell.neighbors), c, max_colors)
    want = np.where(c < 0, ff, c)
    assert (c < 0).sum() > 10
    np.testing.assert_array_equal(got, want)


def test_chunked_first_fit_wide_palette():
    """VFF tentative rebalancing over a 4,500-color palette: the lowest
    allowed free color other than the vertex's own, deep into the palette
    where the allow mask closes its first 64 colors."""
    from mcmc_colorer_tpu.graph.generate import erdos_renyi

    g = erdos_renyi(256, 0.15, seed=11, use_native=False)
    n_colors, block = 4500, 128
    ell = g.to_ell(pad_nodes_to=block)
    rng = np.random.default_rng(11)
    colors = rng.integers(-1, n_colors, size=(ell.n_pad,), dtype=np.int32)
    allow = rng.integers(0, 2, size=(n_colors,)).astype(bool)
    allow[:64] = False
    unb = np.ones(ell.n_pad, bool)
    got = np.asarray(
        _tentative_rebalance(
            ell,
            jnp.asarray(colors),
            jnp.asarray(unb),
            jnp.asarray(allow),
            n_colors,
            block,
        )
    )
    ff = _oracle_first_fit(
        np.asarray(ell.neighbors), colors, n_colors, allow=allow, cur=colors
    )
    want = np.where(ff >= 0, ff, colors)
    assert (ff >= 64).all()
    np.testing.assert_array_equal(got, want)
