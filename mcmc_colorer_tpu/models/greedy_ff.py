"""Greedy First-Fit (speculative) colorer.

Re-design of the reference's Gebremedhin/Lu-style ``ColoringGreedyFF``
(coloringGreedyFF.cu): iterate { every uncolored vertex speculatively takes
its smallest non-forbidden color; conflict losers (higher id) are
uncolored } until all vertices hold a color.  One `jax.jit` with a
`lax.while_loop`; the per-vertex forbidden-color array
(nnodes×maxColors uint32, coloringGreedyFF.cu:88-128) becomes a per-block
occupancy bitmap.

Colors are 0-based (-1 = uncolored) internally; the palette bound is
maxDeg+1 (coloringGreedyFF.cu:19), which always leaves a free color.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_colorer_tpu.graph.container import EllGraph, Graph
from mcmc_colorer_tpu.models.base import Coloring
from mcmc_colorer_tpu.models.mcmc import _map_blocks, choose_block_size
from mcmc_colorer_tpu.ops.neighbor import neighbor_colors, occupancy_matrix


class GreedyFFColorer:
    def __init__(
        self,
        graph: Graph,
        block_size: int | None = None,
        active: bool = False,
        min_bucket: int = 128,
        bucket_factor: int = 4,
        ell: EllGraph | None = None,
        layout: str = "flat",
    ) -> None:
        """``active=True`` runs the frontier variant: after the first full
        pass only the conflict losers (the uncolored frontier, which decays
        geometrically) are re-gathered each round — the GFF rendition of the
        active-set MCMC design (models/mcmc_active.py; PERF.md roadmap).

        ``ell``: prebuilt device layout to reuse (must match block padding) — avoids holding a second [n_pad, d_pad] rectangle when a
        caller (VFF phase 1) already owns one.

        ``layout='bucketed'``: degree-bucketed rectangles (see
        models/mcmc.py MCMCColorer) — the speculative rounds gather
        Σ h_b·d_b ≈ 2m elements instead of n·maxDeg; required on skewed
        graphs whose flat rectangle exceeds device memory.  Composes with
        ``active=True``: frontier rows are gathered per degree-class
        slice (ops/neighbor.py:take_rows)."""
        self.graph = graph
        self.max_colors = graph.max_degree + 1
        self.block = block_size or choose_block_size(graph.n, self.max_colors)
        self.active = active
        self.layout = layout
        if layout == "bucketed":
            if block_size is None:
                self.block = min(self.block, 2048)
            # descending = Welsh-Powell order: hubs get LOW ids and win
            # the lower-id-wins conflict rule, markedly fewer used colors
            g2, perm = graph.degree_relabel(descending=True)
            self._perm = perm
            self.ell = ell if ell is not None else g2.to_ell_bucketed(
                block=128
            )
            self._pos = self.ell.real_positions()
        elif layout == "flat":
            self._perm = None
            self.ell = ell if ell is not None else graph.to_ell(
                pad_nodes_to=max(self.block, 128)
            )
        else:
            raise ValueError(f"unknown layout {layout!r}")
        self._jit_init = jax.jit(_gff_init)
        self._jit_segment = jax.jit(
            partial(
                _gff_segment,
                max_colors=self.max_colors,
                block=self.block,
            )
        )
        self._jit_rounds: dict[int, object] = {}
        self._min_bucket = min_bucket
        self._bucket_factor = bucket_factor

    def _round_fn(self, cap: int):
        if cap not in self._jit_rounds:
            self._jit_rounds[cap] = jax.jit(
                partial(_gff_active_round, max_colors=self.max_colors),
                static_argnames=("cap",),
            )
        return self._jit_rounds[cap]

    def _run_active(self):
        """Host-driven frontier loop; behaviourally identical to the
        device-resident full loop (same deterministic first-fit + lowest-id
        -wins rules), but each round gathers only |frontier|·d_pad neighbor
        colors instead of n·d_pad."""
        from mcmc_colorer_tpu.models.mcmc_active import _buckets, pick_cap

        ell = self.ell
        caps = _buckets(ell.n_pad, self._min_bucket, self._bucket_factor)
        colors = jnp.where(
            ell.node_mask, jnp.int32(-1), jnp.int32(self.max_colors)
        )
        uncolored = self.graph.n
        rounds = 0
        while uncolored > 0:
            cap = pick_cap(caps, uncolored)
            colors, n_unc = self._round_fn(cap)(ell, colors, cap=cap)
            uncolored = int(n_unc)
            rounds += 1
        return colors, rounds

    def run(self, seed: int = 0, repetition: int = 0) -> Coloring:
        from mcmc_colorer_tpu.utils.segmented import drive_segments

        t0 = time.perf_counter()
        if self.active:
            colors, rounds = self._run_active()
        else:
            # host-segmented device loop (utils/segmented.py)
            carry = drive_segments(
                lambda c, b: self._jit_segment(self.ell, c, jnp.int32(b)),
                self._jit_init(self.ell),
                lambda c: (int(c[1]), bool(c[2])),
            )
            colors, rounds = carry[0], carry[1]
        if self._perm is not None:
            padded = np.asarray(jax.device_get(colors))
            colors = np.empty(self.graph.n, np.int32)
            colors[self._perm] = padded[self._pos]
        else:
            colors = np.asarray(jax.device_get(colors))[: self.graph.n]
        dur = (time.perf_counter() - t0) * 1e3
        used = int(np.unique(colors).shape[0])
        return Coloring(
            colors=colors,
            n_colors=used,  # reference reports distinct used colors
                            # (coloringGreedyFF.cu:80-82)
            iterations=int(rounds),
            converged=True,
            duration_ms=dur,
            extra={"palette_bound": self.max_colors},
        )


def _first_fit_pass(
    ell,
    colors: jnp.ndarray,
    max_colors: int,
    block: int,
) -> jnp.ndarray:
    """tentative_coloring: smallest color not used by any neighbor
    (coloringGreedyFF.cu:88-128), for currently uncolored vertices."""
    from mcmc_colorer_tpu.models.mcmc import _is_bucketed, _slice_vec

    if _is_bucketed(ell):
        outs = []
        for s in ell.slices:
            h = s.h_pad
            nc = neighbor_colors(s.neighbors, colors)
            cur_s = _slice_vec(colors, s.start, h)
            # a vertex's smallest free color is <= its degree <= the
            # slice width, so each slice only needs a d_b+1 palette —
            # this keeps the [block, palette] temporaries bounded even
            # when maxDeg (hence max_colors) is huge
            pal = min(max_colors, s.d_pad + 1)
            blk = block if h % block == 0 else 128

            def block_fn(xs, pal=pal):
                (nc_blk,) = xs
                occ = occupancy_matrix(nc_blk, pal)
                return jnp.argmax(~occ, axis=1).astype(jnp.int32)

            ff = _map_blocks(block_fn, h // blk, blk, nc).reshape(h)
            outs.append(jnp.where(cur_s < 0, ff, cur_s))
        return jnp.concatenate(outs)
    n_pad = ell.n_pad
    n_blocks = n_pad // block

    def block_fn(xs):
        neigh_blk, cur_blk = xs
        nc = neighbor_colors(neigh_blk, colors)
        occ = occupancy_matrix(nc, max_colors)
        first_free = jnp.argmax(~occ, axis=1).astype(jnp.int32)
        return jnp.where(cur_blk < 0, first_free, cur_blk)

    out = _map_blocks(block_fn, n_blocks, block, ell.neighbors, colors)
    return out.reshape(n_pad)


def _conflict_losers(ell, colors: jnp.ndarray) -> jnp.ndarray:
    """conflict_detection: same color as a lower-id neighbor → lose
    (coloringGreedyFF.cu:134-162)."""
    from mcmc_colorer_tpu.models.mcmc import _is_bucketed, _slice_vec

    colors_ext = jnp.concatenate([colors, jnp.full((1,), -2, jnp.int32)])
    if _is_bucketed(ell):
        parts = []
        for s in ell.slices:
            nc = jnp.take(colors_ext, s.neighbors, axis=0)
            own = _slice_vec(colors, s.start, s.h_pad)
            gids = s.start + jnp.arange(s.h_pad, dtype=jnp.int32)
            parts.append(
                jnp.any(
                    (nc == own[:, None])
                    & (own[:, None] >= 0)
                    & (s.neighbors < gids[:, None]),
                    axis=1,
                )
            )
        return jnp.concatenate(parts)
    nc = jnp.take(colors_ext, ell.neighbors, axis=0)
    self_ids = jnp.arange(ell.n_pad, dtype=jnp.int32)[:, None]
    return jnp.any(
        (nc == colors[:, None])
        & (colors[:, None] >= 0)
        & (ell.neighbors < self_ids),
        axis=1,
    )


def _gff_active_round(
    ell: EllGraph,
    colors: jnp.ndarray,
    *,
    cap: int,
    max_colors: int,
):
    """One frontier-sized speculative round.

    Gathers the ELL rows of the ≤``cap`` uncolored vertices, first-fits
    them (tentative_coloring, coloringGreedyFF.cu:88-128), then detects
    conflicts *within the frontier only* — a previously-colored neighbor's
    color was occupied at first-fit time, so any same-color adjacency must
    pair two frontier vertices; the higher id loses
    (conflict_detection, coloringGreedyFF.cu:134-162).
    Returns (colors', #losers).
    """
    n_pad = ell.n_pad
    uncolored = (colors < 0) & ell.node_mask
    (ids,) = jnp.nonzero(uncolored, size=cap, fill_value=n_pad)
    valid = ids < n_pad
    from mcmc_colorer_tpu.ops.neighbor import take_rows

    rows = take_rows(ell, ids, valid)
    nc = neighbor_colors(rows, colors)
    # a vertex's first-fit color is <= its degree <= the gathered row
    # width, so the palette truncates to d_out+1 — keeps the
    # [cap, palette] occupancy bounded on skewed graphs
    pal = min(max_colors, rows.shape[1] + 1)
    occ = occupancy_matrix(nc, pal)
    first_free = jnp.argmax(~occ, axis=1).astype(jnp.int32)
    tentative = jnp.where(valid, first_free, jnp.int32(max_colors))
    colors_t = colors.at[ids].set(tentative, mode="drop")
    nc_new = neighbor_colors(rows, colors_t)
    losers = valid & jnp.any(
        (nc_new == tentative[:, None]) & (rows < ids[:, None]), axis=1
    )
    final = jnp.where(losers, jnp.int32(-1), tentative)
    colors_next = colors.at[ids].set(final, mode="drop")
    return colors_next, jnp.sum(losers.astype(jnp.int32))


def _gff_init(ell: EllGraph):
    """Initial carry of the speculative loop: (colors, rounds, done)."""
    real = ell.node_mask
    colors0 = jnp.where(real, jnp.int32(-1), jnp.int32(0))
    return colors0, jnp.int32(0), ~jnp.any(real)


def _gff_segment(
    ell: EllGraph,
    carry,
    budget,
    *,
    max_colors: int,
    block: int,
):
    """At most ``budget`` speculative rounds (traced budget — see
    utils/segmented.py).  Bit-equal to the monolithic loop."""
    real = ell.node_mask
    limit = carry[1] + budget

    def cond(carry):
        _, rounds, done = carry
        return (~done) & (rounds < limit)

    def body(carry):
        colors, rounds, _done = carry
        tentative = _first_fit_pass(ell, colors, max_colors, block)
        losers = _conflict_losers(ell, tentative)
        colors = jnp.where(losers, jnp.int32(-1), tentative)
        return colors, rounds + 1, ~jnp.any((colors < 0) & real)

    return jax.lax.while_loop(cond, body, carry)


def _run_gff(ell: EllGraph, *, max_colors: int, block: int):
    """One-shot loop (tests; the colorer drives `_gff_segment` from the host)."""
    carry = _gff_segment(
        ell,
        _gff_init(ell),
        jnp.int32(2**30),
        max_colors=max_colors,
        block=block,
    )
    return carry[0], carry[1]
