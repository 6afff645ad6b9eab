"""Vertex-centric First-Fit rebalancing colorer (VFF).

Re-design of the reference's ``ColoringVFF`` (coloringVFF.cu): phase 1 runs
the Greedy-FF loop, phase 2 moves vertices out of oversized color classes
(γ = n/numColors) into the lowest permissible *undersized* class, re-solving
conflicts, with a 10-round history of the unbalanced set as livelock
detector; on livelock the Greedy-FF coloring is restored
(coloringVFF.cu:128-256, 447-466).

Deliberate deviation (SURVEY §9.6): the reference's tentative_rebalancing
predicate moves nodes into classes with ``gamma < BIN_SIZE`` — *oversized*
targets, contradicting its own comment.  We implement the intended
undersized-bin rule (``BIN_SIZE < gamma``) and keep the livelock fallback.

Both phases live in one `jax.jit`; the reference's two concurrent CUDA
streams (bin counting ∥ conflict solving, coloringVFF.cu:156-203) need no
explicit construct — XLA schedules the independent ops concurrently
(SURVEY §2.3 item 5).
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_colorer_tpu.graph.container import EllGraph, Graph
from mcmc_colorer_tpu.models.base import Coloring
from mcmc_colorer_tpu.models.greedy_ff import _run_gff
from mcmc_colorer_tpu.models.mcmc import _map_blocks, choose_block_size
from mcmc_colorer_tpu.ops.neighbor import (
    color_histogram,
    neighbor_colors,
    occupancy_matrix,
)

_UNBALANCED_HISTORY = 10  # coloringVFF.cu:17


class VFFColorer:
    def __init__(
        self,
        graph: Graph,
        block_size: int | None = None,
        active: bool = False,
        min_bucket: int = 128,
        bucket_factor: int = 4,
        layout: str = "flat",
    ) -> None:
        """``active=True`` runs the frontier variant: phase 1 is the active
        GreedyFF loop and each phase-2 round gathers only the *unbalanced*
        vertices' rows (the set the reference's detect_unbalanced flags,
        which shrinks every round) instead of all n — the VFF rendition of
        the active-set design (models/mcmc_active.py).

        ``layout='bucketed'``: degree-bucketed rectangles (see
        models/mcmc.py) — both phases gather Σ h_b·d_b ≈ 2m elements per
        round instead of n·maxDeg.  Composes with ``active=True``
        (frontier rows gathered per slice, ops/neighbor.py:take_rows)."""
        self.graph = graph
        self.max_colors = graph.max_degree + 1
        self.block = block_size or choose_block_size(graph.n, self.max_colors)
        self.active = active
        self.layout = layout
        if layout == "bucketed":
            if block_size is None:
                self.block = min(self.block, 2048)
            g2, perm = graph.degree_relabel(descending=True)
            self._perm = perm
            self.ell = g2.to_ell_bucketed(block=128)
            self._pos = self.ell.real_positions()
        elif layout == "flat":
            self._perm = None
            self.ell = graph.to_ell(pad_nodes_to=max(self.block, 128))
        else:
            raise ValueError(f"unknown layout {layout!r}")
        from mcmc_colorer_tpu.models.greedy_ff import _gff_init, _gff_segment

        self._jit_gff_init = jax.jit(_gff_init)
        self._jit_gff_segment = jax.jit(
            partial(
                _gff_segment,
                max_colors=self.max_colors,
                block=self.block,
            )
        )
        self._jit_p2_init = jax.jit(
            partial(_vff_phase2_init, max_colors=self.max_colors)
        )
        self._jit_p2_segment = jax.jit(
            partial(
                _vff_phase2_segment,
                max_colors=self.max_colors,
                block=self.block,
            )
        )
        self._jit_rounds: dict[int, object] = {}
        self._min_bucket = min_bucket
        self._bucket_factor = bucket_factor
        self._gff = None  # phase-1 colorer, built once (keeps jit caches)

    def _round_fn(self, cap: int):
        if cap not in self._jit_rounds:
            self._jit_rounds[cap] = jax.jit(
                partial(_vff_active_round, max_colors=self.max_colors),
                static_argnames=("cap", "n_used", "gamma"),
            )
        return self._jit_rounds[cap]

    def _run_active(self):
        from mcmc_colorer_tpu.models.greedy_ff import GreedyFFColorer
        from mcmc_colorer_tpu.models.mcmc_active import _buckets, pick_cap

        ell = self.ell
        # phase 1: frontier GreedyFF on the same ELL configuration
        if self._gff is None:
            self._gff = GreedyFFColorer(
                self.graph,
                block_size=self.block,
                active=True,
                min_bucket=self._min_bucket,
                bucket_factor=self._bucket_factor,
                ell=self.ell,  # reuse — don't hold a second rectangle
                layout=self.layout,
            )
        gff_colors, _ = self._gff._run_active()
        n_used = int(
            jnp.max(jnp.where(ell.node_mask, gff_colors, -1))
        ) + 1
        gamma = self.graph.n // max(n_used, 1)

        bins, unb = _vff_detect(
            ell, gff_colors, self.max_colors, gamma
        )
        n_unb = int(jnp.sum(unb.astype(jnp.int32)))
        history = jnp.zeros((_UNBALANCED_HISTORY, ell.n_pad), jnp.bool_)
        caps = _buckets(ell.n_pad, self._min_bucket, self._bucket_factor)
        colors = gff_colors
        rounds = 0
        looping = False
        while n_unb > 0 and not looping:
            cap = pick_cap(caps, n_unb)
            colors, bins, unb, history, looping_d = self._round_fn(cap)(
                ell,
                colors,
                bins,
                unb,
                history,
                jnp.int32(rounds),
                cap=cap,
                n_used=n_used,
                gamma=gamma,
            )
            rounds += 1
            n_unb = int(jnp.sum(unb.astype(jnp.int32)))
            looping = bool(looping_d)
        if looping:
            colors = gff_colors  # livelock fallback (coloringVFF.cu:232-234)
        return colors, n_used, rounds, looping

    def run(self, seed: int = 0, repetition: int = 0) -> Coloring:
        from mcmc_colorer_tpu.utils.segmented import drive_segments

        t0 = time.perf_counter()
        if self.active:
            colors, n_used, rounds, fell_back = self._run_active()
        else:
            # both phases host-segmented (utils/segmented.py)
            gff = drive_segments(
                lambda c, b: self._jit_gff_segment(
                    self.ell, c, jnp.int32(b)
                ),
                self._jit_gff_init(self.ell),
                lambda c: (int(c[1]), bool(c[2])),
            )
            gff_colors = gff[0]
            p2 = drive_segments(
                lambda c, b: self._jit_p2_segment(
                    self.ell, c, jnp.int32(b)
                ),
                self._jit_p2_init(self.ell, gff_colors),
                lambda c: (
                    int(c[4]),
                    int(c[6]) == 0 or bool(c[5]),
                ),
            )
            fell_back = bool(p2[5])
            # livelock → revert to plain GFF (coloringVFF.cu:232-234)
            colors = gff_colors if fell_back else p2[0]
            n_used, rounds = p2[7], p2[4]
        if self._perm is not None:
            padded = np.asarray(jax.device_get(colors))
            colors = np.empty(self.graph.n, np.int32)
            colors[self._perm] = padded[self._pos]
        else:
            colors = np.asarray(jax.device_get(colors))[: self.graph.n]
        dur = (time.perf_counter() - t0) * 1e3
        return Coloring(
            colors=colors,
            n_colors=int(n_used),
            iterations=int(rounds),
            converged=True,
            duration_ms=dur,
            extra={"livelock_fallback": bool(fell_back)},
        )


@partial(jax.jit, static_argnames=("max_colors", "gamma"))
def _vff_detect(ell: EllGraph, colors, max_colors: int, gamma: int):
    """(bins, unbalanced mask): node flagged iff its class is oversized
    (detect_unbalanced_nodes, coloringVFF.cu:323-334)."""
    bins = color_histogram(colors, max_colors, ell.node_mask)
    sz = jnp.take(bins, jnp.clip(colors, 0, max_colors - 1))
    return bins, ell.node_mask & (jnp.int32(gamma) < sz)


def _vff_active_round(
    ell: EllGraph,
    colors,
    bins,
    unb,
    history,
    rounds,
    *,
    cap: int,
    max_colors: int,
    n_used: int,
    gamma: int,
):
    """One frontier-sized rebalancing round over the ≤``cap`` unbalanced
    vertices: move to the lowest free *undersized* class
    (tentative_rebalancing with the intended bin rule, SURVEY §9.6), flag
    the movers that now conflict with a lower-id mover (solve_conflicts,
    coloringVFF.cu:411-437), maintain bins incrementally, and advance the
    10-deep livelock history ring."""
    n_pad = ell.n_pad
    allow = (bins < jnp.int32(gamma)) & (
        jnp.arange(max_colors, dtype=jnp.int32) < jnp.int32(n_used)
    )
    (ids,) = jnp.nonzero(unb, size=cap, fill_value=n_pad)
    valid = ids < n_pad
    ids_c = jnp.minimum(ids, n_pad - 1)
    from mcmc_colorer_tpu.ops.neighbor import take_rows

    rows = take_rows(ell, ids, valid)
    cur = jnp.where(
        valid, jnp.take(colors, ids_c), jnp.int32(max_colors)
    )
    nc = neighbor_colors(rows, colors)
    occ = occupancy_matrix(nc, max_colors)
    # own color forbidden (coloringVFF.cu:371-372)
    occ = occ.at[jnp.arange(cap), jnp.clip(cur, 0, max_colors - 1)].set(True)
    eligible = (~occ) & allow[None, :]
    k = jnp.argmax(eligible, axis=1).astype(jnp.int32)
    cand = jnp.where(jnp.any(eligible, axis=1), k, jnp.int32(-1))
    moved = valid & (cand >= 0)
    new_col = jnp.where(moved, cand, cur)
    colors_next = colors.at[ids].set(new_col, mode="drop")
    # conflicts can only pair two movers (a stationary neighbor's color was
    # forbidden at choice time); stay flagged iff a lower-id neighbor now
    # shares the color
    nc_new = neighbor_colors(rows, colors_next)
    conflicted = jnp.any(
        (nc_new == new_col[:, None]) & (rows < ids[:, None]), axis=1
    )
    unb_f = valid & conflicted
    unb_next = (
        jnp.zeros((n_pad,), jnp.bool_).at[ids].set(unb_f, mode="drop")
    )
    # incremental bins: -1 from the source class, +1 to the target
    src = jnp.where(moved, cur, jnp.int32(max_colors))
    dst = jnp.where(moved, new_col, jnp.int32(max_colors))
    bins_next = (
        bins.at[src].add(-1, mode="drop").at[dst].add(1, mode="drop")
    )
    history = jnp.roll(history, 1, axis=0).at[0].set(unb_next)
    filled = rounds + 1 >= _UNBALANCED_HISTORY
    looping = filled & jnp.all(history == history[0:1])
    return colors_next, bins_next, unb_next, history, looping




def _tentative_rebalance(
    ell, colors, unb, allow, max_colors: int, block: int
):
    """tentative_rebalancing: every unbalanced vertex moves to its lowest
    free allowed class, own color forbidden (coloringVFF.cu:352-388, with
    the intended undersized-bin rule).  Dispatches per degree-class slice
    on the bucketed layout."""
    from mcmc_colorer_tpu.models.mcmc import _is_bucketed, _slice_vec

    if _is_bucketed(ell):
        parts = []
        for s in ell.slices:
            h = s.h_pad
            cur_s = _slice_vec(colors, s.start, h)
            unb_s = _slice_vec(unb, s.start, h)
            blk = block if h % block == 0 else 128

            def block_fn(xs):
                neigh_blk, cur_blk, unb_blk = xs
                nc_blk = neighbor_colors(neigh_blk, colors)
                occ = occupancy_matrix(nc_blk, max_colors)
                occ = occ.at[
                    jnp.arange(cur_blk.shape[0]),
                    jnp.clip(cur_blk, 0, max_colors - 1),
                ].set(True)
                eligible = (~occ) & allow[None, :]
                k = jnp.argmax(eligible, axis=1).astype(jnp.int32)
                found = jnp.any(eligible, axis=1)
                return jnp.where(unb_blk & found, k, cur_blk)

            out = _map_blocks(
                block_fn, h // blk, blk, s.neighbors, cur_s, unb_s
            )
            parts.append(out.reshape(h))
        return jnp.concatenate(parts)
    n_pad = ell.n_pad

    def block_fn(xs):
        neigh_blk, cur_blk, unb_blk = xs
        nc = neighbor_colors(neigh_blk, colors)
        occ = occupancy_matrix(nc, max_colors)
        occ = occ.at[
            jnp.arange(cur_blk.shape[0]),
            jnp.clip(cur_blk, 0, max_colors - 1),
        ].set(True)
        eligible = (~occ) & allow[None, :]
        k = jnp.argmax(eligible, axis=1).astype(jnp.int32)
        found = jnp.any(eligible, axis=1)
        return jnp.where(unb_blk & found, k, cur_blk)

    cand_b = _map_blocks(
        block_fn, n_pad // block, block, ell.neighbors, colors, unb
    )
    return cand_b.reshape(n_pad)


def _lower_id_conflicted(ell, colors):
    """Per vertex: shares its color with a lower-id neighbor."""
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
                    (nc == own[:, None]) & (s.neighbors < gids[:, None]),
                    axis=1,
                )
            )
        return jnp.concatenate(parts)
    node_ids = jnp.arange(ell.n_pad, dtype=jnp.int32)
    nc = jnp.take(colors_ext, ell.neighbors, axis=0)
    return jnp.any(
        (nc == colors[:, None]) & (ell.neighbors < node_ids[:, None]),
        axis=1,
    )


def _vff_phase2_init(ell: EllGraph, gff_colors, *, max_colors: int):
    """Initial carry of the rebalancing loop: (colors, bins, unbalanced,
    history, rounds, looping, n_unbalanced, n_used, gamma)."""
    real = ell.node_mask
    # numColors = distinct used colors; since FF colors are dense from 0,
    # that is max(color)+1 over real vertices
    n_used = jnp.max(jnp.where(real, gff_colors, -1)) + 1
    gamma = jnp.int32(ell.n_nodes) // jnp.maximum(n_used, 1)  # γ = n/numCol
    bins0 = color_histogram(gff_colors, max_colors, real)
    # node flagged iff its class is oversized (γ < binSize,
    # detect_unbalanced_nodes, coloringVFF.cu:323-334)
    sz = jnp.take(bins0, jnp.clip(gff_colors, 0, max_colors - 1))
    unb0 = real & (gamma < sz)
    hist0 = jnp.zeros((_UNBALANCED_HISTORY, ell.n_pad), jnp.bool_)
    return (
        gff_colors,
        bins0,
        unb0,
        hist0,
        jnp.int32(0),
        jnp.bool_(False),
        jnp.sum(unb0.astype(jnp.int32)),
        n_used,
        gamma,
    )


def _vff_phase2_segment(
    ell: EllGraph,
    carry,
    budget,
    *,
    max_colors: int,
    block: int,
):
    """At most ``budget`` rebalancing rounds (traced budget — see
    utils/segmented.py).  Bit-equal to the monolithic loop."""
    real = ell.node_mask
    limit = carry[4] + budget

    def cond(carry):
        _, _, _, _, rounds, looping, n_unb, _, _ = carry
        return (n_unb > 0) & ~looping & (rounds < limit)

    def body(carry):
        (
            colors,
            bins,
            unb,
            history,
            rounds,
            looping,
            _n_unb,
            n_used,
            gamma,
        ) = carry
        # permissible targets: undersized bins within the used palette
        # (the reference scans i = 1..numColors only, coloringVFF.cu:381)
        allow = (bins < gamma) & (
            jnp.arange(max_colors, dtype=jnp.int32) < n_used
        )

        new_colors = _tentative_rebalance(
            ell, colors, unb, allow, max_colors, block
        )
        # solve_conflicts: an unbalanced node stays flagged iff it now
        # conflicts with a lower-id neighbor (coloringVFF.cu:411-437)
        conflicted = _lower_id_conflicted(ell, new_colors)
        new_bins = color_histogram(new_colors, max_colors, real)
        new_unb = unb & conflicted
        # 10-deep history ring; all-equal → livelock (coloringVFF.cu:447-466)
        history = jnp.roll(history, 1, axis=0).at[0].set(new_unb)
        filled = rounds + 1 >= _UNBALANCED_HISTORY
        all_equal = jnp.all(history == history[0:1])
        return (
            new_colors,
            new_bins,
            new_unb,
            history,
            rounds + 1,
            looping | (filled & all_equal),
            jnp.sum(new_unb.astype(jnp.int32)),
            n_used,
            gamma,
        )

    return jax.lax.while_loop(cond, body, carry)


def _run_vff(ell: EllGraph, *, max_colors: int, block: int):
    """One-shot both-phases loop (tests; the colorer drives the
    phase segments from the host)."""
    # ---- phase 1: Greedy FF (coloringVFF.cu:90-125 reuses the GFF loop)
    gff_colors, _ = _run_gff(
        ell, max_colors=max_colors, block=block
    )
    carry = _vff_phase2_init(ell, gff_colors, max_colors=max_colors)
    carry = _vff_phase2_segment(
        ell,
        carry,
        jnp.int32(2**30),
        max_colors=max_colors,
        block=block,
    )
    colors, _, _, _, rounds, looping, _, n_used, _ = carry
    # livelock → revert to plain GFF (coloringVFF.cu:232-234)
    final = jnp.where(looping, gff_colors, colors)
    return final, n_used, rounds, looping
