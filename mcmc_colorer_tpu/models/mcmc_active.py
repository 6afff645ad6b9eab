"""Active-set MCMC balanced colorer — time-to-solution optimized.

The chain's per-iteration cost is dominated by the neighbor-color gather.
But with the reference's ε = 1e-8,
non-violating vertices keep their color with probability
1−(nCol−1)ε ≈ 1: only *violating* vertices meaningfully resample, and the
violating set decays geometrically.  This colorer exploits that exactly:

* the sweep resamples only the active set (violating ∧ taboo-free),
  gathering |A|·d neighbor colors instead of n·d;
* non-violating vertices' dynamics are applied analytically: taboo
  counters decrement/reset vectorized, and the rare ε-flip (a
  non-violating vertex drawing a different color, probability
  (nCol−1)·ε each) is sampled sparsely — at most one flip per sweep,
  an O((m·(nCol−1)ε)²) ≈ 1e-10 approximation at reference ε;
* per-vertex conflict counts are maintained incrementally from the
  changed vertices' edges (scatter of |changed|·d deltas), so the
  violating set is always known without a full gather.

The loop is host-driven (like `SteppedMCMC`) with the active capacity
bucketed in powers of two: each bucket compiles once; iterations then
dispatch at the size of the actual conflict frontier.  Large frontiers
(> n/8) run as full sweeps.

Distributionally equivalent to `MCMCColorer` (same proposal formulas,
same synchronous update) up to the ε-flip approximation above.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_colorer_tpu.config import MCMCParams
from mcmc_colorer_tpu.graph.container import EllGraph, Graph
from mcmc_colorer_tpu.models.base import Coloring
from mcmc_colorer_tpu.models.mcmc import (
    _conflict_edges_any,
    _is_bucketed,
    _needs_histogram,
    _slice_vec,
    _sweep_any,
    _variant_distribution,
    choose_block_size,
)
from mcmc_colorer_tpu.ops.neighbor import (
    color_histogram,
    neighbor_colors,
    take_rows,
)
from mcmc_colorer_tpu.utils import rng as rngu


def _buckets(n_pad: int, min_bucket: int = 128, factor: int = 4) -> list[int]:
    """Frontier-capacity ladder; caps are multiples of 128."""
    out = []
    b = max(128, ((min_bucket + 127) // 128) * 128)
    factor = max(2, factor)
    while b < n_pad:
        out.append(b)
        b *= factor
    out.append(n_pad)
    return out


def pick_cap(caps: list[int], count: int) -> int:
    """Smallest ladder capacity holding ``count`` frontier vertices."""
    return next(c for c in caps if c >= max(count, 1))


class ActiveMCMCColorer:
    def __init__(
        self,
        graph: Graph,
        params: MCMCParams,
        min_bucket: int = 128,
        bucket_factor: int = 4,
        layout: str = "flat",
    ) -> None:
        """``min_bucket``/``bucket_factor`` control the active-capacity
        ladder; each rung compiles its own program.

        ``layout='bucketed'``: degree-bucketed rectangles (see
        models/mcmc.py MCMCColorer) — full-mode sweeps gather
        Σ h_b·d_b ≈ 2m elements and frontier rows are gathered per
        degree-class slice (ops/neighbor.py:take_rows), so the active-set
        design composes with the layout required on skewed graphs at
        scale (PERF.md round-2 roadmap item 2)."""
        if params.hastings:
            # Design note (SURVEY §9.2 / coloringMCMC_standard.cu:88-135):
            # the Hastings ratio needs Σ log q over EVERY vertex of both
            # the forward and reverse proposals.  The frontier sweep never
            # materialises q for the passive set — its keep-dynamics are
            # approximated by at most one ε-flip per sweep — so the exact
            # ratio is undefined here.  MCMCColorer (full sweeps) and
            # ShardedMCMCColorer with active_cap=None carry exact per-
            # vertex qStar and support acceptance.
            raise NotImplementedError(
                "active-set mode implements the shipped always-accept "
                "dynamics; use MCMCColorer or ShardedMCMCColorer "
                "(active_cap=None) for Hastings"
            )
        self.graph = graph
        self.params = params
        self.block = choose_block_size(graph.n, params.n_colors)
        self.layout = layout
        if layout == "bucketed":
            self.block = min(self.block, 2048)
            g2, perm = graph.degree_relabel()
            self._perm = perm
            self.ell = g2.to_ell_bucketed(block=128)
            self._pos = self.ell.real_positions()
        elif layout == "flat":
            self._perm = None
            self.ell = graph.to_ell(pad_nodes_to=max(self.block, 128))
        else:
            raise ValueError(f"unknown layout {layout!r}")
        self._jit_cnt = jax.jit(partial(_cnt_of, params=params))
        self._jit_full = jax.jit(
            partial(_full_iteration, params=params, block=self.block)
        )
        self._jit_active = {}
        self._jit_tailcut = {}
        self._min_bucket = min_bucket
        self._bucket_factor = bucket_factor

    def _active_fn(self, cap: int):
        if cap not in self._jit_active:
            self._jit_active[cap] = jax.jit(
                partial(_active_iteration, params=self.params),
                static_argnames=("cap",),
            )
        return self._jit_active[cap]

    def _tailcut_fn(self, cap: int):
        if cap not in self._jit_tailcut:
            self._jit_tailcut[cap] = jax.jit(
                partial(_tailcut_round, params=self.params),
                static_argnames=("cap",),
            )
        return self._jit_tailcut[cap]

    def _tailcut_active(self, colors, cnt, key):
        """Frontier-sized tailcut: each round touches only the conflicting
        vertices (intended semantics of the reference epilogue,
        coloringMCMC_utils.cu:73-101, at incremental cost)."""
        ell, params = self.ell, self.params
        caps = _buckets(
            ell.n_pad, self._min_bucket, self._bucket_factor
        )
        hist = color_histogram(colors, params.n_colors, ell.node_mask)
        ordered = jnp.argsort(hist).astype(jnp.int32)
        rounds = 0
        max_rounds = self.graph.n + 1000
        while rounds < max_rounds:
            n_flag, conflicts = map(
                int,
                jax.device_get(_stats(cnt, jnp.zeros_like(cnt))),
            )
            if conflicts == 0:
                break
            rounds += 1
            key, k_r = jax.random.split(key)
            cap = pick_cap(caps, n_flag)
            colors, cnt = self._tailcut_fn(cap)(
                ell, colors, cnt, ordered, k_r, cap=cap
            )
        return colors, cnt, conflicts, rounds

    def run(self, seed: int, repetition: int = 0) -> Coloring:
        g, params, ell = self.graph, self.params, self.ell
        t0 = time.perf_counter()
        key = rngu.for_repetition(rngu.root_key(seed), repetition)
        key, k_init = jax.random.split(key)
        from mcmc_colorer_tpu.models.mcmc import _init_colors

        colors = _init_colors(ell, params, k_init)
        taboo = jnp.zeros((ell.n_pad,), jnp.int32)
        cnt = None  # maintained only in active mode (computing it costs a
        # full gather; full-mode iterations count conflicts per sweep)
        z = params.tailcut_threshold(g.n)
        caps = _buckets(ell.n_pad, self._min_bucket, self._bucket_factor)
        switch_at = ell.n_pad // 8  # conflict-edge threshold for active mode
        trace = []
        rip = 0
        conflicts = None
        while rip < params.max_iterations:
            key, k_it = jax.random.split(key)
            if cnt is None:
                # full mode: the sweep also measures conflicts of the
                # CURRENT coloring; the proposal is discarded when
                # already converged (reference do-while semantics)
                star, new_taboo, conf_cur = self._jit_full(
                    ell, colors, taboo, k_it
                )
                conflicts = int(conf_cur)
                trace.append(conflicts)
                if conflicts <= z:
                    break
                colors, taboo = star, new_taboo
                rip += 1
                if 2 * conflicts < switch_at:
                    cnt = self._jit_cnt(ell, colors)  # one-time transition
            else:
                n_active, conflicts = map(
                    int, jax.device_get(_stats(cnt, taboo))
                )
                trace.append(conflicts)
                if conflicts <= z:
                    break
                rip += 1
                cap = pick_cap(caps, n_active)
                colors, taboo, cnt = self._active_fn(cap)(
                    ell, colors, taboo, cnt, k_it, cap=cap
                )
        else:
            if cnt is None:
                cnt = self._jit_cnt(ell, colors)
            _, conflicts = map(int, jax.device_get(_stats(cnt, taboo)))
            trace.append(conflicts)

        tc_rounds = 0
        if params.tailcut and conflicts > 0:
            if cnt is None:
                cnt = self._jit_cnt(ell, colors)
            colors, cnt, conflicts, tc_rounds = self._tailcut_active(
                colors, cnt, key
            )

        dur = (time.perf_counter() - t0) * 1e3
        if self._perm is not None:
            padded = np.asarray(jax.device_get(colors))
            out_colors = np.empty(g.n, np.int32)
            out_colors[self._perm] = padded[self._pos]
        else:
            out_colors = np.asarray(colors)[: g.n]
        return Coloring(
            colors=out_colors,
            n_colors=params.n_colors,
            iterations=rip,
            converged=conflicts <= z,
            duration_ms=dur,
            conflict_trace=np.asarray(trace, dtype=np.int64),
            extra={
                "final_conflicts": conflicts,
                "max_iter_reached": rip >= params.max_iterations,
                "tailcut_rounds": tc_rounds,
            },
        )


# --------------------------- jitted pieces ---------------------------------


def _rows_of(ell, ids, valid, adj_packed=None, d_row=None):
    """Frontier neighbor-id rows: gathered from the stored ELL, or —
    on resident hash graphs that never materialise one — sliced from
    the packed adjacency and unpacked to ascending id lists
    (ops/dense_adj.packed_rows_to_ids; VERDICT r4 item 3).  Every
    consumer is order-invariant, so the two sources are
    interchangeable (tested)."""
    if adj_packed is None:
        return take_rows(ell, ids, valid)
    from mcmc_colorer_tpu.ops.dense_adj import packed_rows_to_ids

    n_pad = ell.n_pad
    bits = jnp.take(adj_packed, jnp.minimum(ids, n_pad - 1), axis=0)
    rows = packed_rows_to_ids(bits, d_row, n_pad)
    return jnp.where(valid[:, None], rows, jnp.int32(n_pad))


def _cnt_of_packed(adj, colors, *, params: MCMCParams, node_mask):
    """NC-native rendition of `_cnt_of` for resident graphs (the shim
    ELL is edgeless): cnt[i] = NC[i, c_i] via one contraction."""
    from mcmc_colorer_tpu.ops.dense_adj import neighbor_color_counts

    nc = neighbor_color_counts(adj, colors, params.n_colors, node_mask)
    own = jnp.take_along_axis(
        nc, jnp.minimum(colors, nc.shape[1] - 1)[:, None], axis=1
    )[:, 0]
    return jnp.where(node_mask, own, 0)


@jax.jit
def _stats(cnt, taboo):
    viol = cnt > 0
    return jnp.sum((viol & (taboo == 0)).astype(jnp.int32)), jnp.sum(
        cnt, dtype=jnp.int32
    ) // 2


def _cnt_of(ell: EllGraph, colors, *, params: MCMCParams):
    """Full per-vertex same-color-neighbor counts (one full gather;
    per degree-class rectangle on the bucketed layout)."""
    if _is_bucketed(ell):
        parts = []
        for s in ell.slices:
            nc = neighbor_colors(s.neighbors, colors)
            own = _slice_vec(colors, s.start, s.h_pad)
            parts.append(
                jnp.sum((nc == own[:, None]).astype(jnp.int32), axis=1)
            )
        return jnp.concatenate(parts)
    nc = neighbor_colors(ell.neighbors, colors)
    return jnp.sum((nc == colors[:, None]).astype(jnp.int32), axis=1)


def _full_iteration(
    ell: EllGraph,
    colors,
    taboo,
    key,
    *,
    params: MCMCParams,
    block: int,
):
    """One synchronous full sweep; returns (star, taboo', conflicts of the
    CURRENT coloring)."""
    key, k_u = jax.random.split(key)
    unif = jax.random.uniform(k_u, (ell.n_pad,), dtype=jnp.float32)
    hist = (
        color_histogram(colors, params.n_colors, ell.node_mask)
        if _needs_histogram(params)
        else None
    )
    p_eff = _variant_distribution(params, hist, ell.n_nodes)
    star, new_taboo, _ = _sweep_any(
        ell, params, block, colors, taboo, unif, p_eff
    )
    conf = _conflict_edges_any(ell, colors)
    return star, new_taboo, conf


def _active_iteration(
    ell: EllGraph,
    colors,
    taboo,
    cnt,
    key,
    *,
    cap: int,
    params: MCMCParams,
    adj_packed=None,
    d_row: int | None = None,
):
    """Resample the ≤cap active vertices; apply passive dynamics to the
    rest; maintain cnt incrementally.  With ``adj_packed`` the frontier
    rows come from the packed adjacency (resident graphs)."""
    n_pad = ell.n_pad
    n_colors = params.n_colors
    t_iter = jnp.int32(params.taboo_iterations)
    key, k_u, k_flip, k_fv, k_fc = jax.random.split(key, 5)

    active_mask = (cnt > 0) & (taboo == 0) & ell.node_mask
    (active_ids,) = jnp.nonzero(
        active_mask, size=cap, fill_value=n_pad
    )
    valid = active_ids < n_pad
    ids_c = jnp.minimum(active_ids, n_pad - 1)

    rows = _rows_of(ell, active_ids, valid, adj_packed, d_row)
    cur = jnp.where(
        valid, jnp.take(colors, ids_c), jnp.int32(n_colors)
    )
    nc = neighbor_colors(rows, colors)

    hist = (
        color_histogram(colors, n_colors, ell.node_mask)
        if _needs_histogram(params)
        else None
    )
    p_eff = _variant_distribution(params, hist, ell.n_nodes)
    unif = jax.random.uniform(k_u, (cap,), dtype=jnp.float32)

    from mcmc_colorer_tpu.models.mcmc import _proposal_q, _sample_cdf
    from mcmc_colorer_tpu.ops.neighbor import occupancy_matrix

    occ = occupancy_matrix(nc, n_colors)
    q = _proposal_q(cur, occ, params, p_eff)
    chosen = _sample_cdf(q, unif)
    new_taboo_a = jnp.where(chosen == cur, t_iter, 0)
    chosen = jnp.where(valid, chosen, cur)

    # ---- passive dynamics ------------------------------------------------
    # ε-flip of non-violating vertices (single-flip approximation)
    p_per = (n_colors - 1) * params.epsilon
    eligible = (~(cnt > 0)) & (taboo == 0) & ell.node_mask
    n_elig = jnp.sum(eligible, dtype=jnp.float32)
    p_any = 1.0 - jnp.exp(
        n_elig * jnp.log1p(-jnp.float32(min(p_per, 0.999999)))
    )
    do_flip = jax.random.uniform(k_flip, ()) < p_any
    fv = jax.random.randint(k_fv, (), 0, n_pad, dtype=jnp.int32)
    fv_ok = do_flip & jnp.take(eligible, fv)
    fv_old = jnp.take(colors, fv)
    offs = jax.random.randint(
        k_fc, (), 1, max(n_colors, 2), dtype=jnp.int32
    )
    fv_new = jax.lax.rem(fv_old + offs, jnp.int32(n_colors))

    # taboo: active → sweep result; taboo>0 → decrement; passive keepers
    # (taboo==0, not flipped) → reset to T (they drew 'keep')
    taboo_next = jnp.where(
        taboo > 0,
        taboo - 1,
        jnp.where(ell.node_mask, t_iter, 0),
    )
    taboo_next = taboo_next.at[ids_c].set(
        jnp.where(valid, new_taboo_a, jnp.take(taboo_next, ids_c)),
        mode="drop",
    )
    taboo_next = jnp.where(
        fv_ok & (jnp.arange(n_pad) == fv), 0, taboo_next
    )

    # ---- apply color changes --------------------------------------------
    colors_next = colors.at[active_ids].set(chosen, mode="drop")
    colors_next = jnp.where(
        fv_ok & (jnp.arange(n_pad) == fv), fv_new, colors_next
    )

    # ---- incremental cnt maintenance ------------------------------------
    nc_new = neighbor_colors(rows, colors_next)
    old_a = cur
    new_a = jnp.where(valid, jnp.take(colors_next, ids_c), cur)
    delta = (nc_new == new_a[:, None]).astype(jnp.int32) - (
        nc_new == old_a[:, None]
    ).astype(jnp.int32)
    cnt_next = cnt.at[rows.reshape(-1)].add(
        delta.reshape(-1), mode="drop"
    )
    cnt_active = jnp.sum(
        (nc_new == new_a[:, None]).astype(jnp.int32), axis=1
    )
    cnt_next = cnt_next.at[ids_c].set(
        jnp.where(valid, cnt_active, jnp.take(cnt_next, ids_c)),
        mode="drop",
    )
    # a flip invalidates incremental counts around fv → full recompute,
    # amortized to ~never at reference ε
    cnt_next = jax.lax.cond(
        fv_ok,
        lambda: (
            _cnt_of_packed(
                adj_packed,
                colors_next,
                params=params,
                node_mask=ell.node_mask,
            )
            if adj_packed is not None
            else _cnt_of(ell, colors_next, params=params)
        ),
        lambda: cnt_next,
    )
    return colors_next, taboo_next, cnt_next


def _tailcut_round(
    ell: EllGraph,
    colors,
    cnt,
    ordered,    # [nCol] colors by ascending class size (fixed at entry)
    key,
    *,
    cap: int,
    params: MCMCParams,
    adj_packed=None,
    d_row: int | None = None,
):
    """One frontier-sized greedy round: conflicting vertices (cnt>0) with
    no lower-id conflicting neighbor move to their first free color in
    ``ordered`` order; when a round can move nobody, the frontier is
    randomly recolored (unlock_stall).  cnt maintained incrementally."""
    n_pad = ell.n_pad
    n_colors = params.n_colors

    flagged = (cnt > 0) & ell.node_mask
    (ids,) = jnp.nonzero(flagged, size=cap, fill_value=n_pad)
    valid = ids < n_pad
    ids_c = jnp.minimum(ids, n_pad - 1)
    rows = _rows_of(ell, ids, valid, adj_packed, d_row)
    cur = jnp.where(valid, jnp.take(colors, ids_c), jnp.int32(n_colors))
    nc = neighbor_colors(rows, colors)

    # occupancy of the frontier rows only ([cap, nCol] — frontier-sized)
    from mcmc_colorer_tpu.ops.neighbor import occupancy_matrix

    occ = occupancy_matrix(nc, n_colors)
    free_perm = ~jnp.take(occ, ordered, axis=1)
    found = jnp.any(free_perm, axis=1)
    cand = jnp.take(ordered, jnp.argmax(free_perm, axis=1))

    # movable & no lower-id movable conflicting neighbor
    movable_full = (
        jnp.zeros((n_pad,), jnp.bool_)
        .at[ids_c]
        .set(valid & found, mode="drop")
    )
    movable_ext = jnp.concatenate(
        [movable_full, jnp.zeros((1,), jnp.bool_)]
    )
    lower_movable = jnp.any(
        jnp.take(movable_ext, rows, axis=0) & (rows < ids[:, None]),
        axis=1,
    )
    active = valid & found & ~lower_movable
    stalled = ~jnp.any(active)
    rnd = jax.random.randint(key, (cap,), 0, n_colors, dtype=jnp.int32)
    new_col = jnp.where(
        active, cand, jnp.where(stalled & valid, rnd, cur)
    )

    colors_next = colors.at[ids].set(new_col, mode="drop")
    # incremental cnt update (same bookkeeping as _active_iteration)
    nc_new = neighbor_colors(rows, colors_next)
    new_a = jnp.where(valid, jnp.take(colors_next, ids_c), cur)
    delta = (nc_new == new_a[:, None]).astype(jnp.int32) - (
        nc_new == cur[:, None]
    ).astype(jnp.int32)
    cnt_next = cnt.at[rows.reshape(-1)].add(
        delta.reshape(-1), mode="drop"
    )
    cnt_self = jnp.sum(
        (nc_new == new_a[:, None]).astype(jnp.int32), axis=1
    )
    cnt_next = cnt_next.at[ids_c].set(
        jnp.where(valid, cnt_self, jnp.take(cnt_next, ids_c)),
        mode="drop",
    )
    return colors_next, cnt_next
