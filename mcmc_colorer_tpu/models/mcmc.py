"""MCMC balanced graph colorer — the framework's flagship model.

A JAX re-design of the reference's MCMC colorer pair
(coloringMCMC_CPU.cpp sequential chain, coloringMCMC_main.cu + proposal
kernels GPU chain; semantics in SURVEY §3.1-§3.2).  The whole chain — init,
proposal sweeps, conflict reductions, acceptance, tail-cutting — runs on
the device as jitted `lax.while_loop`s, eliminating the reference's
per-iteration host round-trips (its main structural inefficiency,
SURVEY §4.1).

Key design points vs the reference:

* The per-vertex CDF walk over colors (coloringMCMC_standard.cu:50-58 etc.)
  becomes a vectorized inverse-CDF categorical sample over a [block, nCol]
  probability matrix: identical distribution, identical choice given the
  same per-vertex uniform.
* The persistent nnodes×nCol ``colorsChecker_d`` bool matrix
  (coloringMCMC_main.cu:39, the reference's HBM limiter) is never
  materialised; occupancy lives per vertex-block inside a `lax.map`.
* All proposal variants of the reference's compile-time #define matrix
  (coloringMCMC.h:27-41) are runtime options, including Metropolis–Hastings
  acceptance — disabled by default exactly like the shipped reference
  (always-accept resampling dynamic, SURVEY §9.2).
* The taboo path explicitly keeps the current color (fixing the reference's
  stale-buffer reliance, SURVEY §9.5).
* Conflicts are counted as deduped conflicting *edges* (GPU metric,
  coloringMCMC_utils.cu:113-116; SURVEY §9.4).
* The tail-cutting epilogue recolors an independent set of conflicting
  vertices per round (deterministic, device-side) instead of the
  reference's serial <<<1,1>>> kernel (coloringMCMC_utils.cu:73-101),
  implementing the intended semantics of the buggy CPU version (SURVEY §9.1).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_colorer_tpu.config import InitKind, MCMCParams, ProposalKind
from mcmc_colorer_tpu.graph.container import EllGraph, Graph
from mcmc_colorer_tpu.models.base import Coloring
from mcmc_colorer_tpu.ops.neighbor import (
    color_histogram,
    neighbor_colors,
    occupancy_matrix,
)
from mcmc_colorer_tpu.utils import rng as rngu

# ---------------------------------------------------------------------------
# block sizing: cap the [block, nCol] occupancy/probability buffers
# ---------------------------------------------------------------------------

_BLOCK_BYTES_TARGET = 32 * 1024 * 1024


def choose_block_size(n: int, n_colors: int) -> int:
    """Vertex-block size so the per-block [B, nCol] f32 buffers stay a few
    tens of MB (they replace the reference's full nnodes×nCol matrix)."""
    b = _BLOCK_BYTES_TARGET // max(4 * n_colors, 1)
    b = max(128, min(1 << 16, b))
    b = 1 << int(math.floor(math.log2(b)))  # power of two for clean tiling
    if n <= b:
        return max(128, 1 << int(math.ceil(math.log2(max(n, 8)))))
    return b


# ---------------------------------------------------------------------------
# static per-run distributions (initDistributionLine/Exp, _utils.cu:5-21)
# ---------------------------------------------------------------------------


def distribution_line(n_colors: int, lambda_: float) -> jnp.ndarray:
    idx = jnp.arange(n_colors, dtype=jnp.float32)
    w = jnp.float32(n_colors) - jnp.float32(lambda_) * idx
    return w / jnp.sum(w)


def distribution_exp(n_colors: int, lambda_: float) -> jnp.ndarray:
    idx = jnp.arange(n_colors, dtype=jnp.float32)
    w = jnp.exp(-jnp.float32(lambda_) * idx)
    return w / jnp.sum(w)


def dynamic_distribution(hist: jnp.ndarray, n_nodes: int) -> jnp.ndarray:
    """p_c = (1 − count_c/n)/(nCol−1) — emptier classes get more mass
    (genDynamicDistribution, coloringMCMC_utils.cu:64-70)."""
    n_colors = hist.shape[0]
    return (1.0 - hist.astype(jnp.float32) / jnp.float32(n_nodes)) / jnp.float32(
        max(n_colors - 1, 1)
    )


# ---------------------------------------------------------------------------
# proposal: build the per-vertex probability row and sample it
# ---------------------------------------------------------------------------


def _proposal_q(
    cur: jnp.ndarray,        # [B] current colors
    occ: jnp.ndarray,        # [B, nCol] neighbor-color occupancy
    params: MCMCParams,
    p_eff: jnp.ndarray | None,  # [nCol] variant distribution (already
                                 # orderedIndex-permuted where applicable)
    eps: jnp.ndarray | None = None,  # dynamic ε override (pooled annealing)
    n_colors: int | None = None,     # palette size when occ's color axis is
                                     # padded (NC path); padded columns
                                     # must be un-occupied and get q = 0
) -> jnp.ndarray:
    """[B, nColPad] proposal probabilities — vectorization of the
    reference's selectStarColoring* per-color CDF terms (exact formulas:
    _standard.cu:50-58, _decrease.cu:50-58, _balance.cu:122-135)."""
    width = occ.shape[1]
    n_colors = n_colors or width
    eps = jnp.float32(params.epsilon) if eps is None else eps
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, width), 1)
    col_valid = col_ids < n_colors
    free = ~occ & col_valid
    zn = jnp.sum(occ, axis=1, dtype=jnp.int32)
    zp = jnp.int32(n_colors) - zn
    zp_f = jnp.maximum(zp, 1).astype(jnp.float32)
    col_is_cur = col_ids == cur[:, None]
    # keep-current distribution (non-violating case, _standard.cu:55-57)
    keep_q = jnp.where(col_is_cur, 1.0 - (n_colors - 1) * eps, eps)

    kind = params.proposal
    if kind == ProposalKind.STANDARD:
        move_q = jnp.where(
            free, ((1.0 - eps * zn.astype(jnp.float32)) / zp_f)[:, None], eps
        )
    elif kind in (
        ProposalKind.BALANCE_LINE,
        ProposalKind.BALANCE_EXP,
        ProposalKind.BALANCE_DYNAMIC,
    ):
        # reminder = Σ_occupied (p_eff − ε), redistributed uniformly over the
        # free colors (_balance.cu:29-33,122-128)
        reminder = jnp.sum(
            jnp.where(occ, p_eff[None, :] - eps, 0.0), axis=1
        )
        move_q = jnp.where(
            free, p_eff[None, :] + (reminder / zp_f)[:, None], eps
        )
    elif kind in (ProposalKind.DECREASE_LINE, ProposalKind.DECREASE_EXP):
        # reminder redistributed exp(-λ·j)/Σ_{i<Zp}exp(-λ·i) over the j-th
        # free color in index order (_decrease.cu:42-58)
        lam = jnp.float32(params.lambda_)
        reminder = jnp.sum(
            jnp.where(occ, p_eff[None, :] - eps, 0.0), axis=1
        )
        j = jnp.cumsum(free.astype(jnp.float32), axis=1) - 1.0
        if params.lambda_ == 0.0:
            denom_r = zp_f
            w = jnp.ones_like(j) / denom_r[:, None]
        else:
            denom_r = (1.0 - jnp.exp(-lam * zp_f)) / (1.0 - jnp.exp(-lam))
            w = jnp.exp(-lam * j) / denom_r[:, None]
        move_q = jnp.where(free, p_eff[None, :] + reminder[:, None] * w, eps)
    else:  # pragma: no cover
        raise ValueError(f"unknown proposal {kind}")

    # occ[v, cur[v]] as a masked reduction, without a gather
    violating = jnp.sum((occ & col_is_cur).astype(jnp.int32), axis=1) > 0
    q = jnp.where((violating & (zp > 0))[:, None], move_q, keep_q)
    # no free color: keep current with probability 1 (_standard.cu:40-44)
    q = jnp.where((zp == 0)[:, None], col_is_cur.astype(jnp.float32), q)
    # padded palette columns carry no probability mass
    return jnp.where(col_valid, q, 0.0)


def _sample_cdf(
    q: jnp.ndarray,
    unif: jnp.ndarray,
    n_colors: int | None = None,
) -> jnp.ndarray:
    """Inverse-CDF walk: first color whose cumulative probability reaches
    the uniform — bit-exact with the reference's do/while threshold walk
    given the same uniform (overflow guard picks the last color,
    _standard.cu:50-58)."""
    cdf = jnp.cumsum(q, axis=1)
    chosen = jnp.sum(cdf < unif[:, None], axis=1, dtype=jnp.int32)
    return jnp.minimum(chosen, (n_colors or q.shape[1]) - 1)


# ---------------------------------------------------------------------------
# the colorer
# ---------------------------------------------------------------------------


class MCMCColorer:
    """Balanced-coloring MCMC chain, fully device-resident.

    Counterpart of both ``ColoringMCMC_CPU::run`` (coloringMCMC_CPU.cpp:116)
    and ``ColoringMCMC::run`` (coloringMCMC_main.cu:101).
    """

    def __init__(
        self,
        graph: Graph,
        params: MCMCParams,
        block_size: int | None = None,
        backend: str = "auto",
        layout: str = "flat",
    ) -> None:
        """``backend``: 'xla' (neighbor-color gather sweep; also what
        'auto' selects), 'matmul' (neighbor color counts as one int8
        contraction of the adjacency with onehot(colors): the dense
        n_pad^2-byte adjacency where it fits the device, else the
        bit-packed one, see ops/dense_adj.py), or 'packed' (matmul fed by
        the bit-packed n_pad^2/8-byte adjacency even where dense fits).

        ``layout``: 'flat' (one ELL rectangle padded to max degree) or
        'bucketed' (degree-relabeled per-class rectangles — 10-100x less
        gather volume on skewed-degree graphs; see
        graph/container.py:BucketedEll)."""
        self.graph = graph
        self.params = params
        self.block = block_size or choose_block_size(graph.n, params.n_colors)
        if backend == "auto":
            backend = "xla"
        force_packed = backend == "packed"
        if force_packed:
            backend = "matmul"  # same sweep; the adjacency dtype differs
        if backend not in ("xla", "matmul"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "matmul" and layout != "flat":
            raise ValueError(
                "backend='matmul' is flat-layout only (the dense "
                "adjacency already removes the degree-padding cost the "
                "bucketed layout exists to cut)"
            )
        self.backend = backend
        self.layout = layout
        if layout == "bucketed":
            if block_size is None:
                # bound per-bucket phantom padding and [B, nCol] buffers
                self.block = min(self.block, 2048)
            g2, perm = graph.degree_relabel()
            self._perm = perm
            # bucket heights round to 128 rows (not the sweep block) so
            # phantom padding stays bounded; sweeps fall back to 128-row
            # blocks when a slice height is not a block multiple
            self.ell = g2.to_ell_bucketed(block=128)
            self._pos = self.ell.real_positions()
        elif layout == "flat":
            self._perm = None
            self.ell = graph.to_ell(pad_nodes_to=self.block)
        else:
            raise ValueError(f"unknown layout {layout!r}")
        self._adj = None
        if backend == "matmul":
            from mcmc_colorer_tpu.ops.dense_adj import (
                get_adjacency,
                matmul_adjacency_kind,
            )

            kind = matmul_adjacency_kind(self.ell.n_pad, force_packed)
            # built on-device from the ELL, cached per (graph, n_pad,
            # kind) across colorers and repetitions (VERDICT r2 item 2)
            self._adj = get_adjacency(graph, self.ell.n_pad, kind, self.ell)
        # The chain loop is compiled ONCE with a traced iteration budget
        # and driven from the host in segments (utils/segmented.py).
        # Segmented runs are bit-equal to one execution.
        if backend == "matmul":
            self._fused_carry = True
            # adj travels as an argument (a closure capture would be
            # constant-folded into the executable)
            seg4 = jax.jit(
                partial(
                    _chain_segment_matmul, params=params, block=self.block
                )
            )
            self._jit_segment = lambda ell, carry, budget: seg4(
                ell, self._adj, carry, budget
            )
        else:
            self._fused_carry = False
            self._jit_segment = jax.jit(
                partial(_chain_segment, params=params, block=self.block)
            )
        self._jit_init = jax.jit(
            partial(_chain_init, params=params, fused=self._fused_carry)
        )
        self._jit_final = jax.jit(_chain_final_conflicts)
        self._jit_tc_init = jax.jit(partial(_tailcut_init, params=params))
        self._jit_tc_segment = jax.jit(
            partial(_tailcut_segment, params=params, block=self.block)
        )
        self._jit_tc_finish = jax.jit(
            partial(_tailcut_finish, params=params)
        )

    def run(self, seed: int, repetition: int = 0) -> Coloring:
        import time

        from mcmc_colorer_tpu.utils.segmented import drive_segments

        params = self.params
        z = params.tailcut_threshold(self.graph.n)
        key = rngu.for_repetition(rngu.root_key(seed), repetition)
        t0 = time.perf_counter()
        carry = self._jit_init(self.ell, key)

        def progress(c):
            rip = int(c[3])
            if self._fused_carry:
                done = bool(c[6]) or rip >= params.max_iterations
            else:
                done = int(c[4]) <= z or rip >= params.max_iterations
            return rip, done

        def segment(c, b):
            return self._jit_segment(self.ell, c, jnp.int32(b))

        # per-segment free-color TRACE (the reference's getStatsFreeColors
        # verbose lines, coloringMCMC_prints.cu:117-131): granularity is
        # the host-driven segment boundary, so TRACE-off runs pay nothing
        # and the in-loop carry is untouched
        from mcmc_colorer_tpu.utils import term

        fc_segments: list = []
        trace_free = term.trace_enabled() and isinstance(
            self.ell, EllGraph
        )
        if trace_free and not hasattr(self, "_jit_free"):
            self._jit_free = jax.jit(
                partial(
                    _free_color_stats,
                    n_colors=params.n_colors,
                    block=self.block,
                )
            )

        def on_seg(state, steps, budget, elapsed):
            if trace_free:
                mn, mx, avg = self._jit_free(self.ell, state[0])
                mn, mx, avg = int(mn), int(mx), float(avg)
                fc_segments.append((mn, mx, avg))
                term.trace(
                    f"Max Free Colors: {mx} - Min Free Colors: {mn} - "
                    f"AVG Free Colors: {avg:g}"
                )

        carry = drive_segments(segment, carry, progress, on_segment=on_seg)
        colors, _taboo, key, rip, conflicts, trace, _done = carry
        if self._fused_carry:
            conflicts = self._jit_final(self.ell, carry)
        tailcut_rounds = jnp.int32(0)
        if params.tailcut:
            key, k_tc = jax.random.split(key)
            colors_r, ordered = self._jit_tc_init(self.ell, colors)
            tc = (colors_r, conflicts, jnp.int32(0), jnp.bool_(False))
            tc_max = _tailcut_max_rounds(self.ell)

            def tc_progress(c):
                rounds = int(c[2])
                return rounds, bool(c[3]) or rounds >= tc_max

            tc = drive_segments(
                lambda c, b: self._jit_tc_segment(
                    self.ell, c, k_tc, jnp.int32(b)
                ),
                tc,
                tc_progress,
            )
            colors = self._jit_tc_finish(self.ell, tc[0], ordered)
            conflicts, tailcut_rounds = tc[1], tc[2]
        if self._perm is not None:
            padded = np.asarray(jax.device_get(colors))
            colors = np.empty(self.graph.n, np.int32)
            colors[self._perm] = padded[self._pos]
        else:
            colors = np.asarray(jax.device_get(colors))[: self.graph.n]
        dur = (time.perf_counter() - t0) * 1e3
        rip = int(rip)
        return Coloring(
            colors=colors,
            n_colors=self.params.n_colors,
            iterations=rip,
            converged=int(conflicts) == 0
            or int(conflicts) <= self.params.tailcut_threshold(self.graph.n),
            duration_ms=dur,
            conflict_trace=np.asarray(trace)[: rip + 1],
            extra={
                "final_conflicts": int(conflicts),
                "max_iter_reached": rip >= self.params.max_iterations,
                "tailcut_rounds": int(tailcut_rounds),
                **(
                    {"free_color_trace_segments": fc_segments}
                    if fc_segments
                    else {}
                ),
            },
        )


# --------------------------- jitted chain body -----------------------------


def _map_blocks(fn, n_blocks: int, block: int, *arrays):
    """lax.map over vertex blocks: reshape leading n_pad axis to
    [n_blocks, block, ...] and scan ``fn`` over it (bounds the [B, nCol]
    working set; the reference instead allocated it for all vertices)."""
    xs = tuple(a.reshape((n_blocks, block) + a.shape[1:]) for a in arrays)
    return jax.lax.map(fn, xs)


def _conflict_edges(ell: EllGraph, colors: jnp.ndarray) -> jnp.ndarray:
    colors_ext = jnp.concatenate(
        [colors, jnp.full((1,), -1, jnp.int32)]
    )
    n_pad, d_pad = ell.neighbors.shape
    node_ids = jnp.arange(n_pad, dtype=jnp.int32)
    # per-super-block gathers: the monolithic count holds ~2 full
    # [n_pad, d_pad] temporaries (10.3 GB at ER(1M), memory_analysis r3)
    sb = _fused_super_block(n_pad, d_pad)

    def sb_fn(xs):
        neigh_sb, own_sb, ids_sb = xs
        nc = jnp.take(colors_ext, neigh_sb, axis=0)
        same = (nc == own_sb[:, None]) & (neigh_sb > ids_sb[:, None])
        return jnp.sum(same, dtype=jnp.int32)

    if sb == n_pad:
        return sb_fn((ell.neighbors, colors, node_ids))
    return jnp.sum(
        _map_blocks(sb_fn, n_pad // sb, sb, ell.neighbors, colors, node_ids)
    )


# ----------------------- degree-bucketed layout path -----------------------
# Per-degree-class rectangles (graph/container.py:BucketedEll): each helper
# below is the bucketed rendition of its flat counterpart — a python loop
# over the (few, static) slices, each slice processed exactly like the flat
# ELL but at its own lane width, results concatenated in padded-global
# order.  Cuts the dominant neighbor-color gather from n·d_max to ~2m
# elements on skewed-degree graphs (PERF.md roadmap item 5).


def _is_bucketed(ell) -> bool:
    from mcmc_colorer_tpu.graph.container import BucketedEll

    return isinstance(ell, BucketedEll)


def _slice_vec(x: jnp.ndarray, start: int, size: int) -> jnp.ndarray:
    return jax.lax.slice(x, (start,), (start + size,))


def _conflict_edges_bucketed(bell, colors: jnp.ndarray) -> jnp.ndarray:
    colors_ext = jnp.concatenate([colors, jnp.full((1,), -1, jnp.int32)])
    total = jnp.int32(0)
    for s in bell.slices:
        nc = jnp.take(colors_ext, s.neighbors, axis=0)
        own = _slice_vec(colors, s.start, s.h_pad)
        gids = s.start + jnp.arange(s.h_pad, dtype=jnp.int32)
        same = (nc == own[:, None]) & (s.neighbors > gids[:, None])
        total = total + jnp.sum(same, dtype=jnp.int32)
    return total


def _conflict_edges_any(ell, colors):
    if _is_bucketed(ell):
        return _conflict_edges_bucketed(ell, colors)
    return _conflict_edges(ell, colors)


def _init_colors(ell: EllGraph, params: MCMCParams, key) -> jnp.ndarray:
    """Initial coloring (initColoring / initColoringWithDistribution,
    coloringMCMC_utils.cu:24-61).  Phantom padding vertices get the
    out-of-palette color nCol so they never pollute histograms."""
    n_pad = ell.n_pad
    n_colors = params.n_colors
    u = jax.random.uniform(key, (n_pad,), dtype=jnp.float32)
    if params.init == InitKind.UNIFORM:
        colors = jnp.minimum(
            (u * n_colors).astype(jnp.int32), n_colors - 1
        )
    else:
        dist = (
            distribution_line(n_colors, params.lambda_)
            if params.init == InitKind.DISTRIBUTION_LINE
            else distribution_exp(n_colors, params.lambda_)
        )
        cdf = jnp.cumsum(dist)
        colors = jnp.minimum(
            jnp.sum(cdf[None, :] < u[:, None], axis=1, dtype=jnp.int32),
            n_colors - 1,
        )
    return jnp.where(ell.node_mask, colors, jnp.int32(n_colors))


def _variant_distribution(
    params: MCMCParams, hist: jnp.ndarray | None, n_nodes: int
) -> jnp.ndarray | None:
    """Per-iteration effective distribution p_eff[c], already permuted the
    way the kernels consume it (p_dist[orderedIndex[c]]).

    Quirk preserved deliberately: BALANCE_LINE/EXP apply
    ``p_dist[argsort(hist)[c]]`` (coloringMCMC_main.cu:192-198 +
    _balance.cu:58), while BALANCE_DYNAMIC leaves orderedIndex at identity
    for the whole run (it is initialised once, _main.cu:130-133, and only
    re-sorted by the OTHER variants) so p_eff is the dynamic distribution
    indexed directly by color."""
    kind = params.proposal
    if kind == ProposalKind.STANDARD:
        return None
    if kind == ProposalKind.DECREASE_LINE:
        return distribution_line(params.n_colors, params.lambda_)
    if kind == ProposalKind.DECREASE_EXP:
        return distribution_exp(params.n_colors, params.lambda_)
    if kind == ProposalKind.BALANCE_LINE:
        base = distribution_line(params.n_colors, params.lambda_)
        return jnp.take(base, jnp.argsort(hist), axis=0)
    if kind == ProposalKind.BALANCE_EXP:
        base = distribution_exp(params.n_colors, params.lambda_)
        return jnp.take(base, jnp.argsort(hist), axis=0)
    if kind == ProposalKind.BALANCE_DYNAMIC:
        return dynamic_distribution(hist, n_nodes)
    raise ValueError(kind)


def _needs_histogram(params: MCMCParams) -> bool:
    return params.proposal in (
        ProposalKind.BALANCE_LINE,
        ProposalKind.BALANCE_EXP,
        ProposalKind.BALANCE_DYNAMIC,
    )


# Cap on the materialised [SB, d_pad] neighbor-color matrix per
# super-block of the conflict count and the tailcut: the monolithic
# versions hold several full [n_pad, d_pad] gather outputs, which at
# ER(1M) is tens of GB; capping the super-block bounds them at any n.
_FUSED_NC_BYTES_CAP = 512 * 1024**2


def _fused_super_block(n_pad: int, d_pad: int) -> int:
    """Largest 128-multiple divisor of n_pad whose [SB, d_pad] int32
    gather output stays under the cap (n_pad itself when it fits)."""
    cap_rows = max(128, _FUSED_NC_BYTES_CAP // max(d_pad * 4, 1))
    if n_pad <= cap_rows:
        return n_pad
    sb = 128
    d = 128
    while d <= n_pad:
        if n_pad % d == 0 and d <= cap_rows:
            sb = d
        d *= 2
    return sb


def _sweep(
    ell: EllGraph,
    params: MCMCParams,
    block: int,
    colors: jnp.ndarray,
    taboo: jnp.ndarray,
    unif: jnp.ndarray,
    p_eff: jnp.ndarray | None,
    eps: jnp.ndarray | None = None,
):
    """One full proposal sweep: returns (star_colors, new_taboo,
    Σ log qStar).  Synchronous update over the old coloring, exactly like
    the reference's single kernel launch."""
    n_pad = ell.n_pad
    n_blocks = n_pad // block
    n_colors = params.n_colors
    node_ids = jnp.arange(n_pad, dtype=jnp.int32)

    def block_fn(xs):
        neigh_blk, cur_blk, taboo_blk, unif_blk, real_blk = xs
        nc = neighbor_colors(neigh_blk, colors)
        occ = occupancy_matrix(nc, n_colors)
        q = _proposal_q(cur_blk, occ, params, p_eff, eps=eps)
        chosen = _sample_cdf(q, unif_blk)
        qstar = jnp.take_along_axis(q, chosen[:, None], axis=1)[:, 0]
        # taboo: explicit keep (intended semantics of _standard.cu:15-20;
        # SURVEY §9.5)
        taboo_active = taboo_blk > 0
        keep_prob = jnp.float32(1.0 - (n_colors - 1) * params.epsilon)
        chosen = jnp.where(taboo_active, cur_blk, chosen)
        qstar = jnp.where(taboo_active, keep_prob, qstar)
        new_taboo = jnp.where(
            taboo_active,
            taboo_blk - 1,
            jnp.where(
                chosen == cur_blk, jnp.int32(params.taboo_iterations), 0
            ),
        )
        # phantom vertices keep their out-of-palette color
        chosen = jnp.where(real_blk, chosen, cur_blk)
        qstar = jnp.where(real_blk, qstar, 1.0)
        logq = jnp.sum(jnp.log(jnp.maximum(qstar, 1e-30)))
        return chosen, new_taboo, logq

    star_b, taboo_b, logq_b = _map_blocks(
        block_fn,
        n_blocks,
        block,
        ell.neighbors,
        colors,
        taboo,
        unif,
        node_ids < jnp.int32(ell.n_nodes),
    )
    return (
        star_b.reshape(n_pad),
        taboo_b.reshape(n_pad),
        jnp.sum(logq_b),
    )


def _sweep_bucketed(
    bell,
    params: MCMCParams,
    block: int,
    colors: jnp.ndarray,
    taboo: jnp.ndarray,
    unif: jnp.ndarray,
    p_eff: jnp.ndarray | None,
    eps: jnp.ndarray | None = None,
):
    """Bucketed `_sweep`: per degree-class rectangle, blocks gathered at the
    class's own lane width."""
    n_colors = params.n_colors
    stars, taboos, logq = [], [], jnp.float32(0)
    for s in bell.slices:
        h = s.h_pad
        blk = block if h % block == 0 else 128
        cur_s = _slice_vec(colors, s.start, h)
        tb_s = _slice_vec(taboo, s.start, h)
        u_s = _slice_vec(unif, s.start, h)
        real_s = jnp.arange(h, dtype=jnp.int32) < jnp.int32(s.n_real)

        def block_fn(xs):
            neigh_blk, cur_blk, taboo_blk, unif_blk, real_blk = xs
            nc = neighbor_colors(neigh_blk, colors)
            occ = occupancy_matrix(nc, n_colors)
            q = _proposal_q(cur_blk, occ, params, p_eff, eps=eps)
            chosen = _sample_cdf(q, unif_blk)
            qstar = jnp.take_along_axis(q, chosen[:, None], axis=1)[:, 0]
            taboo_active = taboo_blk > 0
            keep_prob = jnp.float32(1.0 - (n_colors - 1) * params.epsilon)
            chosen = jnp.where(taboo_active, cur_blk, chosen)
            qstar = jnp.where(taboo_active, keep_prob, qstar)
            new_taboo = jnp.where(
                taboo_active,
                taboo_blk - 1,
                jnp.where(
                    chosen == cur_blk,
                    jnp.int32(params.taboo_iterations),
                    0,
                ),
            )
            chosen = jnp.where(real_blk, chosen, cur_blk)
            qstar = jnp.where(real_blk, qstar, 1.0)
            return chosen, new_taboo, jnp.sum(
                jnp.log(jnp.maximum(qstar, 1e-30))
            )

        star_b, taboo_b, logq_b = _map_blocks(
            block_fn, h // blk, blk, s.neighbors, cur_s, tb_s, u_s, real_s
        )
        stars.append(star_b.reshape(h))
        taboos.append(taboo_b.reshape(h))
        logq = logq + jnp.sum(logq_b)
    return jnp.concatenate(stars), jnp.concatenate(taboos), logq


def _sweep_any(ell, params, block, colors, taboo, unif, p_eff, eps=None):
    if _is_bucketed(ell):
        return _sweep_bucketed(
            ell, params, block, colors, taboo, unif, p_eff, eps
        )
    return _sweep(ell, params, block, colors, taboo, unif, p_eff, eps)


def _reverse_logq(
    ell: EllGraph,
    params: MCMCParams,
    block: int,
    colors: jnp.ndarray,
    star: jnp.ndarray,
):
    """Σ log q(old | star) for the Metropolis–Hastings ratio — the
    vectorized ``lookOldColoring`` (coloringMCMC_standard.cu:88-135; the
    reference defines the reverse probability with the STANDARD formula for
    every variant, reproduced here)."""
    n_pad = ell.n_pad
    n_blocks = n_pad // block
    n_colors = params.n_colors
    eps = jnp.float32(params.epsilon)
    node_ids = jnp.arange(n_pad, dtype=jnp.int32)

    def block_fn(xs):
        neigh_blk, cur_blk, star_blk, real_blk = xs
        nc = neighbor_colors(neigh_blk, star)
        occ = occupancy_matrix(nc, n_colors)
        zn = jnp.sum(occ, axis=1, dtype=jnp.int32)
        zp = jnp.int32(n_colors) - zn
        occ_star = jnp.take_along_axis(occ, star_blk[:, None], axis=1)[:, 0]
        occ_cur = jnp.take_along_axis(occ, cur_blk[:, None], axis=1)[:, 0]
        move_q = jnp.where(
            occ_cur,
            eps,
            (1.0 - eps * zn.astype(jnp.float32))
            / jnp.maximum(zp, 1).astype(jnp.float32),
        )
        keep_q = jnp.where(
            star_blk == cur_blk, 1.0 - (n_colors - 1) * eps, eps
        )
        q_old = jnp.where(occ_star, move_q, keep_q)
        q_old = jnp.where(zp == 0, 1.0, q_old)
        q_old = jnp.where(real_blk, q_old, 1.0)
        return jnp.sum(jnp.log(jnp.maximum(q_old, 1e-30)))

    logq_b = _map_blocks(
        block_fn,
        n_blocks,
        block,
        ell.neighbors,
        colors,
        star,
        node_ids < jnp.int32(ell.n_nodes),
    )
    return jnp.sum(logq_b)


def _reverse_logq_bucketed(
    bell,
    params: MCMCParams,
    block: int,
    colors: jnp.ndarray,
    star: jnp.ndarray,
):
    """Bucketed `_reverse_logq` (lookOldColoring): occupancy of the STAR
    coloring per degree-class rectangle."""
    n_colors = params.n_colors
    eps = jnp.float32(params.epsilon)
    total = jnp.float32(0)
    for s in bell.slices:
        h = s.h_pad
        blk = block if h % block == 0 else 128
        cur_s = _slice_vec(colors, s.start, h)
        star_s = _slice_vec(star, s.start, h)
        real_s = jnp.arange(h, dtype=jnp.int32) < jnp.int32(s.n_real)

        def block_fn(xs):
            neigh_blk, cur_blk, star_blk, real_blk = xs
            nc = neighbor_colors(neigh_blk, star)
            occ = occupancy_matrix(nc, n_colors)
            zn = jnp.sum(occ, axis=1, dtype=jnp.int32)
            zp = jnp.int32(n_colors) - zn
            occ_star = jnp.take_along_axis(
                occ, star_blk[:, None], axis=1
            )[:, 0]
            occ_cur = jnp.take_along_axis(
                occ, cur_blk[:, None], axis=1
            )[:, 0]
            move_q = jnp.where(
                occ_cur,
                eps,
                (1.0 - eps * zn.astype(jnp.float32))
                / jnp.maximum(zp, 1).astype(jnp.float32),
            )
            keep_q = jnp.where(
                star_blk == cur_blk, 1.0 - (n_colors - 1) * eps, eps
            )
            q_old = jnp.where(occ_star, move_q, keep_q)
            q_old = jnp.where(zp == 0, 1.0, q_old)
            q_old = jnp.where(real_blk, q_old, 1.0)
            return jnp.sum(jnp.log(jnp.maximum(q_old, 1e-30)))

        logq_b = _map_blocks(
            block_fn,
            h // blk,
            blk,
            s.neighbors,
            jnp.clip(cur_s, 0, n_colors - 1),
            jnp.clip(star_s, 0, n_colors - 1),
            real_s,
        )
        total = total + jnp.sum(logq_b)
    return total


def _reverse_logq_any(ell, params, block, colors, star):
    if _is_bucketed(ell):
        return _reverse_logq_bucketed(ell, params, block, colors, star)
    return _reverse_logq(ell, params, block, colors, star)


def _tailcut_init(ell, colors, *, params: MCMCParams):
    """Rank-space transform of the tailcut epilogue: colors are relabeled
    once by ascending class size (the reference's orderedIndex sort,
    coloringMCMC_main.cu:275-279), so "first free color in
    ascending-histogram order" becomes a plain smallest-index first-fit.
    Returns (colors_r, ordered); `_tailcut_finish` maps back."""
    n_colors = params.n_colors
    hist = color_histogram(colors, n_colors, ell.node_mask)
    ordered = jnp.argsort(hist).astype(jnp.int32)  # ascending class size
    rank = jnp.zeros((n_colors,), jnp.int32).at[ordered].set(
        jnp.arange(n_colors, dtype=jnp.int32)
    )
    rank_ext = jnp.concatenate([rank, jnp.full((1,), n_colors, jnp.int32)])
    colors_r = jnp.take(rank_ext, jnp.clip(colors, 0, n_colors), axis=0)
    colors_r = jnp.where(ell.node_mask, colors_r, jnp.int32(n_colors))
    return colors_r, ordered


def _tailcut_finish(ell, colors_r, ordered, *, params: MCMCParams):
    """Map rank-space colors back through the class-size ordering."""
    n_colors = params.n_colors
    ordered_ext = jnp.concatenate(
        [ordered, jnp.full((1,), n_colors, jnp.int32)]
    )
    colors_out = jnp.take(
        ordered_ext, jnp.clip(colors_r, 0, n_colors), axis=0
    )
    return jnp.where(ell.node_mask, colors_out, jnp.int32(n_colors))


def _tailcut_body_flat(ell, key, *, params: MCMCParams, block: int):
    """Body closure of one flat-layout tailcut round (intended semantics
    of coloringMCMC_utils.cu:73-101 / the buggy CPU loop, SURVEY §9.1).
    Each round recolors an *independent set* of movable conflicting
    vertices (no lower-id movable flagged neighbor).  Vertices with no
    free color keep theirs (the reference loops forever here,
    _utils.cu:93-99); if a round makes no progress the conflicting
    vertices are randomly recolored — the reference's own dead-code stall
    escape, unlock_stall (coloringMCMC_CPUutils.cpp:49-67)."""
    n_pad, d_pad = ell.neighbors.shape
    n_colors = params.n_colors
    node_ids = jnp.arange(n_pad, dtype=jnp.int32)
    # gathers run per row super-block: the monolithic round holds 3 full
    # [n_pad, d_pad] temporaries
    sb = _fused_super_block(n_pad, d_pad)

    def first_free(nc_r):
        rows = nc_r.shape[0]
        blk = min(block, rows)

        def block_fn(xs):
            (nc_blk,) = xs
            occ = occupancy_matrix(nc_blk, n_colors)
            found = jnp.any(~occ, axis=1)
            k = jnp.argmax(~occ, axis=1).astype(jnp.int32)
            return jnp.where(found, k, -1)

        out = _map_blocks(block_fn, rows // blk, blk, nc_r)
        return out.reshape(rows)

    def body(carry):
        cols_r, conf, rounds, _ = carry

        def sb_conf(xs):
            neigh_sb, own_sb, ids_sb = xs
            nc_sb = neighbor_colors(neigh_sb, cols_r)
            same = (nc_sb == own_sb[:, None]) & (
                neigh_sb > ids_sb[:, None]
            )
            conf_sb = jnp.sum(same, dtype=jnp.int32)
            flags_sb = jnp.any(nc_sb == own_sb[:, None], axis=1)
            cand_sb = first_free(nc_sb)
            return conf_sb, flags_sb, cand_sb

        if sb == n_pad:
            conf, flags, cand_r = sb_conf((ell.neighbors, cols_r, node_ids))
        else:
            conf_b, flags_b, cand_b = _map_blocks(
                sb_conf, n_pad // sb, sb, ell.neighbors, cols_r, node_ids
            )
            conf = jnp.sum(conf_b)
            flags = flags_b.reshape(n_pad)
            cand_r = cand_b.reshape(n_pad)
        flags = flags & ell.node_mask
        cand_r = jnp.where(ell.node_mask, cand_r, -1)
        movable = flags & (cand_r >= 0)
        movable_ext = jnp.concatenate(
            [movable, jnp.zeros((1,), jnp.bool_)]
        )

        def sb_lower(xs):
            neigh_sb, ids_sb = xs
            return jnp.any(
                jnp.take(movable_ext, neigh_sb, axis=0)
                & (neigh_sb < ids_sb[:, None]),
                axis=1,
            )

        if sb == n_pad:
            lower_movable = sb_lower((ell.neighbors, node_ids))
        else:
            lower_movable = _map_blocks(
                sb_lower, n_pad // sb, sb, ell.neighbors, node_ids
            ).reshape(n_pad)
        active = movable & ~lower_movable
        stalled = (conf > 0) & ~jnp.any(active)
        rnd = jax.random.randint(
            jax.random.fold_in(key, rounds),
            (n_pad,),
            0,
            n_colors,
            dtype=jnp.int32,
        )
        new_r = jnp.where(
            active, cand_r, jnp.where(stalled & flags, rnd, cols_r)
        )
        return new_r, conf, rounds + 1, conf == 0

    return body


def _tailcut_body_bucketed(bell, key, *, params: MCMCParams, block: int):
    """Bucketed `_tailcut_body_flat`: the per-round occupancy/first-fit
    and the movable-neighbor check run per degree-class rectangle."""
    n_colors = params.n_colors

    def first_free_slice(nc_r, blk):
        h = nc_r.shape[0]

        def block_fn(xs):
            (nc_blk,) = xs
            occ = occupancy_matrix(nc_blk, n_colors)
            found = jnp.any(~occ, axis=1)
            k = jnp.argmax(~occ, axis=1).astype(jnp.int32)
            return jnp.where(found, k, -1)

        out = _map_blocks(block_fn, h // blk, blk, nc_r)
        return out.reshape(h)

    def body(carry):
        cols_r, conf, rounds, _ = carry
        cols_ext = jnp.concatenate(
            [cols_r, jnp.full((1,), -1, jnp.int32)]
        )
        conf = jnp.int32(0)
        flags_p, cand_p = [], []
        for s in bell.slices:
            nc_r = jnp.take(cols_ext, s.neighbors, axis=0)
            own = _slice_vec(cols_r, s.start, s.h_pad)
            gids = s.start + jnp.arange(s.h_pad, dtype=jnp.int32)
            conf = conf + jnp.sum(
                (nc_r == own[:, None]) & (s.neighbors > gids[:, None]),
                dtype=jnp.int32,
            )
            real_s = jnp.arange(s.h_pad, dtype=jnp.int32) < jnp.int32(
                s.n_real
            )
            flags_p.append(
                jnp.any(nc_r == own[:, None], axis=1) & real_s
            )
            blk = block if s.h_pad % block == 0 else 128
            cand_p.append(first_free_slice(nc_r, blk))
        flags = jnp.concatenate(flags_p)
        cand_r = jnp.concatenate(cand_p)
        movable = flags & (cand_r >= 0)
        movable_ext = jnp.concatenate(
            [movable, jnp.zeros((1,), jnp.bool_)]
        )
        lower_p = []
        for s in bell.slices:
            gids = s.start + jnp.arange(s.h_pad, dtype=jnp.int32)
            lower_p.append(
                jnp.any(
                    jnp.take(movable_ext, s.neighbors, axis=0)
                    & (s.neighbors < gids[:, None]),
                    axis=1,
                )
            )
        lower_movable = jnp.concatenate(lower_p)
        active = movable & ~lower_movable
        stalled = (conf > 0) & ~jnp.any(active)
        rnd = jax.random.randint(
            jax.random.fold_in(key, rounds),
            (bell.n_pad,),
            0,
            n_colors,
            dtype=jnp.int32,
        )
        new_r = jnp.where(
            active, cand_r, jnp.where(stalled & flags, rnd, cols_r)
        )
        return new_r, conf, rounds + 1, conf == 0

    return body


def _tailcut_max_rounds(ell) -> int:
    return ell.n_nodes + 1000


def _tailcut_segment(ell, carry, key, budget, *, params, block):
    """Advance the tailcut loop by at most ``budget`` rounds (traced; see
    utils/segmented.py).  ``carry`` = (colors_r, conflicts, rounds, done)
    in rank space — `_tailcut_init` / `_tailcut_finish` bracket the
    segments."""
    limit = jnp.minimum(
        carry[2] + budget, jnp.int32(_tailcut_max_rounds(ell))
    )
    make = _tailcut_body_bucketed if _is_bucketed(ell) else _tailcut_body_flat
    body = make(ell, key, params=params, block=block)

    def cond(carry):
        _, _, rounds, done = carry
        return (~done) & (rounds < limit)

    return jax.lax.while_loop(cond, body, carry)


def _tailcut_any(ell, colors, conflicts, key, *, params, block):
    """One-shot tailcut (init → full loop → finish) for in-jit callers.
    Host drivers use the init/segment/finish pieces directly."""
    colors_r, ordered = _tailcut_init(ell, colors, params=params)
    carry = (colors_r, conflicts, jnp.int32(0), jnp.bool_(False))
    carry = _tailcut_segment(
        ell,
        carry,
        key,
        jnp.int32(_tailcut_max_rounds(ell)),
        params=params,
        block=block,
    )
    colors_r, conflicts, rounds, _done = carry
    colors_out = _tailcut_finish(ell, colors_r, ordered, params=params)
    return colors_out, conflicts, rounds


def _run_chain(
    ell: EllGraph,
    key,
    *,
    params: MCMCParams,
    block: int,
):
    """Full chain: init → while-loop of sweeps → optional tailcut.
    Mirrors ColoringMCMC::run (coloringMCMC_main.cu:100-290) with zero host
    round-trips."""
    carry = _chain_init(ell, key, params=params, fused=False)
    carry = _chain_segment(
        ell,
        carry,
        jnp.int32(params.max_iterations),
        params=params,
        block=block,
    )
    colors, taboo, key, rip, conflicts, trace, _done = carry
    if params.tailcut:
        key, k_tc = jax.random.split(key)
        colors, conflicts, tc_rounds = _tailcut_any(
            ell, colors, conflicts, k_tc, params=params, block=block
        )
    else:
        tc_rounds = jnp.int32(0)
    return colors, rip, conflicts, trace, tc_rounds


def _chain_init(ell, key, *, params: MCMCParams, fused: bool):
    """Initial chain carry.  One carry layout serves both sweep
    backends: (colors, taboo, key, rip, conflicts, trace, done).

    For the generic (xla) loop, ``conflicts`` holds the count of the
    CURRENT coloring and trace[0] records it; for the fused (matmul)
    loop ``conflicts`` is the sentinel the first in-loop count
    overwrites and ``done`` is the do-while exit flag
    (coloringMCMC_main.cu:160-269)."""
    n_pad = ell.n_pad
    key, k_init = jax.random.split(key)
    colors0 = _init_colors(ell, params, k_init)
    taboo0 = jnp.zeros((n_pad,), jnp.int32)
    trace0 = jnp.full((params.max_iterations + 1,), -1, jnp.int32)
    if fused:
        conflicts0 = jnp.int32(2**30)
    else:
        conflicts0 = _conflict_edges_any(ell, colors0)
        trace0 = trace0.at[0].set(conflicts0)
    return (
        colors0,
        taboo0,
        key,
        jnp.int32(0),
        conflicts0,
        trace0,
        jnp.bool_(False),
    )


def _free_color_stats(ell, colors, *, n_colors: int, block: int):
    """(min, max, avg) free colors over real vertices of the CURRENT
    coloring — the device-chain rendition of the reference's verbose
    getStatsFreeColors (coloringMCMC_prints.cu:117-131): freeColors[i] =
    nCol − |{colors of N(i)}|.  Computed blockwise from the ELL (one
    gather sweep), host-driven at segment boundaries under TRACE — the
    in-loop carry stays 7-tuple and TRACE-off runs pay nothing."""
    n_pad, d_pad = ell.neighbors.shape
    n_blocks = n_pad // block
    # sentinel neighbor id n_pad gathers the extra color n_colors,
    # which lands in the ignored overflow column of the occupancy map
    ext = jnp.concatenate(
        [colors, jnp.full((1,), n_colors, jnp.int32)]
    )

    def blk(nb):
        ncol = ext[jnp.minimum(nb, n_pad)]
        occ = (
            jnp.zeros((block, n_colors + 1), jnp.bool_)
            .at[
                jnp.arange(block, dtype=jnp.int32)[:, None],
                jnp.minimum(ncol, n_colors),
            ]
            .set(True)
        )
        return n_colors - jnp.sum(
            occ[:, :n_colors], axis=1, dtype=jnp.int32
        )

    free = jax.lax.map(
        blk, ell.neighbors.reshape(n_blocks, block, d_pad)
    ).reshape(n_pad)
    mask = ell.node_mask
    mn = jnp.min(jnp.where(mask, free, jnp.int32(n_colors + 1)))
    mx = jnp.max(jnp.where(mask, free, jnp.int32(-1)))
    avg = jnp.sum(jnp.where(mask, free, 0)) / jnp.maximum(
        ell.n_nodes, 1
    )
    return mn, mx, avg


def _chain_segment(
    ell,
    carry,
    budget,
    *,
    params: MCMCParams,
    block: int,
):
    """Advance the generic chain loop by at most ``budget`` iterations
    (traced — one compiled program serves every segment; see
    utils/segmented.py).  The body
    is the monolithic loop of `_run_chain`, so a segmented run is
    bit-equal to a single execution."""
    n_pad = ell.n_pad
    z = jnp.int32(params.tailcut_threshold(ell.n_nodes))
    limit = jnp.minimum(
        carry[3] + budget, jnp.int32(params.max_iterations)
    )

    def cond(carry):
        _, _, _, rip, conflicts, _, _ = carry
        return (conflicts > z) & (rip < limit)

    def body(carry):
        colors, taboo, key, rip, conflicts, trace, _done = carry
        key, k_u, k_acc = jax.random.split(key, 3)
        unif = jax.random.uniform(k_u, (n_pad,), dtype=jnp.float32)
        if _needs_histogram(params):
            hist = color_histogram(colors, params.n_colors, ell.node_mask)
        else:
            hist = None
        p_eff = _variant_distribution(params, hist, ell.n_nodes)
        star, new_taboo, logq_star = _sweep_any(
            ell, params, block, colors, taboo, unif, p_eff
        )
        conflicts_star = _conflict_edges_any(ell, star)
        if params.hastings:
            logq_old = _reverse_logq_any(ell, params, block, colors, star)
            # acceptance ratio exp(−λ·ΔConflicts + (p − pStar))
            # (coloringMCMC_main.cu:250-253; gated here, unlike the
            # reference where the swap is unconditional — SURVEY §9.2)
            log_ratio = (
                -jnp.float32(params.lambda_)
                * (conflicts_star - conflicts).astype(jnp.float32)
                + logq_old
                - logq_star
            )
            accept = (
                jnp.log(
                    jnp.maximum(
                        jax.random.uniform(k_acc, (), dtype=jnp.float32),
                        1e-30,
                    )
                )
                < log_ratio
            )
            colors_next = jnp.where(accept, star, colors)
            conflicts_next = jnp.where(accept, conflicts_star, conflicts)
        else:
            colors_next = star
            conflicts_next = conflicts_star
        rip = rip + 1
        trace = trace.at[rip].set(conflicts_next)
        return (
            colors_next,
            new_taboo,
            key,
            rip,
            conflicts_next,
            trace,
            conflicts_next <= z,
        )

    return jax.lax.while_loop(cond, body, carry)


def _sweep_matmul(
    ell: EllGraph,
    adj,
    params: MCMCParams,
    block: int,
    colors: jnp.ndarray,
    taboo: jnp.ndarray,
    unif: jnp.ndarray,
    p_eff: jnp.ndarray | None,
    eps: jnp.ndarray | None = None,
):
    """One full proposal sweep with the neighbor color counts computed as
    ONE integer contraction ``NC = A @ onehot(colors)`` (ops/dense_adj.py)
    instead of the neighbor-color gather.  Returns
    (star, new_taboo, Σ log qStar, conflict_edges(colors), NC) —
    distribution-identical to `_sweep` given the same uniforms (same
    occupancy, same q, same inverse-CDF walk).

    Counterpart of the reference's selectStarColoringBalanceDynamic +
    conflictCounter pair (coloringMCMC_balance.cu:79-143,
    _utils.cu:103-119) with the per-thread neighbor scans re-expressed
    as a contraction."""
    from mcmc_colorer_tpu.ops.dense_adj import neighbor_color_counts

    n_pad = ell.n_pad
    n_colors = params.n_colors
    nc = neighbor_color_counts(adj, colors, n_colors, ell.node_mask)
    n_col_pad = nc.shape[1]
    p_eff_pad = None
    if p_eff is not None:
        p_eff_pad = jnp.zeros((n_col_pad,), jnp.float32).at[:n_colors].set(
            p_eff
        )
    n_blocks = n_pad // block
    node_ids = jnp.arange(n_pad, dtype=jnp.int32)

    def block_fn(xs):
        nc_blk, cur_blk, taboo_blk, unif_blk, real_blk = xs
        col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, n_col_pad), 1)
        # conflict edges touch each endpoint once: Σ_i NC[i, c_i] = 2E_conf
        conf2 = jnp.sum(
            jnp.where(col_ids == cur_blk[:, None], nc_blk, 0),
            dtype=jnp.int32,
        )
        occ = nc_blk > 0
        q = _proposal_q(
            cur_blk, occ, params, p_eff_pad, eps=eps, n_colors=n_colors
        )
        chosen = _sample_cdf(q, unif_blk, n_colors=n_colors)
        qstar = jnp.take_along_axis(q, chosen[:, None], axis=1)[:, 0]
        taboo_active = taboo_blk > 0
        eps_s = jnp.float32(params.epsilon) if eps is None else eps
        keep_prob = 1.0 - (n_colors - 1) * eps_s
        chosen = jnp.where(taboo_active, cur_blk, chosen)
        qstar = jnp.where(taboo_active, keep_prob, qstar)
        new_taboo = jnp.where(
            taboo_active,
            taboo_blk - 1,
            jnp.where(
                chosen == cur_blk, jnp.int32(params.taboo_iterations), 0
            ),
        )
        chosen = jnp.where(real_blk, chosen, cur_blk)
        qstar = jnp.where(real_blk, qstar, 1.0)
        logq = jnp.sum(jnp.log(jnp.maximum(qstar, 1e-30)))
        return chosen, new_taboo, logq, conf2

    star_b, taboo_b, logq_b, conf_b = _map_blocks(
        block_fn,
        n_blocks,
        block,
        nc,
        colors,
        taboo,
        unif,
        node_ids < jnp.int32(ell.n_nodes),
    )
    return (
        star_b.reshape(n_pad),
        taboo_b.reshape(n_pad),
        jnp.sum(logq_b),
        jnp.sum(conf_b) // 2,
        nc,
    )


def _reverse_logq_matmul(
    ell: EllGraph,
    nc_star,  # [n_pad, n_col_pad] counts of the STAR coloring
    params: MCMCParams,
    block: int,
    colors: jnp.ndarray,
    star: jnp.ndarray,
):
    """`_reverse_logq` fed by a precomputed NC(star) matrix (no gather)."""
    n_pad = ell.n_pad
    n_colors = params.n_colors
    n_col_pad = nc_star.shape[1]
    eps = jnp.float32(params.epsilon)
    node_ids = jnp.arange(n_pad, dtype=jnp.int32)

    def block_fn(xs):
        nc_blk, cur_blk, star_blk, real_blk = xs
        col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, n_col_pad), 1)
        occ = nc_blk > 0
        col_valid = col_ids < n_colors
        zn = jnp.sum(occ & col_valid, axis=1, dtype=jnp.int32)
        zp = jnp.int32(n_colors) - zn
        occ_star = (
            jnp.sum(
                jnp.where(col_ids == star_blk[:, None], nc_blk, 0),
                axis=1,
                dtype=jnp.int32,
            )
            > 0
        )
        occ_cur = (
            jnp.sum(
                jnp.where(col_ids == cur_blk[:, None], nc_blk, 0),
                axis=1,
                dtype=jnp.int32,
            )
            > 0
        )
        move_q = jnp.where(
            occ_cur,
            eps,
            (1.0 - eps * zn.astype(jnp.float32))
            / jnp.maximum(zp, 1).astype(jnp.float32),
        )
        keep_q = jnp.where(
            star_blk == cur_blk, 1.0 - (n_colors - 1) * eps, eps
        )
        q_old = jnp.where(occ_star, move_q, keep_q)
        q_old = jnp.where(zp == 0, 1.0, q_old)
        q_old = jnp.where(real_blk, q_old, 1.0)
        return jnp.sum(jnp.log(jnp.maximum(q_old, 1e-30)))

    logq_b = _map_blocks(
        block_fn,
        ell.n_pad // block,
        block,
        nc_star,
        colors,
        star,
        node_ids < jnp.int32(ell.n_nodes),
    )
    return jnp.sum(logq_b)


def _run_chain_matmul(
    ell: EllGraph, adj, key, *, params: MCMCParams, block: int
):
    """Chain driver for the adjacency-contraction backend.  Non-Hastings
    iterations cost exactly ONE matmul (the conflict count of the
    current coloring reads the same NC as the proposal — fused-path
    semantics, coloringMCMC_main.cu:160-269); Hastings adds a second
    matmul for the star coloring's occupancy/conflicts."""
    carry = _chain_init(ell, key, params=params, fused=True)
    carry = _chain_segment_matmul(
        ell,
        adj,
        carry,
        jnp.int32(params.max_iterations),
        params=params,
        block=block,
    )
    colors, taboo, key, rip, _conf_last, trace, _done = carry
    conflicts = _chain_final_conflicts(ell, carry)
    if params.tailcut:
        key, k_tc = jax.random.split(key)
        colors, conflicts, tc_rounds = _tailcut_any(
            ell, colors, conflicts, k_tc, params=params, block=block
        )
    else:
        tc_rounds = jnp.int32(0)
    return colors, rip, conflicts, trace, tc_rounds


def _chain_segment_matmul(
    ell: EllGraph, adj, carry, budget, *, params: MCMCParams, block: int
):
    """Budgeted segment of the dense-adjacency do-while (see
    `_chain_segment`; ``budget`` is traced)."""
    from mcmc_colorer_tpu.ops.dense_adj import neighbor_color_counts

    n_pad = ell.n_pad
    z = jnp.int32(params.tailcut_threshold(ell.n_nodes))
    limit = jnp.minimum(
        carry[3] + budget, jnp.int32(params.max_iterations)
    )

    def cond(carry):
        _, _, _, rip, _, _, done = carry
        return (~done) & (rip < limit)

    def body(carry):
        colors, taboo, key, rip, conf_last, trace, done = carry
        if params.hastings:
            key, k_u, k_acc = jax.random.split(key, 3)
        else:
            key, k_u = jax.random.split(key)
        unif = jax.random.uniform(k_u, (n_pad,), dtype=jnp.float32)
        if _needs_histogram(params):
            hist = color_histogram(colors, params.n_colors, ell.node_mask)
        else:
            hist = None
        p_eff = _variant_distribution(params, hist, ell.n_nodes)
        star, new_taboo, logq_star, conf_cur, _nc = _sweep_matmul(
            ell, adj, params, block, colors, taboo, unif, p_eff
        )
        done_now = conf_cur <= z
        trace = trace.at[rip].set(conf_cur)
        if params.hastings:
            nc_star = neighbor_color_counts(
                adj, star, params.n_colors, ell.node_mask
            )
            col_ids = jnp.arange(nc_star.shape[1], dtype=jnp.int32)
            conf_star = (
                jnp.sum(
                    jnp.where(
                        col_ids[None, :] == star[:, None], nc_star, 0
                    ),
                    dtype=jnp.int32,
                )
                // 2
            )
            logq_old = _reverse_logq_matmul(
                ell, nc_star, params, block, colors, star
            )
            log_ratio = (
                -jnp.float32(params.lambda_)
                * (conf_star - conf_cur).astype(jnp.float32)
                + logq_old
                - logq_star
            )
            accept = (
                jnp.log(
                    jnp.maximum(
                        jax.random.uniform(k_acc, (), dtype=jnp.float32),
                        1e-30,
                    )
                )
                < log_ratio
            )
            step = accept & ~done_now
        else:
            step = ~done_now
        colors = jnp.where(step, star, colors)
        taboo = jnp.where(done_now, taboo, new_taboo)
        rip = rip + jnp.where(done_now, 0, 1)
        return colors, taboo, key, rip, conf_cur, trace, done_now

    return jax.lax.while_loop(cond, body, carry)


def _chain_final_conflicts(ell, carry):
    """Conflict count of the final coloring of a fused/matmul do-while.
    When the loop ended converged, the in-loop count (conf_last) describes
    it; when it ended at the iteration cap, conf_last describes the
    pre-swap coloring and the final one must be measured."""
    colors, _, _, _, conf_last, _, done = carry
    return jax.lax.cond(
        done,
        lambda: conf_last,
        lambda: _conflict_edges_any(ell, colors),
    )
