"""Luby-inspired greedy MIS colorer.

Re-design of the reference's ``ColoringLuby`` (coloringLuby.cu) /
``run_fast`` (coloringLubyFast.cu): peel off maximal independent sets, one
per color.  The reference's fast variant drives its kernels from a parent
CUDA kernel via dynamic parallelism to avoid host round-trips
(coloringLubyFast.cu:51-107); here the entire nested loop lives in one
`jax.jit` as two nested `lax.while_loop`s — the device-side analogue
(SURVEY §2.3 item 4).

Conflict resolution among coin-flip-selected candidates is the
deterministic rendition of check_conflicts_k (coloringLuby.cu:269-276):
a selected node survives iff its degree exceeds that of every selected
neighbor (the reference's benign-racy rule removes a node when
``deg_i <= deg_j``, so the higher-degree endpoint survives and degree ties
eliminate both — reproduced here without the race, SURVEY §6
race-detection note).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_colorer_tpu.graph.container import EllGraph, Graph
from mcmc_colorer_tpu.models.base import Coloring
from mcmc_colorer_tpu.utils import rng as rngu


class LubyColorer:
    def __init__(
        self,
        graph: Graph,
        active: bool = False,
        min_bucket: int = 128,
        bucket_factor: int = 4,
        layout: str = "flat",
        backend: str = "auto",
        resident_spec: tuple | None = None,
    ) -> None:
        """``active=True`` runs the frontier variant: every coin-flip /
        survival round gathers only the rows of the remaining *candidates*
        (which shrink within each MIS round and across colors) instead of
        all n rows — the Luby rendition of the active-set design
        (models/mcmc_active.py; PERF.md roadmap).  It also avoids the full
        loop's [n_pad, d_pad] precomputed neighbor-degree matrix (4·n·d
        bytes — prohibitive at n=1e6).

        ``layout='bucketed'``: degree-bucketed rectangles — the
        device-resident loop gathers Σ h_b·d_b ≈ 2m elements per round
        instead of n·maxDeg (required on skewed graphs at scale).  The MIS
        rule is degree-based, so the relabeling does not change the
        distribution of produced colorings.  Composes with ``active=True``
        (frontier rows gathered per slice, ops/neighbor.py:take_rows)."""
        """``backend``: 'xla' (per-edge neighbor gathers; also what 'auto'
        selects) or 'matmul' (neighbor color counts as one contraction of
        the adjacency, dense where it fits the device, else bit-packed;
        flat layout, full loop only)."""
        import numpy as _np

        self.active = active
        self.layout = layout
        if resident_spec is not None:
            # hash-defined G(n, p): the device materialises the packed
            # adjacency itself (ops/hashgen.py) and the matmul loop is
            # fully NC-native (it reads ell only for shapes/masks), so
            # the ELL rectangle never ships.  Full flat matmul loop only.
            if graph is not None:
                raise ValueError("pass graph=None with resident_spec")
            if active or layout != "flat":
                raise ValueError(
                    "resident Luby runs the flat full matmul loop only "
                    "(the frontier/bucketed variants gather neighbor "
                    "rows the resident graph never materialises)"
                )
            if backend not in ("auto", "matmul"):
                raise ValueError(
                    f"resident_spec implies backend='matmul'; got "
                    f"{backend!r}"
                )
            from functools import partial

            from mcmc_colorer_tpu.models.mcmc_resident import (
                _StatsShim,
                _round_up,
            )
            from mcmc_colorer_tpu.ops.dense_adj import require_packed_fits
            from mcmc_colorer_tpu.ops.hashgen import (
                degrees_from_packed,
                er_packed_on_device_cached,
            )

            rn, rp, rseed = resident_spec
            self.backend = "matmul"
            n_pad = _round_up(rn, 2048)
            require_packed_fits(n_pad)
            self._adj = er_packed_on_device_cached(rn, rp, rseed, n_pad)
            degrees_dev = degrees_from_packed(self._adj)
            host_degrees = np.asarray(degrees_dev)[:rn]
            max_degree = int(host_degrees.max()) if rn else 0
            n_edges = int(host_degrees.astype(np.int64).sum() // 2)
            self.graph = _StatsShim(
                rn, n_edges, host_degrees, max_degree,
                f"er_hash_{rn}_{rp}",
            )
            self.resident_spec = resident_spec
            self.ell = EllGraph(
                neighbors=np.full((n_pad, 8), n_pad, np.int32),
                degrees=degrees_dev,
                n_nodes=rn,
                n_edges=n_edges,
                max_degree=max_degree,
            )
            self._perm = None
            uniq = _np.unique(host_degrees)
            rank = _np.searchsorted(
                uniq, _np.asarray(degrees_dev)
            ).astype(_np.int32)
            self._rank_class = jnp.asarray(rank)
            seg5 = jax.jit(
                partial(_luby_segment_matmul, n_classes=int(uniq.size))
            )
            self._jit_segment = (
                lambda ell, c, b: seg5(
                    ell, self._adj, self._rank_class, c, b
                )
            )
            self._jit_init = jax.jit(_luby_init)
            self._jit_rounds = {}
            self._min_bucket = min_bucket
            self._bucket_factor = bucket_factor
            return
        self.graph = graph
        if backend == "auto":
            backend = "xla"
        if backend == "matmul" and (layout != "flat" or active):
            raise ValueError(
                "backend='matmul' serves the flat full loop only"
            )
        self.backend = backend
        if layout == "bucketed":
            g2, perm = graph.degree_relabel(descending=True)
            self._perm = perm
            self.ell = g2.to_ell_bucketed(block=128, min_lane=8)
            self._pos = self.ell.real_positions()
            self._jit_segment = jax.jit(_luby_segment_bucketed)
        elif layout == "flat":
            self._perm = None
            pad = 128 if (active or backend == "matmul") else 8
            self.ell = graph.to_ell(pad_nodes_to=pad)
            if backend == "matmul":
                from functools import partial

                from mcmc_colorer_tpu.ops.dense_adj import (
                    get_adjacency,
                    matmul_adjacency_kind,
                )

                uniq = _np.unique(_np.asarray(graph.degrees))
                rank = _np.searchsorted(
                    uniq, _np.asarray(self.ell.degrees)
                ).astype(_np.int32)
                self._rank_class = jnp.asarray(rank)
                # same layout rule as the MCMC backend, cached per graph
                kind = matmul_adjacency_kind(self.ell.n_pad)
                self._adj = get_adjacency(
                    graph, self.ell.n_pad, kind, self.ell
                )
                seg5 = jax.jit(
                    partial(
                        _luby_segment_matmul, n_classes=int(uniq.size)
                    )
                )
                self._jit_segment = (
                    lambda ell, c, b: seg5(
                        ell, self._adj, self._rank_class, c, b
                    )
                )
            else:
                self._jit_segment = jax.jit(_luby_segment)
        else:
            raise ValueError(f"unknown layout {layout!r}")
        self._jit_init = jax.jit(_luby_init)
        self._jit_rounds: dict[int, object] = {}
        self._min_bucket = min_bucket
        self._bucket_factor = bucket_factor

    def host_graph(self):
        """Resident specs only: host CSR of the same hash graph for
        validation/analysis."""
        if not hasattr(self, "resident_spec"):
            raise ValueError("host_graph() is for resident_spec colorers")
        from mcmc_colorer_tpu.ops.hashgen import hash_er_graph

        return hash_er_graph(*self.resident_spec, name=self.graph.name)

    def _round_fn(self, cap: int):
        if cap not in self._jit_rounds:
            self._jit_rounds[cap] = jax.jit(
                _luby_active_round, static_argnames=("cap",)
            )
        return self._jit_rounds[cap]

    def _run_active(self, key):
        from mcmc_colorer_tpu.models.mcmc_active import _buckets, pick_cap

        ell = self.ell
        n_pad = ell.n_pad
        caps = _buckets(n_pad, self._min_bucket, self._bucket_factor)
        colors = jnp.where(ell.node_mask, jnp.int32(-1), jnp.int32(0))
        uncolored = self.graph.n
        n_colors = 0
        while uncolored > 0:
            cands = (colors < 0) & ell.node_mask
            is_set = jnp.zeros((n_pad,), jnp.bool_)
            n_cand = uncolored
            while n_cand > 0:
                cap = pick_cap(caps, n_cand)
                key, k_r = jax.random.split(key)
                cands, is_set, n_c = self._round_fn(cap)(
                    ell, cands, is_set, k_r, cap=cap
                )
                n_cand = int(n_c)
            colors, n_unc = _commit_color(
                colors, is_set, jnp.int32(n_colors), ell.node_mask
            )
            uncolored = int(n_unc)
            n_colors += 1
        return colors, n_colors

    def run(self, seed: int, repetition: int = 0) -> Coloring:
        from mcmc_colorer_tpu.utils.segmented import drive_segments

        key = rngu.for_repetition(rngu.root_key(seed), repetition)
        t0 = time.perf_counter()
        if self.active:
            colors, n_colors = self._run_active(key)
        else:
            # host-segmented device loop (utils/segmented.py): bit-equal
            # to one execution
            carry = drive_segments(
                lambda c, b: self._jit_segment(self.ell, c, jnp.int32(b)),
                self._jit_init(self.ell, key),
                lambda c: (int(c[5]), bool(c[6])),
            )
            colors, n_colors = carry[0], carry[1]
        if self._perm is not None:
            padded = np.asarray(jax.device_get(colors))
            colors = np.empty(self.graph.n, np.int32)
            colors[self._perm] = padded[self._pos]
        else:
            colors = np.asarray(jax.device_get(colors))[: self.graph.n]
        dur = (time.perf_counter() - t0) * 1e3
        n_colors = int(n_colors)
        return Coloring(
            colors=colors,
            n_colors=n_colors,
            iterations=n_colors,
            converged=True,
            duration_ms=dur,
        )


@jax.jit
def _commit_color(colors, is_set, color_idx, node_mask):
    """Assign the accumulated MIS its color
    (add_color_and_check_uncolored_k, coloringLuby.cu:328-341)."""
    colors = jnp.where(is_set, color_idx, colors)
    return colors, jnp.sum(((colors < 0) & node_mask).astype(jnp.int32))


def _luby_active_round(ell: EllGraph, cands, is_set, key, *, cap: int):
    """One coin-flip/survival/prune step over the ≤``cap`` candidates.

    Matches the full loop's semantics exactly (set_initial_distr_k coin
    flip, deterministic higher-degree-wins survival of check_conflicts_k,
    update_eligible_k pruning — coloringLuby.cu:232-312) but gathers only
    the frontier's ELL rows.  Selection flag and degree of each neighbor
    travel in ONE packed int32 gather (deg·2 | selected) instead of two.
    """
    n_pad = ell.n_pad
    (ids,) = jnp.nonzero(cands, size=cap, fill_value=n_pad)
    valid = ids < n_pad
    ids_c = jnp.minimum(ids, n_pad - 1)
    u = jax.random.uniform(key, (cap,), dtype=jnp.float32)
    sel = valid & (u < 0.5)
    sel_full = (
        jnp.zeros((n_pad,), jnp.bool_).at[ids].set(sel, mode="drop")
    )
    from mcmc_colorer_tpu.ops.neighbor import take_rows

    rows = take_rows(ell, ids, valid)
    packed = jax.lax.shift_left(ell.degrees, 1) | sel_full.astype(jnp.int32)
    packed_ext = jnp.concatenate([packed, jnp.zeros((1,), jnp.int32)])
    nb = jnp.take(packed_ext, rows, axis=0)
    neigh_sel = (nb & 1) == 1
    neigh_deg = jax.lax.shift_right_logical(nb, 1)
    deg = jnp.take(ell.degrees, ids_c)
    # survive iff deg_i > deg_j for every selected neighbor j (ties kill both)
    beaten = jnp.any(neigh_sel & (neigh_deg >= deg[:, None]), axis=1)
    surv = sel & ~beaten
    surv_full = (
        jnp.zeros((n_pad,), jnp.bool_).at[ids].set(surv, mode="drop")
    )
    is_set = is_set | surv_full
    cands = cands & ~surv_full
    # neighbors of survivors leave the candidate set
    drop_rows = jnp.where(surv[:, None], rows, jnp.int32(n_pad))
    cands = cands.at[drop_rows.reshape(-1)].set(False, mode="drop")
    return cands, is_set, jnp.sum(cands.astype(jnp.int32))


def _luby_init(ell: EllGraph, key):
    """Initial carry of the flattened Luby loop: (colors, n_colors, key,
    cands, is_set, rounds, done).  ``cands`` starts as all uncolored
    vertices (prune_eligible, coloringLuby.cu:223-228)."""
    real = ell.node_mask
    colors0 = jnp.where(real, jnp.int32(-1), jnp.int32(0))
    return (
        colors0,
        jnp.int32(0),
        key,
        real,  # cands0 = (colors0 < 0) & real
        jnp.zeros((ell.n_pad,), jnp.bool_),
        jnp.int32(0),
        jnp.bool_(~jnp.any(real)),
    )


def _luby_segment(ell: EllGraph, carry, budget):
    """At most ``budget`` coin-flip rounds of the flattened Luby loop
    (budget is traced; see utils/segmented.py for why device loops are
    segmented).  The reference's nested structure — host loop per color,
    inner kernel loop per MIS round (coloringLuby.cu:83-176 /
    run_fast) — flattens to one loop whose body is a single coin-flip /
    survival / prune round; when the round empties the candidate set the
    accumulated MIS is committed as a color and the candidates reset, all
    inside the same body.  The round sequence (and so the RNG stream and
    the coloring) is identical to the nested form."""
    n_pad = ell.n_pad
    real = ell.node_mask
    deg_ext = jnp.concatenate([ell.degrees, jnp.zeros((1,), jnp.int32)])
    neigh_degs = jnp.take(deg_ext, ell.neighbors, axis=0)  # [n_pad, d_pad]
    degs = ell.degrees
    limit = carry[5] + budget

    def cond(carry):
        _, _, _, _, _, rounds, done = carry
        return (~done) & (rounds < limit)

    def body(carry):
        colors, n_colors, key, cands, is_set, rounds, done = carry
        key, ku = jax.random.split(key)
        u = jax.random.uniform(ku, (n_pad,), dtype=jnp.float32)
        sel = cands & (u < 0.5)  # set_initial_distr_k coin flip
        sel_ext = jnp.concatenate([sel, jnp.zeros((1,), jnp.bool_)])
        neigh_sel = jnp.take(sel_ext, ell.neighbors, axis=0)
        # survive iff deg_i > deg_j for every selected neighbor j
        beaten = jnp.any(neigh_sel & (neigh_degs >= degs[:, None]), axis=1)
        surv = sel & ~beaten
        is_set = is_set | surv  # update_eligible_k accumulate
        surv_ext = jnp.concatenate([surv, jnp.zeros((1,), jnp.bool_)])
        near_surv = jnp.any(
            jnp.take(surv_ext, ell.neighbors, axis=0), axis=1
        )
        cands = cands & ~surv & ~near_surv
        # MIS round done → commit the color, reset candidates
        # (add_color_and_check_uncolored_k, coloringLuby.cu:328-341)
        commit = ~jnp.any(cands)
        colors = jnp.where(commit & is_set, n_colors, colors)
        n_colors = n_colors + jnp.where(commit, 1, 0)
        uncolored = (colors < 0) & real
        cands = jnp.where(commit, uncolored, cands)
        is_set = jnp.where(commit, False, is_set)
        done = commit & ~jnp.any(uncolored)
        return colors, n_colors, key, cands, is_set, rounds + 1, done

    return jax.lax.while_loop(cond, body, carry)


def _luby_segment_matmul(
    ell: EllGraph,
    adj,            # [n_pad, n_pad] int8 dense adjacency (ops/dense_adj)
    rank_class,     # [n_pad] int32: index of each vertex's degree into the
                    # ascending unique-degree table
    carry,
    budget,
    *,
    n_classes: int,
):
    """`_luby_segment` with both neighbor inspections as contractions instead
    of per-edge gathers (the round-2 dense-adjacency formulation,
    ops/dense_adj.py).  Per round: (1) ``M = A @ onehot(rank_class |
    selected)`` counts each vertex's selected neighbors per degree class;
    a reverse-cumulative sum over the class axis at the vertex's own class
    yields "some selected neighbor has >= degree" — exactly
    check_conflicts_k's survival rule (coloringLuby.cu:269-276) including
    ties.  (2) ``A @ survivors`` marks neighbors of the accepted set.
    Same coin flips, same rule, bit-identical colorings to the gather
    path (tests/test_segmented.py)."""
    n_pad = ell.n_pad
    real = ell.node_mask
    limit = carry[5] + budget

    def cond(carry):
        _, _, _, _, _, rounds, done = carry
        return (~done) & (rounds < limit)

    def body(carry):
        colors, n_colors, key, cands, is_set, rounds, done = carry
        key, ku = jax.random.split(key)
        u = jax.random.uniform(ku, (n_pad,), dtype=jnp.float32)
        sel = cands & (u < 0.5)  # set_initial_distr_k coin flip
        cls = jnp.where(sel, rank_class, jnp.int32(-1))
        # both contractions through neighbor_color_counts: dispatches on
        # the adjacency dtype, so the dense int8 AND the bit-packed
        # layouts both work (round 3 — Luby rides the same cached
        # packed A as the MCMC backend)
        from mcmc_colorer_tpu.ops.dense_adj import neighbor_color_counts

        m = neighbor_color_counts(adj, cls, n_classes)
        # selected neighbors in class >= own class (suffix count)
        suffix = jnp.cumsum(m[:, ::-1], axis=1)[:, ::-1]
        ge_cnt = jnp.take_along_axis(
            suffix, rank_class[:, None], axis=1
        )[:, 0]
        beaten = ge_cnt > 0
        surv = sel & ~beaten
        is_set = is_set | surv
        near = (
            neighbor_color_counts(
                adj, jnp.where(surv, 0, jnp.int32(-1)), 1
            )[:, 0]
            > 0
        )
        cands = cands & ~surv & ~near
        commit = ~jnp.any(cands)
        colors = jnp.where(commit & is_set, n_colors, colors)
        n_colors = n_colors + jnp.where(commit, 1, 0)
        uncolored = (colors < 0) & real
        cands = jnp.where(commit, uncolored, cands)
        is_set = jnp.where(commit, False, is_set)
        done = commit & ~jnp.any(uncolored)
        return colors, n_colors, key, cands, is_set, rounds + 1, done

    return jax.lax.while_loop(cond, body, carry)


def _run_luby(ell: EllGraph, key):
    """Whole colorer on-device (one execution — CPU/tests; the hardware
    path drives `_luby_segment` from the host).  Colors are 0-based here
    (the reference's 1-based convention with 0=uncolored,
    coloringLuby.cu:328-341, is normalised at the API boundary, SURVEY
    §8)."""
    carry = _luby_init(ell, key)
    carry = _luby_segment(ell, carry, jnp.int32(2**30))
    return carry[0], carry[1]


def _run_luby_bucketed(bell, key):
    """Device-resident Luby over degree-bucketed rectangles.

    Same flattened loop and survival rule as `_run_luby`, but each round's
    neighbor inspection runs per degree-class slice, and the selection flag
    travels WITH the degree in one packed int32 gather (deg·2 | selected)
    instead of a precomputed [n_pad, d_pad] neighbor-degree matrix
    (prohibitive at n=1e6)."""
    carry = _luby_init(bell, key)
    carry = _luby_segment_bucketed(bell, carry, jnp.int32(2**30))
    return carry[0], carry[1]


def _luby_segment_bucketed(bell, carry, budget):
    """Bucketed rendition of `_luby_segment` (flattened, budgeted)."""
    n_pad = bell.n_pad
    real = bell.node_mask
    degrees = bell.degrees
    from mcmc_colorer_tpu.models.mcmc import _slice_vec

    def near_mask(flags):
        flags_ext = jnp.concatenate([flags, jnp.zeros((1,), jnp.bool_)])
        parts = [
            jnp.any(jnp.take(flags_ext, s.neighbors, axis=0), axis=1)
            for s in bell.slices
        ]
        return jnp.concatenate(parts)

    def beaten_mask(sel):
        packed = jax.lax.shift_left(degrees, 1) | sel.astype(jnp.int32)
        packed_ext = jnp.concatenate([packed, jnp.zeros((1,), jnp.int32)])
        parts = []
        for s in bell.slices:
            nb = jnp.take(packed_ext, s.neighbors, axis=0)
            deg_s = _slice_vec(degrees, s.start, s.h_pad)
            parts.append(
                jnp.any(
                    ((nb & 1) == 1)
                    & (
                        jax.lax.shift_right_logical(nb, 1)
                        >= deg_s[:, None]
                    ),
                    axis=1,
                )
            )
        return jnp.concatenate(parts)

    limit = carry[5] + budget

    def cond(carry):
        _, _, _, _, _, rounds, done = carry
        return (~done) & (rounds < limit)

    def body(carry):
        colors, n_colors, key, cands, is_set, rounds, done = carry
        key, ku = jax.random.split(key)
        u = jax.random.uniform(ku, (n_pad,), dtype=jnp.float32)
        sel = cands & (u < 0.5)
        surv = sel & ~beaten_mask(sel)
        is_set = is_set | surv
        cands = cands & ~surv & ~near_mask(surv)
        commit = ~jnp.any(cands)
        colors = jnp.where(commit & is_set, n_colors, colors)
        n_colors = n_colors + jnp.where(commit, 1, 0)
        uncolored = (colors < 0) & real
        cands = jnp.where(commit, uncolored, cands)
        is_set = jnp.where(commit, False, is_set)
        done = commit & ~jnp.any(uncolored)
        return colors, n_colors, key, cands, is_set, rounds + 1, done

    return jax.lax.while_loop(cond, body, carry)
