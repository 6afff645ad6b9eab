"""Device-resident MCMC colorer for hash-defined G(n,p): zero-upload runs.

``MCMCColorer`` (models/mcmc.py) assumes a host graph whose ELL rectangle
is built on the host and shipped to the device (465 MB at ER(100k, 0.01)).
For *generated* graphs that is unnecessary: ``ops/hashgen.py`` defines the
edge set as a stateless hash, the device materialises the bit-packed
adjacency directly (zero bytes moved), and this driver runs the full
matmul-backend chain against it.

The matmul chain (``_chain_segment_matmul``/``_sweep_matmul``) never
reads ``ell.neighbors`` — every neighbor interaction is the
``NC = A @ onehot(colors)`` contraction — so the ELL here is a shim
whose neighbor rectangle is a tiny all-sentinel placeholder.  The two
gather-using steps of the classic driver are replaced with NC-native
equivalents:

* final conflict count — one contraction (``conflicts_from_packed``);
* tailcut — ``_tailcut_nc``: per round, the conflicted set flips coins,
  heads with no head-neighbor (checked via one ``A & heads_bits``
  popcount pass over the packed matrix — no neighbor lists) form an
  independent mover set, and each mover takes its smallest NC-free
  color.  Movers are pairwise non-adjacent and land on colors unoccupied
  in their whole neighborhood, so the conflict count is monotone
  non-increasing while free colors exist (the reference's tailcut goal,
  coloringMCMC_CPU.cpp:89-97, reached by a collective route).

Chain semantics (proposal family, taboo, do-while exit, trace) are
byte-for-byte the shared matmul segment — only graph residency differs.
Counterpart of the reference's generate-then-color flow
(src/datasetGenerator.cpp + main.cu), fused onto the accelerator.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu.graph.container import EllGraph
from mcmc_colorer_tpu.models.base import Coloring
from mcmc_colorer_tpu.models.mcmc import (
    _chain_init,
    _chain_segment_matmul,
    choose_block_size,
)
from mcmc_colorer_tpu.ops.dense_adj import neighbor_color_counts
from mcmc_colorer_tpu.ops.hashgen import (
    degrees_from_packed,
    er_packed_on_device_cached,
)
from mcmc_colorer_tpu.utils import rng as rngu


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def conflicts_from_packed(adj, colors, n_colors, node_mask):
    """Conflict-edge count of ``colors`` via one NC contraction:
    Σ_i NC[i, c_i] = 2·E_conf (each conflict edge counted at both
    endpoints)."""
    nc = neighbor_color_counts(adj, colors, n_colors, node_mask)
    own = jnp.take_along_axis(
        nc, jnp.minimum(colors, nc.shape[1] - 1)[:, None], axis=1
    )[:, 0]
    return jnp.sum(jnp.where(node_mask, own, 0), dtype=jnp.int32) // 2


def _pack_mask(mask, words):
    """[n_pad] bool -> [words] uint32 in the packed_bit_coords order
    (same reshape/shift-sum as ops/dense_adj.pack_ell_rows)."""
    k_total = words * 32
    m = mask.astype(jnp.uint32)
    if k_total > m.shape[0]:
        m = jnp.concatenate(
            [m, jnp.zeros((k_total - m.shape[0],), jnp.uint32)]
        )
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, :, None]
    return jnp.sum(
        m.reshape(-1, 32, 128) << shifts, axis=1, dtype=jnp.uint32
    ).reshape(words)


@partial(jax.jit, static_argnames=("n_colors",))
def _tailcut_nc_round(adj, colors, key, node_mask, nc_prev=None, *, n_colors):
    """One independent-set repair round; returns (colors, conflicts,
    nc_new).  ``nc_prev`` (the previous round's exit NC of the SAME
    coloring) skips the entry contraction — the dominant cost of a
    round — so a multi-round repair pays one bit-matmul per round, not
    two."""
    n_pad = colors.shape[0]
    words = adj.shape[1]
    nc = (
        nc_prev
        if nc_prev is not None
        else neighbor_color_counts(adj, colors, n_colors, node_mask)
    )
    n_col_pad = nc.shape[1]
    own = jnp.take_along_axis(
        nc, jnp.minimum(colors, n_col_pad - 1)[:, None], axis=1
    )[:, 0]
    conflicted = (own > 0) & node_mask
    heads = conflicted & (
        jax.random.uniform(key, (n_pad,), dtype=jnp.float32) < 0.5
    )
    head_bits = _pack_mask(heads, words)
    nbr_heads = jnp.sum(
        jax.lax.population_count(adj & head_bits[None, :]).astype(
            jnp.int32
        ),
        axis=1,
    )
    movers = heads & (nbr_heads == 0)
    col_ids = jnp.arange(n_col_pad, dtype=jnp.int32)[None, :]
    free = (nc == 0) & (col_ids < n_colors)
    first_free = jnp.argmax(free, axis=1).astype(jnp.int32)
    has_free = jnp.any(free, axis=1)
    # no free color (degree >= nCol corner): least-occupied color
    fallback = jnp.argmin(
        jnp.where(col_ids < n_colors, nc, jnp.int32(2**30)), axis=1
    ).astype(jnp.int32)
    newc = jnp.where(has_free, first_free, fallback)
    colors = jnp.where(movers, newc, colors)
    nc_new = neighbor_color_counts(adj, colors, n_colors, node_mask)
    own2 = jnp.take_along_axis(
        nc_new, jnp.minimum(colors, n_col_pad - 1)[:, None], axis=1
    )[:, 0]
    conflicts = (
        jnp.sum(jnp.where(node_mask, own2, 0), dtype=jnp.int32) // 2
    )
    return colors, conflicts, nc_new


class _StatsShim:
    """Graph-shaped stats carrier for the log contract
    (``format_run_stats`` reads n / n_edges / degrees / max_degree /
    mean_degree) — NOT an adjacency; ``check_coloring`` needs the real
    host rendition (``ResidentMCMCColorer.host_graph``)."""

    def __init__(self, n, n_edges, degrees, max_degree, name):
        self.n, self.n_edges = n, n_edges
        self.degrees, self.max_degree = degrees, max_degree
        self.name = name

    @property
    def mean_degree(self) -> float:
        return float(self.degrees.mean()) if self.n else 0.0


class ResidentMCMCColorer:
    """MCMC balanced colorer over a hash-defined G(n, p) that never
    leaves the device.  ``params.n_colors <= 0`` means "palette =
    measured max degree / num_col_ratio" (resolved on-device, the CLI's
    default_n_colors rule)."""

    def __init__(
        self,
        n: int,
        p: float,
        graph_seed: int,
        params: MCMCParams | None = None,
        row_chunk: int = 2048,
        num_col_ratio: float = 1.0,
        n_chains: int = 1,
        active: bool = False,
        capacity: int | None = None,
    ) -> None:
        """``capacity``: device memory in bytes that bounds the packed
        adjacency (default: the device's own, ops/dense_adj.py)."""
        from mcmc_colorer_tpu.ops.dense_adj import require_packed_fits

        self.n, self.p, self.graph_seed = n, p, graph_seed
        n_pad = _round_up(n, row_chunk)
        require_packed_fits(n_pad, capacity)
        t0 = time.perf_counter()
        # gen_stats splits the one-time cost (compile vs band execute) —
        # see ops/hashgen.er_packed_on_device
        self.gen_stats: dict = {}
        self.adj = er_packed_on_device_cached(
            n, p, graph_seed, n_pad, row_chunk, stats=self.gen_stats
        )
        degrees = degrees_from_packed(self.adj)
        self.max_degree = int(jnp.max(degrees))  # forces generation
        self.gen_seconds = time.perf_counter() - t0
        self.gen_stats["degrees_s"] = round(
            self.gen_seconds
            - self.gen_stats.get("compile_s", 0.0)
            - self.gen_stats.get("execute_s", 0.0),
            3,
        )
        self.host_degrees = np.asarray(degrees)[:n]
        self.n_edges = int(
            self.host_degrees.astype(np.int64).sum() // 2
        )
        if params is None or params.n_colors <= 0:
            from mcmc_colorer_tpu.config import default_n_colors

            n_col = default_n_colors(self.max_degree, num_col_ratio)
            if params is None:
                params = MCMCParams(
                    n_colors=n_col,
                    proposal=ProposalKind.BALANCE_DYNAMIC,
                    tailcut=True,
                )
            else:
                params = params.replace(n_colors=n_col)
        self.params = params
        self.block = min(
            choose_block_size(n, params.n_colors), row_chunk
        )
        # neighbors is a placeholder: the matmul chain never reads it
        # (all neighbor interaction is the NC contraction) — anything
        # gather-based would silently see an edgeless graph, which is
        # why this driver supplies NC-native final-count and tailcut
        self.ell = EllGraph(
            neighbors=jnp.full((n_pad, 8), n_pad, jnp.int32),
            degrees=degrees,
            n_nodes=n,
            n_edges=self.n_edges,
            max_degree=self.max_degree,
        )
        self._jit_segment = jax.jit(
            partial(
                _chain_segment_matmul, params=params, block=self.block
            )
        )
        self._jit_init = jax.jit(
            partial(_chain_init, params=params, fused=True)
        )
        self._jit_conf = jax.jit(
            partial(conflicts_from_packed, n_colors=params.n_colors)
        )
        # active (frontier) mode: after the full-sweep phase shrinks the
        # conflict set, resample only the ≤cap frontier — its neighbor
        # rows are SLICED from the resident packed adjacency and
        # unpacked on device (ops/dense_adj.packed_rows_to_ids), so the
        # frontier sweeps the hash graph was thought to preclude
        # (VERDICT r4 item 3) need no stored ELL at all
        self.active = active
        if active:
            if n_chains > 1:
                raise NotImplementedError(
                    "active resident mode is single-chain (the frontier "
                    "ladder compiles per cap; vmapping it multiplies "
                    "programs) — use n_chains>1 with full sweeps"
                )
            if params.hastings:
                raise NotImplementedError(
                    "active-set mode implements the shipped "
                    "always-accept dynamics (see models/mcmc_active.py)"
                )
            from mcmc_colorer_tpu.models.mcmc_active import (
                _cnt_of_packed,
                _stats,
            )

            self._d_row = _round_up(max(self.max_degree, 8), 8)
            self._jit_cnt_packed = jax.jit(
                partial(
                    _cnt_of_packed,
                    params=params,
                    node_mask=self.ell.node_mask,
                )
            )
            self._jit_stats = jax.jit(_stats)
            self._active_fns: dict = {}
        # ensemble mode: vmapped lock-step chains over the ONE resident
        # adjacency (the reference's repeated-run flow, main.cu:171-189,
        # batched; best-of-chains selection like parallel/chains.py)
        self.n_chains = n_chains
        if n_chains > 1:
            self._jit_segment_v = jax.jit(
                jax.vmap(
                    partial(
                        _chain_segment_matmul,
                        params=params,
                        block=self.block,
                    ),
                    in_axes=(None, None, 0, None),
                )
            )
            self._jit_init_v = jax.jit(
                jax.vmap(
                    partial(_chain_init, params=params, fused=True),
                    in_axes=(None, 0),
                )
            )
            self._jit_conf_v = jax.jit(
                jax.vmap(
                    lambda a, c, m: conflicts_from_packed(
                        a, c, params.n_colors, m
                    ),
                    in_axes=(None, 0, None),
                )
            )
            self._jit_tc_v = jax.jit(
                jax.vmap(
                    partial(
                        _tailcut_nc_round.__wrapped__,
                        n_colors=params.n_colors,
                    ),
                    in_axes=(None, 0, 0, None),
                )
            )

    @property
    def name(self) -> str:
        return f"er_hash_{self.n}_{self.p}"

    def stats_graph(self) -> _StatsShim:
        """Cheap graph-stats view (n / m / degrees, no adjacency) for
        run logs; use :meth:`host_graph` when the edges themselves are
        needed (``--check``)."""
        return _StatsShim(
            self.n, self.n_edges, self.host_degrees, self.max_degree,
            self.name,
        )

    def host_graph(self):
        """Host CSR of the same graph (threaded C++ hash enumeration) —
        for validation/analysis; NOT needed to run."""
        from mcmc_colorer_tpu.ops.hashgen import hash_er_graph

        return hash_er_graph(self.n, self.p, self.graph_seed, name=self.name)

    # -- checkpoint/resume (SURVEY §6; the reference has none) ----------
    # The graph itself NEVER enters the artifact: it re-derives from
    # (n, p, graph_seed) on load, so a resident checkpoint is only the
    # chain state — colors + taboo + key + iteration + trace (+ batch
    # axis for ensembles).  Resuming mid-chain is bit-equal to the
    # uninterrupted run (segments are bit-equal to one execution).

    def save_checkpoint(self, carry, path: str) -> None:
        colors, taboo, key, rip, conf, trace, done = carry
        # tmp + atomic rename: the write happens at every segment
        # boundary, and a kill mid-write must not destroy the previous
        # good artifact (the exact crash the feature exists for)
        tmp = path + ".tmp.npz"
        np.savez(
            tmp,
            colors=np.asarray(colors),
            taboo=np.asarray(taboo),
            key=np.asarray(jax.random.key_data(key)),
            iteration=np.asarray(rip),
            conf_last=np.asarray(conf),
            trace=np.asarray(trace),
            done=np.asarray(done),
            n=self.n,
            p=self.p,
            graph_seed=self.graph_seed,
            n_colors=self.params.n_colors,
        )
        import os

        os.replace(tmp, path if path.endswith(".npz") else path + ".npz")

    def load_checkpoint(self, path: str):
        if not path.endswith(".npz"):
            path = path + ".npz"
        d = np.load(path)
        spec = (int(d["n"]), float(d["p"]), int(d["graph_seed"]))
        assert spec == (self.n, float(self.p), self.graph_seed), (
            f"resident graph spec mismatch: checkpoint {spec} vs "
            f"colorer {(self.n, float(self.p), self.graph_seed)}"
        )
        assert int(d["n_colors"]) == self.params.n_colors, "palette mismatch"
        trace_ck = np.asarray(d["trace"])
        width = self.params.max_iterations + 1
        # the trace rectangle is sized by max_iterations: a resume into
        # a longer-horizon colorer pads the saved prefix with zeros
        if trace_ck.shape[-1] < width:
            pad = [(0, 0)] * (trace_ck.ndim - 1) + [
                (0, width - trace_ck.shape[-1])
            ]
            trace_ck = np.pad(trace_ck, pad)
        else:
            trace_ck = trace_ck[..., :width]
        return (
            jnp.asarray(d["colors"]),
            jnp.asarray(d["taboo"]),
            jax.random.wrap_key_data(jnp.asarray(d["key"])),
            jnp.asarray(d["iteration"]),
            jnp.asarray(d["conf_last"]),
            jnp.asarray(trace_ck),
            jnp.asarray(d["done"]),
        )

    def _run_active(self, seed: int, repetition: int = 0) -> Coloring:
        """Hybrid full→frontier chain over the resident adjacency:
        full matmul sweeps (short host-driven budgets) until the
        conflict set shrinks, then ≤cap frontier resamples whose rows
        are sliced+unpacked from the packed matrix — the resident
        rendition of models/mcmc_active.py (reference analogue: only
        violating nodes effectively move at reference ε,
        coloringMCMC_CPU.cpp:471-479)."""
        from mcmc_colorer_tpu.models.mcmc_active import (
            _active_iteration,
            _buckets,
            pick_cap,
        )

        params, ell = self.params, self.ell
        n_pad = ell.n_pad
        z = params.tailcut_threshold(self.n)
        key = rngu.for_repetition(rngu.root_key(seed), repetition)
        t0 = time.perf_counter()
        carry = self._jit_init(ell, key)
        switch_at = n_pad // 8
        # phase 1: full matmul sweeps, small budgets so the switch
        # point is observed promptly (each budget is one execution of
        # the same compiled segment program)
        while True:
            rip = int(carry[3])
            if rip >= params.max_iterations or bool(carry[6]):
                break
            b = min(4, params.max_iterations - rip)
            carry = self._jit_segment(
                ell, self.adj, carry, jnp.int32(b)
            )
            if bool(carry[6]):
                break
            if 2 * int(carry[4]) < switch_at:
                break
        colors, taboo, key, rip_t, _conf, trace_full, _done = carry
        rip = int(rip_t)
        # drop unwritten -1 sentinel slots (a cap exit can leave one)
        trace = [
            int(x)
            for x in np.asarray(trace_full)[: rip + 1]
            if int(x) >= 0
        ]

        caps = _buckets(n_pad, 128, 4)
        cnt = self._jit_cnt_packed(self.adj, colors)
        # measure-first loop: the stats of the CURRENT coloring are
        # re-read after the last iteration too, so a cap exit (in
        # either phase) reports the real conflict count and the
        # tailcut gate below sees it (review r5: the old loop left
        # conflicts stale — 0 if phase 1 exhausted max_iterations —
        # faking convergence and skipping an enabled tailcut)
        while True:
            n_active, conflicts = map(
                int, jax.device_get(self._jit_stats(cnt, taboo))
            )
            trace.append(conflicts)
            if conflicts <= z or rip >= params.max_iterations:
                break
            rip += 1
            key, k_it = jax.random.split(key)
            cap = pick_cap(caps, n_active)
            fn = self._active_fns.get(cap)
            if fn is None:
                fn = jax.jit(
                    partial(
                        _active_iteration, params=params, d_row=self._d_row
                    ),
                    static_argnames=("cap",),
                )
                self._active_fns[cap] = fn
            colors, taboo, cnt = fn(
                ell, colors, taboo, cnt, k_it,
                cap=cap, adj_packed=self.adj,
            )
        # tailcut: identical NC-native independent-set repair as the
        # full-sweep driver
        tc_rounds = 0
        if params.tailcut and conflicts > 0:
            max_rounds = 16 + 2 * conflicts
            nc_carry = None
            conflicts_j = jnp.int32(conflicts)
            while int(conflicts_j) > 0 and tc_rounds < max_rounds:
                key, k_r = jax.random.split(key)
                colors, conflicts_j, nc_carry = _tailcut_nc_round(
                    self.adj,
                    colors,
                    k_r,
                    ell.node_mask,
                    nc_carry,
                    n_colors=params.n_colors,
                )
                tc_rounds += 1
            conflicts = int(conflicts_j)
        out = np.asarray(jax.device_get(colors))[: self.n]
        return Coloring(
            colors=out,
            n_colors=params.n_colors,
            iterations=rip,
            converged=conflicts == 0 or conflicts <= z,
            duration_ms=(time.perf_counter() - t0) * 1e3,
            conflict_trace=np.asarray(trace, dtype=np.int64),
            extra={
                "final_conflicts": conflicts,
                "max_iter_reached": rip >= params.max_iterations,
                "tailcut_rounds": tc_rounds,
                "resident": True,
                "active": True,
                "gen_seconds": self.gen_seconds,
            },
        )

    def run(
        self,
        seed: int,
        repetition: int = 0,
        checkpoint_path: str | None = None,
        resume_from: str | None = None,
    ) -> Coloring:
        if self.active:
            if checkpoint_path or resume_from:
                raise NotImplementedError(
                    "checkpointing covers the full-sweep resident "
                    "drivers; the active loop's cnt re-derives from "
                    "colors, so resume support is a trivial extension "
                    "if needed"
                )
            return self._run_active(seed, repetition)
        if self.n_chains > 1:
            best, self.last_summaries = self.run_ensemble(
                seed,
                repetition,
                checkpoint_path=checkpoint_path,
                resume_from=resume_from,
            )
            return best
        from mcmc_colorer_tpu.utils.segmented import drive_segments

        params = self.params
        z = params.tailcut_threshold(self.n)
        key = rngu.for_repetition(rngu.root_key(seed), repetition)
        t0 = time.perf_counter()
        if resume_from:
            carry = self.load_checkpoint(resume_from)
        else:
            carry = self._jit_init(self.ell, key)

        def progress(c):
            rip = int(c[3])
            return rip, bool(c[6]) or rip >= params.max_iterations

        # per-segment free-color TRACE, NC-native (the resident
        # rendition of models/mcmc.py's getStatsFreeColors lines —
        # free[i] = #{c < nCol : NC[i, c] = 0}); zero cost when off
        from mcmc_colorer_tpu.utils import term

        fc_segments: list = []
        if term.trace_enabled() and not hasattr(self, "_jit_free_nc"):
            from mcmc_colorer_tpu.ops.dense_adj import (
                neighbor_color_counts,
            )

            mask = self.ell.node_mask
            n_real = max(self.n, 1)

            def _free_nc(adj, colors):
                nc = neighbor_color_counts(
                    adj, colors, params.n_colors, mask
                )
                col_ok = (
                    jnp.arange(nc.shape[1], dtype=jnp.int32)
                    < params.n_colors
                )
                free = jnp.sum(
                    (nc == 0) & col_ok[None, :], axis=1,
                    dtype=jnp.int32,
                )
                mn = jnp.min(
                    jnp.where(mask, free, jnp.int32(params.n_colors + 1))
                )
                mx = jnp.max(jnp.where(mask, free, jnp.int32(-1)))
                avg = jnp.sum(jnp.where(mask, free, 0)) / n_real
                return mn, mx, avg

            self._jit_free_nc = jax.jit(_free_nc)

        def on_seg(state, steps, budget, elapsed):
            if term.trace_enabled():
                mn, mx, avg = self._jit_free_nc(self.adj, state[0])
                mn, mx, avg = int(mn), int(mx), float(avg)
                fc_segments.append((mn, mx, avg))
                term.trace(
                    f"Max Free Colors: {mx} - Min Free Colors: {mn} - "
                    f"AVG Free Colors: {avg:g}"
                )
            if checkpoint_path:
                self.save_checkpoint(state, checkpoint_path)

        carry = drive_segments(
            lambda c, b: self._jit_segment(
                self.ell, self.adj, c, jnp.int32(b)
            ),
            carry,
            progress,
            on_segment=on_seg,
        )
        colors, _taboo, key, rip, conf_last, trace, done = carry
        # converged loops already measured the final coloring in-loop; a
        # cap exit leaves conf_last describing the pre-swap coloring
        # (same rule as _chain_final_conflicts, NC-native here)
        if bool(done):
            conflicts = conf_last
        else:
            conflicts = self._jit_conf(
                self.adj, colors, node_mask=self.ell.node_mask
            )
        tc_rounds = 0
        if params.tailcut and int(conflicts) > 0:
            max_rounds = 16 + 2 * int(conflicts)
            nc_carry = None
            while int(conflicts) > 0 and tc_rounds < max_rounds:
                key, k_r = jax.random.split(key)
                colors, conflicts, nc_carry = _tailcut_nc_round(
                    self.adj,
                    colors,
                    k_r,
                    self.ell.node_mask,
                    nc_carry,
                    n_colors=params.n_colors,
                )
                tc_rounds += 1
        rip = int(rip)
        conflicts = int(conflicts)
        out = np.asarray(jax.device_get(colors))[: self.n]
        return Coloring(
            colors=out,
            n_colors=params.n_colors,
            iterations=rip,
            converged=conflicts == 0 or conflicts <= z,
            duration_ms=(time.perf_counter() - t0) * 1e3,
            conflict_trace=np.asarray(trace)[: rip + 1],
            extra={
                "final_conflicts": conflicts,
                "max_iter_reached": rip >= params.max_iterations,
                "tailcut_rounds": tc_rounds,
                "resident": True,
                "gen_seconds": self.gen_seconds,
                **(
                    {"free_color_trace_segments": fc_segments}
                    if fc_segments
                    else {}
                ),
            },
        )

    def run_ensemble(
        self,
        seed: int,
        repetition: int = 0,
        checkpoint_path: str | None = None,
        resume_from: str | None = None,
    ):
        """Lock-step ``n_chains`` independent chains over the shared
        resident adjacency; returns (best Coloring, summaries) with the
        same best-of-chains rule as ``parallel/chains.py`` (fewest
        conflicts, then smallest class-size std)."""
        from mcmc_colorer_tpu.utils.segmented import drive_segments

        params = self.params
        z = params.tailcut_threshold(self.n)
        root = rngu.for_repetition(rngu.root_key(seed), repetition)
        keys = jax.vmap(lambda c: rngu.for_chain(root, c))(
            jnp.arange(self.n_chains, dtype=jnp.uint32)
        )
        t0 = time.perf_counter()
        if resume_from:
            carry = self.load_checkpoint(resume_from)
            assert carry[0].shape[0] == self.n_chains, (
                "checkpoint chain count mismatch"
            )
        else:
            carry = self._jit_init_v(self.ell, keys)

        def progress(c):
            rips_h = np.asarray(c[3])
            active = ~np.asarray(c[6]) & (rips_h < params.max_iterations)
            return int(rips_h.max()), not active.any()

        def on_seg(state, steps, budget, elapsed):
            if checkpoint_path:
                self.save_checkpoint(state, checkpoint_path)

        carry = drive_segments(
            lambda c, b: self._jit_segment_v(
                self.ell, self.adj, c, jnp.int32(b)
            ),
            carry,
            progress,
            on_segment=on_seg,
        )
        colors, _taboo, keyv, rips, _conf_last, traces, _done = carry
        # one batched NC pass gives every chain's exact conflict count
        # (conf_last is stale for cap-exited chains, same as the fused
        # carry in parallel/chains.py)
        conflicts = self._jit_conf_v(
            self.adj, colors, self.ell.node_mask
        )
        tc_rounds = 0
        if params.tailcut and int(np.asarray(conflicts).max()) > 0:
            max_rounds = 16 + 2 * int(np.asarray(conflicts).max())
            while (
                int(np.asarray(conflicts).max()) > 0
                and tc_rounds < max_rounds
            ):
                ks = jax.vmap(
                    lambda k: jax.random.split(k)
                )(keyv)
                keyv, k_r = ks[:, 0], ks[:, 1]
                # repair rounds are no-ops on conflict-free chains
                # (empty conflicted set => empty mover set).  The NC is
                # NOT threaded between vmapped rounds: a per-chain NC
                # carry is [chains, n_pad, n_col_pad] — GBs at bench
                # scale — so the ensemble trades one extra contraction
                # per round for not holding it
                colors, conflicts, _nc = self._jit_tc_v(
                    self.adj, colors, k_r, self.ell.node_mask
                )
                tc_rounds += 1
        colors_h = np.asarray(jax.device_get(colors))[:, : self.n]
        conflicts_h = np.asarray(conflicts)
        rips_h = np.asarray(rips)
        dur = (time.perf_counter() - t0) * 1e3
        stds = np.array(
            [
                np.bincount(c, minlength=params.n_colors).std()
                for c in colors_h
            ]
        )
        order = np.lexsort((stds, conflicts_h))
        best = int(order[0])
        summaries = [
            {
                "chain": int(i),
                "iterations": int(rips_h[i]),
                "conflicts": int(conflicts_h[i]),
                "class_std": float(stds[i]),
            }
            for i in range(self.n_chains)
        ]
        best_coloring = Coloring(
            colors=colors_h[best],
            n_colors=params.n_colors,
            iterations=int(rips_h[best]),
            converged=int(conflicts_h[best]) <= z,
            duration_ms=dur,
            conflict_trace=np.asarray(traces[best])[
                : int(rips_h[best]) + 1
            ],
            extra={
                "final_conflicts": int(conflicts_h[best]),
                "max_iter_reached": bool(
                    rips_h[best] >= params.max_iterations
                ),
                "tailcut_rounds": tc_rounds,
                "resident": True,
                "gen_seconds": self.gen_seconds,
                "best_chain": best,
                "chains": self.n_chains,
            },
        )
        return best_coloring, summaries
