"""Vertex-sharded, lock-step multi-chain MCMC over a (chains, shards) mesh.

The reference caps at one GPU's HBM — its nnodes×nCol ``colorsChecker``
matrix is the limiter (coloringMCMC_main.cu:39; SURVEY §6 long-context
note).  Here one chain's vertices are partitioned over the ``shards`` mesh
axis and whole chains over the ``chains`` axis, inside one `shard_map`:

* each shard owns ``n_pad/S`` ELL rows and resamples only those vertices;
* boundary colors are exchanged with one tiled `all_gather` per sweep —
  the distributed analogue of the reference's per-iteration D2H/H2D
  histogram round-trip (coloringMCMC_main.cu:210-214);
* conflict counts `psum` over shards: every shard counts the same-color
  neighbors of its *owned* vertices, so each conflict edge is counted by
  exactly two owners and the psum'd total halves exactly (the distributed
  rendition of the ``idx < neigh`` dedup, coloringMCMC_utils.cu:115;
  SURVEY §10 hard part 6);
* chains advance in lock-step, enabling **pooled annealing**: when the
  pooled (cross-chain mean) conflict count stalls, ε is boosted so chains
  explore more — the systematic version of the reference's interactive
  live-ε editing (dbg.cpp:358-381).

With ``active_cap`` set, each chain switches per-iteration to a
**frontier sweep** once every shard's eligible frontier fits in the cap:
only the ≤cap violating taboo-free owned vertices are re-gathered and
resampled (plus the single sparse ε-flip of a non-violating vertex, as in
models/mcmc_active.py), and the per-vertex conflict counts are maintained
*exactly* by psum-ing one incremental delta vector built from the changed
vertices' ELL rows.  This is the lock-step active-set ensemble of the
PERF.md roadmap: the per-sweep gather cost drops from n·d to |frontier|·d
per shard while chains stay synchronised for pooled annealing.

All chains and shards run the loop to the globally-last convergence;
converged chains freeze in place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mcmc_colorer_tpu.config import MCMCParams
from mcmc_colorer_tpu.graph.container import EllGraph, Graph
from mcmc_colorer_tpu.models.base import Coloring
from mcmc_colorer_tpu.models.mcmc import (
    MCMCColorer,
    _needs_histogram,
    _proposal_q,
    _sample_cdf,
    _variant_distribution,
    choose_block_size,
)
from mcmc_colorer_tpu.ops.neighbor import occupancy_matrix
from mcmc_colorer_tpu.utils import rng as rngu


def _put_global(arr, sharding) -> jax.Array:
    """Lay a host array out under ``sharding``.  Works when the sharding
    spans other processes' devices (multi-host), where plain `device_put`
    refuses: every process holds the same full array and contributes its
    addressable shards."""
    if sharding.is_fully_addressable:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    # global_shape MUST be given: every process passes the full array, and
    # without it the helper would infer a per-process-concatenated shape
    return jax.make_array_from_process_local_data(
        sharding, arr, global_shape=arr.shape
    )


def _host_get(x) -> np.ndarray:
    """Bring a (possibly multi-process global) array to THIS host.  In a
    multi-host run, shards living on other processes' devices are not
    addressable locally — `process_allgather` replicates them over DCN
    first (the multi-host rendition of the reference's D2H copies)."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(jax.device_get(x))


@dataclass(frozen=True)
class AnnealConfig:
    """Pooled ε-annealing: if the pooled mean conflict count improves by
    less than ``tol`` for ``window`` consecutive sweeps, multiply ε by
    ``boost`` (capped so (nCol−1)·ε stays well below 1)."""

    enabled: bool = False
    tol: float = 0.01
    window: int = 10
    boost: float = 4.0


class ShardedMCMCColorer:
    """MCMC ensemble over a 2D ``(chains, shards)`` mesh."""

    def __init__(
        self,
        graph: Graph,
        params: MCMCParams,
        mesh: Mesh,
        n_chains: int | None = None,
        anneal: AnnealConfig | None = None,
        block_size: int | None = None,
        backend: str = "auto",
        active_cap: int | None = None,
        resident_spec: tuple | None = None,
        num_col_ratio: float = 1.0,
    ) -> None:
        """``active_cap``: per-shard frontier capacity (rounded up to a
        multiple of 128).  When every shard's eligible frontier fits, the
        chain switches to frontier sweeps (see module docstring).  None
        disables active mode (every sweep is full).

        ``resident_spec=(n, p, graph_seed)``: hash-defined G(n, p)
        (ops/hashgen.py) — pass ``graph=None``; every shard materialises
        its OWN packed adjacency strip on-device (zero bytes uploaded,
        the sharded rendition of models/mcmc_resident.py).  Full-sweep
        ``backend='matmul'`` only; the tailcut runs the strip-native
        independent-set repair.  ``params.n_colors <= 0`` resolves to
        ``max_degree / num_col_ratio`` via a streaming on-device degree
        pass."""
        if params.hastings and active_cap is not None:
            # The frontier sweep approximates the passive vertices' keep
            # dynamics with at most one ε-flip per sweep (see
            # models/mcmc_active.py) — the proposal probability q of the
            # passive set is never materialised, so the Hastings ratio
            # q(old|new)/q(new|old) (coloringMCMC_standard.cu:88-135)
            # cannot be computed exactly there.  Full sweeps carry the
            # exact per-vertex qStar and support acceptance (below).
            raise NotImplementedError(
                "hastings=True requires full sweeps (active_cap=None)"
            )
        self._resident = resident_spec is not None
        if self._resident:
            if graph is not None:
                raise ValueError("pass graph=None with resident_spec")
            if backend == "auto":
                backend = "matmul"
            if backend != "matmul":
                raise ValueError(
                    "resident_spec implies the adjacency-strip backend "
                    f"(matmul); got {backend!r}"
                )
            # round 5 (VERDICT r4 item 3): frontier sweeps compose
            # with resident graphs — the per-shard packed strip already
            # holds every owned row, so the active branch slices its
            # ≤cap [cap, words] bit rows from the strip and unpacks
            # them to id lists on device (packed_rows_to_ids); no
            # stored neighbor lists needed
            rn, rp, rseed = resident_spec
            # memory precheck FIRST: past the per-shard strip cap even
            # the degree sweep is a long device program — refuse with the
            # clean error before touching the device (review r4)
            from mcmc_colorer_tpu.ops.dense_adj import packed_adj_words

            ms_pre = mesh.shape["shards"]
            per_shard_pre = (
                ((-(-rn // ms_pre) + 127) // 128) * 128
            )
            # the real n_loc is per_shard rounded up to the block size
            # chosen BELOW (which needs n_colors, possibly only known
            # after the degree sweep) — so the precheck sizes the strip
            # from the exact block when it is already determinable, and
            # otherwise from the conservative upper bound
            # n_loc < per_shard + block (block ≤ min(per_shard, 2^16)),
            # so a borderline config refuses HERE instead of after the
            # multi-minute mesh degree sweep (review r4)
            if block_size or params.n_colors > 0:
                blk_pre = min(
                    block_size
                    or choose_block_size(
                        rn,
                        params.n_colors
                        * max(
                            1,
                            (n_chains or mesh.shape["chains"])
                            // mesh.shape["chains"],
                        ),
                    ),
                    per_shard_pre,
                )
                n_loc_pre = -(-per_shard_pre // blk_pre) * blk_pre
            else:
                n_loc_pre = per_shard_pre + min(per_shard_pre, 1 << 16)
            strip_bytes = n_loc_pre * packed_adj_words(
                ms_pre * n_loc_pre
            ) * 4
            if not _strip_fits(strip_bytes, mesh):
                raise ValueError(
                    f"packed adjacency strip needs "
                    f"{strip_bytes/1e9:.1f} GB per shard at "
                    f"n={rn} over {ms_pre} shards (n_loc bound "
                    f"{n_loc_pre}); add shards, or pass an explicit "
                    f"block_size/n_colors to tighten the bound"
                )
            if params.n_colors <= 0:
                from mcmc_colorer_tpu.config import default_n_colors
                from mcmc_colorer_tpu.ops.hashgen import (
                    er_degrees_on_device,
                )

                maxdeg = int(
                    jnp.max(er_degrees_on_device(rn, rp, rseed, mesh=mesh))
                )
                params = params.replace(
                    n_colors=default_n_colors(maxdeg, num_col_ratio)
                )
        if backend == "auto":
            backend = "xla"
        self.backend = backend
        if backend not in ("xla", "matmul"):
            raise ValueError(f"unknown sharded backend {backend!r}")
        self.graph = graph
        self.params = params
        self.mesh = mesh
        mc = mesh.shape["chains"]
        ms = mesh.shape["shards"]
        self.n_chains = n_chains or mc
        if self.n_chains % mc:
            raise ValueError("n_chains must be a multiple of the chains axis")
        cl = self.n_chains // mc
        self.anneal = anneal or AnnealConfig()
        # size the per-shard slice so every shard owns real vertices
        # (naively padding to shards*block can leave whole shards with
        # nothing but phantom padding on small graphs)
        g_n = resident_spec[0] if self._resident else graph.n
        per_shard = -(-g_n // ms)
        per_shard = ((per_shard + 127) // 128) * 128
        self.block = min(
            block_size
            or choose_block_size(g_n, params.n_colors * cl),
            per_shard,
        )
        n_loc = ((per_shard + self.block - 1) // self.block) * self.block

        if self._resident:
            # the shim ELL only carries shapes + the log-contract stats:
            # the matmul path's every neighbor interaction is the strip
            # contraction, and the d_pad=8 all-sentinel rectangle is the
            # only thing _sharded_neighbors ever ships (KBs, not GBs)
            self._n_pad = ms * n_loc
            from mcmc_colorer_tpu.ops.dense_adj import packed_adj_words

            strip_bytes = n_loc * packed_adj_words(self._n_pad) * 4
            if not _strip_fits(strip_bytes, mesh):
                raise ValueError(
                    f"packed adjacency strip needs {strip_bytes/1e9:.1f}"
                    f" GB per shard at n_pad={self._n_pad} over {ms} "
                    "shards; add shards"
                )
            self._adj_strip = _resident_strips(
                resident_spec, self._n_pad, mesh
            )
            degrees_dev = jnp.sum(
                jax.lax.population_count(self._adj_strip).astype(
                    jnp.int32
                ),
                axis=1,
            )
            host_degrees = np.asarray(degrees_dev)[:g_n]
            max_degree = int(host_degrees.max()) if g_n else 0
            n_edges = int(host_degrees.astype(np.int64).sum() // 2)
            self.ell = EllGraph(
                neighbors=np.full((self._n_pad, 8), self._n_pad, np.int32),
                degrees=degrees_dev,
                n_nodes=g_n,
                n_edges=n_edges,
                max_degree=max_degree,
            )
            from mcmc_colorer_tpu.models.mcmc_resident import _StatsShim

            rn, rp, rseed = resident_spec
            self.graph = _StatsShim(
                g_n, n_edges, host_degrees, max_degree,
                f"er_hash_{rn}_{rp}",
            )
            self.resident_spec = resident_spec
            n_loc_final = n_loc
        else:
            self.ell = graph.to_ell(pad_nodes_to=ms * n_loc)
            self._n_pad = self.ell.n_pad
            n_loc_final = self._n_pad // ms
            self._adj_strip = None
        if backend == "matmul" and not self._resident:
            # adjacency-strip formulation (VERDICT r2 item 1b): each
            # shard holds its [n_loc, n_pad] rows of the bit-packed
            # adjacency (n_pad^2/8/S bytes) and computes its NC rows as
            # one contraction per sweep instead of the per-shard
            # neighbor-color gather — the contraction beyond the
            # single-card packed cap
            from mcmc_colorer_tpu.ops.dense_adj import packed_adj_words

            strip_bytes = n_loc_final * packed_adj_words(self._n_pad) * 4
            if not _strip_fits(strip_bytes, mesh):
                raise ValueError(
                    f"packed adjacency strip needs {strip_bytes/1e9:.1f} "
                    f"GB per shard at n_pad={self._n_pad} over {ms} "
                    "shards; add shards or use backend='xla'"
                )
            # strips are cached per (graph, n_pad, mesh devices) like the
            # single-chip adjacency (ops/dense_adj.py:get_adjacency):
            # repeated sharded colorers on one graph — CLI repetitions,
            # ensembles, parameter sweeps — reuse the band-wise build
            # instead of paying it per construction (VERDICT r3 weak 8)
            cache = graph.__dict__.setdefault("_adj_cache", {})
            ck = (
                self._n_pad,
                "strips",
                tuple(int(d.id) for d in mesh.devices.flat),
            )
            if ck not in cache:
                strips = _build_packed_strips(
                    self._sharded_neighbors(), mesh
                )
                from mcmc_colorer_tpu.ops.dense_adj import (
                    check_adjacency_complete,
                )

                # duplicate input edges collapse to one bit and would
                # break the gather/matmul chain equivalence (review r3);
                # generator graphs are certified simple (round 4)
                if not getattr(graph, "simple_certified", False):
                    check_adjacency_complete(strips, graph)
                cache[ck] = strips
            self._adj_strip = cache[ck]
        if active_cap is not None:
            active_cap = min(
                n_loc_final, ((max(active_cap, 1) + 127) // 128) * 128
            )
        self.active_cap = active_cap
        self._jit_init = jax.jit(
            partial(
                _sharded_init,
                mesh=mesh,
                params=params,
                chains_per_dev=cl,
                n_nodes=self.graph.n,
            )
        )
        self._jit_segment = jax.jit(
            partial(
                _run_sharded_segment,
                mesh=mesh,
                params=params,
                block=self.block,
                chains_per_dev=cl,
                anneal=self.anneal,
                n_nodes=self.graph.n,
                backend=backend,
                active_cap=active_cap,
                rows_from_strip=(
                    ((self.graph.max_degree + 7) // 8) * 8
                    if self._resident and active_cap is not None
                    else None
                ),
            )
        )

    # ---- ensemble state plumbing -----------------------------------------

    _STATE_FIELDS = (
        "colors", "taboo", "cnt", "keydata", "rip",
        "conflicts", "trace", "eps_scale", "prev_pooled", "stall",
        "accstats",
    )

    def _state_shardings(self):
        NS = partial(NamedSharding, self.mesh)
        return (
            NS(P("chains", None)),
            NS(P("chains", "shards")),
            NS(P("chains", "shards")),
            NS(P("chains", None)),
            NS(P()),
            NS(P("chains")),
            NS(P("chains", None)),
            NS(P()),
            NS(P()),
            NS(P()),
            NS(P("chains", None)),
        )

    def _sharded_neighbors(self):
        # cached: the ELL rectangle is n_pad·d_pad·4 bytes (GBs at the
        # scales the sharded path exists for) — ship it once, not once
        # per run (review r3)
        if getattr(self, "_neigh_sharded", None) is None:
            self._neigh_sharded = _put_global(
                np.asarray(self.ell.neighbors),
                NamedSharding(self.mesh, P("shards", None)),
            )
        return self._neigh_sharded

    def init_state(self, seed: int, repetition: int = 0):
        """Fresh ensemble state (the 11-tuple of `_sharded_init`)."""
        root = rngu.for_repetition(rngu.root_key(seed), repetition)
        keys = jax.vmap(lambda c: rngu.for_chain(root, c))(
            jnp.arange(self.n_chains, dtype=jnp.uint32)
        )
        keydata = _put_global(
            np.asarray(jax.vmap(jax.random.key_data)(keys)),
            NamedSharding(self.mesh, P("chains", None)),
        )
        return self._jit_init(
            self._sharded_neighbors(), keydata, self._adj_strip
        )

    def host_graph(self):
        """Resident specs only: host CSR of the same hash graph
        (threaded C++ enumeration) for validation/analysis."""
        if not self._resident:
            raise ValueError("host_graph() is for resident_spec colorers")
        from mcmc_colorer_tpu.ops.hashgen import hash_er_graph

        rn, rp, rseed = self.resident_spec
        return hash_er_graph(rn, rp, rseed, name=self.graph.name)

    def save_checkpoint(self, state, path: str) -> None:
        """Checkpoint the whole (chains, shards) ensemble to an ``.npz``.
        Multi-process safe: non-addressable shards are allgathered to
        every host first, so any host's file is complete."""
        d = {
            name: _host_get(x)
            for name, x in zip(self._STATE_FIELDS, state)
        }
        d["n_nodes"] = self.graph.n
        d["n_colors"] = self.params.n_colors
        d["n_chains"] = self.n_chains
        # tmp + atomic rename: a kill mid-write must not destroy the
        # previous good checkpoint (review r5)
        import os

        tmp = path + ".tmp.npz"
        np.savez(tmp, **d)
        os.replace(tmp, path if path.endswith(".npz") else path + ".npz")

    def load_checkpoint(self, path: str):
        """Rebuild device-resident ensemble state from an ``.npz``; the
        mesh geometry may differ from the writer's (state re-shards)."""
        if not path.endswith(".npz"):
            path = path + ".npz"
        d = np.load(path)
        assert int(d["n_nodes"]) == self.graph.n, "graph mismatch"
        assert int(d["n_colors"]) == self.params.n_colors, "palette mismatch"
        assert int(d["n_chains"]) == self.n_chains, "chain-count mismatch"

        def repad(name, a):
            # mesh geometries pad the vertex axis differently; slots past
            # the real vertices are phantoms (color nCol, taboo/cnt 0), so
            # trimming/extending them is exact
            if name not in ("colors", "taboo", "cnt"):
                return a
            want = self._n_pad
            if a.shape[1] == want:
                return a
            fill = self.params.n_colors if name == "colors" else 0
            out = np.full((a.shape[0], want), fill, a.dtype)
            keep = min(want, a.shape[1])
            out[:, :keep] = a[:, :keep]
            return out

        return tuple(
            _put_global(
                repad(name, d[name])
                if name in d.files
                # pre-round-5 checkpoints lack the acceptance counters
                else np.zeros((self.n_chains, 2), np.int32),
                sh,
            )
            for name, sh in zip(self._STATE_FIELDS, self._state_shardings())
        )

    def run(
        self,
        seed: int,
        repetition: int = 0,
        segment: int | None = None,
        checkpoint_path: str | None = None,
        resume_from: str | None = None,
    ):
        """Returns (best Coloring [tailcut applied if configured],
        per-chain summaries).

        ``segment``/``checkpoint_path``/``resume_from`` drive the loop in
        host-visible segments with periodic ensemble checkpoints (the
        reference has no checkpointing at all, SURVEY §6; segments reuse
        ONE compiled program since the limit is a traced scalar)."""
        root = rngu.for_repetition(rngu.root_key(seed), repetition)
        neighbors = self._sharded_neighbors()
        t0 = time.perf_counter()
        if resume_from:
            state = self.load_checkpoint(resume_from)
        else:
            state = self.init_state(seed, repetition)
        z = self.params.tailcut_threshold(self.graph.n)
        maxr = self.params.max_iterations
        if segment is not None:
            # fixed-size segments (explicit request)
            while True:
                rip_h = int(_host_get(state[4]))
                if rip_h >= maxr or not (_host_get(state[5]) > z).any():
                    break
                state = self._jit_segment(
                    neighbors,
                    self._adj_strip,
                    state,
                    jnp.int32(min(rip_h + segment, maxr)),
                )
                if checkpoint_path:
                    self.save_checkpoint(state, checkpoint_path)
        else:
            # adaptive segments (utils/segmented.py)
            from mcmc_colorer_tpu.utils.segmented import drive_segments

            def seg_fn(st, b):
                rip_h = int(_host_get(st[4]))
                return self._jit_segment(
                    neighbors,
                    self._adj_strip,
                    st,
                    jnp.int32(min(rip_h + b, maxr)),
                )

            def progress(st):
                rip_h = int(_host_get(st[4]))
                done = rip_h >= maxr or not (_host_get(st[5]) > z).any()
                return rip_h, done

            on_seg = (
                (lambda st, *_a: self.save_checkpoint(st, checkpoint_path))
                if checkpoint_path
                else None
            )
            state = drive_segments(
                seg_fn, state, progress, on_segment=on_seg
            )
        colors, rip, conflicts, traces, eps_scale = (
            state[0], state[4], state[5], state[6], state[7]
        )
        accstats = _host_get(state[10])
        colors = _host_get(colors)[:, : self.graph.n]
        conflicts = _host_get(conflicts).copy()
        traces = _host_get(traces)
        rip = int(_host_get(rip))
        dur = (time.perf_counter() - t0) * 1e3

        stds = np.array(
            [
                np.bincount(c, minlength=self.params.n_colors).std()
                for c in colors
            ]
        )
        order = np.lexsort((stds, conflicts))
        best = int(order[0])
        z = self.params.tailcut_threshold(self.graph.n)
        best_colors = colors[best]
        tc_rounds = 0
        if (
            self.params.tailcut
            and conflicts[best] > 0
            and self._resident
        ):
            # strip-native independent-set repair (the resident graph
            # has no neighbor rows for the rank-space tailcut below)
            pad = np.full(self._n_pad, self.params.n_colors, np.int32)
            pad[: self.graph.n] = best_colors
            cols = jnp.asarray(pad)
            tc_round = jax.jit(
                partial(
                    _tailcut_strips_round,
                    mesh=self.mesh,
                    params=self.params,
                    n_nodes=self.graph.n,
                )
            )
            conf = int(conflicts[best])
            max_rounds = 16 + 2 * conf
            k = rngu.for_iteration(root, 999_999)
            nc_carry = None
            while conf > 0 and tc_rounds < max_rounds:
                k, kr = jax.random.split(k)
                # the previous round's exit NC is this round's entry NC
                # (same coloring) — threading it halves the bit-matmul
                # contractions per repair round
                if nc_carry is None:
                    cols, confj, nc_carry = tc_round(
                        self._adj_strip, cols, jax.random.key_data(kr)
                    )
                else:
                    cols, confj, nc_carry = tc_round(
                        self._adj_strip,
                        cols,
                        jax.random.key_data(kr),
                        nc_carry,
                    )
                conf = int(_host_get(confj))
                tc_rounds += 1
            best_colors = _host_get(cols)[: self.graph.n]
            conflicts[best] = conf
        elif self.params.tailcut and conflicts[best] > 0:
            # shard-resident tail-cutting of the best chain: reuses the
            # sharded ELL rows in place (the round-1 version rebuilt a
            # flat single-device rectangle on the host — at the 1M scale
            # the sharded path exists for, that defeats sharding)
            from mcmc_colorer_tpu.utils.segmented import drive_segments

            pad = np.full(self._n_pad, self.params.n_colors, np.int32)
            pad[: self.graph.n] = best_colors
            nc = self.params.n_colors
            cols_r, ordered = jax.jit(
                partial(
                    _sharded_tailcut_rank, n_colors=nc, n_nodes=self.graph.n
                )
            )(jnp.asarray(pad))
            tc_seg = jax.jit(
                partial(
                    _run_tailcut_sharded,
                    mesh=self.mesh,
                    params=self.params,
                    block=self.block,
                    n_nodes=self.graph.n,
                )
            )
            k_tc = rngu.for_iteration(root, 999_999)
            tc = drive_segments(
                lambda c, b: tc_seg(
                    neighbors, c[0], k_tc, c[2], jnp.int32(b)
                ),
                (cols_r, jnp.int32(2**30), jnp.int32(0), jnp.bool_(False)),
                lambda c: (int(_host_get(c[2])), bool(_host_get(c[3]))),
            )
            cols = jax.jit(
                partial(
                    _sharded_tailcut_unrank,
                    n_colors=nc,
                    n_nodes=self.graph.n,
                )
            )(tc[0], ordered)
            best_colors = _host_get(cols)[: self.graph.n]
            conflicts[best] = int(_host_get(tc[1]))
            tc_rounds = int(_host_get(tc[2]))

        summaries = [
            {
                "chain": int(i),
                "conflicts": int(conflicts[i]),
                "class_std": float(stds[i]),
                "accepted_sweeps": int(accstats[i, 0]),
                "attempted_sweeps": int(accstats[i, 1]),
            }
            for i in range(self.n_chains)
        ]
        coloring = Coloring(
            colors=best_colors,
            n_colors=self.params.n_colors,
            iterations=rip,
            converged=int(conflicts[best]) <= max(z, 0),
            duration_ms=dur,
            conflict_trace=np.asarray(traces[best])[: rip + 1],
            extra={
                "final_conflicts": int(conflicts[best]),
                "max_iter_reached": rip >= self.params.max_iterations,
                "best_chain": best,
                "n_chains": self.n_chains,
                "tailcut_rounds": tc_rounds,
                "final_eps_scale": float(eps_scale),
                "accepted_sweeps": int(accstats[best, 0]),
                "attempted_sweeps": int(accstats[best, 1]),
            },
        )
        return coloring, summaries


# ------------------------------ shard_map body -----------------------------


# resident strip cache: hash graphs have no host Graph object to hang
# the per-graph cache off, so key on (spec, n_pad, devices) here
_RESIDENT_STRIP_CACHE: dict = {}


def _resident_strips(spec: tuple, n_pad: int, mesh: Mesh):
    """Per-shard hash-generated packed adjacency strips (cached like the
    ELL-built strips: repeated colorers on one spec reuse the build)."""
    from mcmc_colorer_tpu.ops.hashgen import er_packed_strips_on_device

    rn, rp, rseed = spec
    ck = (
        rn, float(rp), int(rseed), n_pad,
        tuple(int(d.id) for d in mesh.devices.flat),
    )
    if ck not in _RESIDENT_STRIP_CACHE:
        # the strips are device-memory-sized; keep only the most recent spec so
        # sweeping many graphs in one process can't accumulate them
        # (the ELL-strip cache hangs off the Graph object and dies with
        # it — a module-level cache needs explicit eviction)
        _RESIDENT_STRIP_CACHE.clear()
        _RESIDENT_STRIP_CACHE[ck] = er_packed_strips_on_device(
            rn, rp, rseed, n_pad, mesh
        )
    return _RESIDENT_STRIP_CACHE[ck]


def _build_packed_strips(neighbors, mesh: Mesh, target_slots=40_000_000):
    """[n_pad, words] uint32 bit-packed adjacency, rows sharded
    P('shards', None) — each shard's slice IS its [n_loc, n_pad] strip in
    the ``packed_bit_coords`` bit order (ops/dense_adj.py).

    Built band-wise from the already-sharded ELL: every call packs the
    same local row band on every shard (scatter a dense int8 strip, fold
    to uint32 words), driven from the host so each execution's scratch
    stays bounded.  Nothing ships from the host and nothing crosses the
    mesh — each shard scatters only its own rows."""
    from mcmc_colorer_tpu.ops.dense_adj import (
        pack_ell_rows,
        packed_adj_words,
    )

    n_pad, d_pad = neighbors.shape
    ms = mesh.shape["shards"]
    n_loc = n_pad // ms
    words = packed_adj_words(n_pad)
    k_total = words * 32
    # band height: multiple of 8 dividing n_loc (128 | n_loc by
    # construction), scratch z <= ~1.5 GB, flat int32 indices in range,
    # and <= target_slots scattered slots per execution
    cap_rows = max(
        8,
        min(
            1536 * 1024**2 // (k_total * 5),
            (2**31 - 1) // k_total,
            target_slots // max(d_pad, 1),
        ),
    )
    bh = 8
    d = 8
    while d <= n_loc:
        if n_loc % d == 0 and d <= cap_rows:
            bh = d
        d *= 2

    def band_body(a_loc, neigh_loc, r0):
        nb = jax.lax.dynamic_slice(neigh_loc, (r0, 0), (bh, d_pad))
        packed = pack_ell_rows(nb, n_pad)
        return jax.lax.dynamic_update_slice(a_loc, packed, (r0, 0))

    band = jax.jit(
        jax.shard_map(
            band_body,
            mesh=mesh,
            in_specs=(P("shards", None), P("shards", None), P()),
            out_specs=P("shards", None),
            check_vma=False,
        ),
        donate_argnums=(0,),
    )
    a = jax.jit(
        lambda: jnp.zeros((n_pad, words), jnp.uint32),
        out_shardings=NamedSharding(mesh, P("shards", None)),
    )()
    for r0 in range(0, n_loc, bh):
        a = band(a, neighbors, jnp.int32(r0))
    return a


def _strip_fits(strip_bytes: int, mesh: Mesh) -> bool:
    """Whether one shard's packed strip fits the mesh devices' memory."""
    from mcmc_colorer_tpu.ops.dense_adj import adjacency_fits, device_capacity

    return adjacency_fits(
        strip_bytes, min(device_capacity(d) for d in mesh.devices.flat)
    )


def _strip_nc(strip_loc, cf, full_real, n_colors):
    """[n_loc, n_col_pad] neighbor color counts of the owned vertices
    from this shard's packed strip (shared by the segment's nc_of, the
    NC init and the strip tailcut)."""
    from mcmc_colorer_tpu.ops.dense_adj import neighbor_color_counts

    return neighbor_color_counts(strip_loc, cf, n_colors, full_real)


def _nc_own_count(nc, own):
    """[n_loc] same-color-neighbor counts read out of an NC matrix —
    NC[i, own_i] without a gather (compare-sum over the color axis, as
    in _sweep_matmul; phantom strip rows are all-zero, contributing 0)."""
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, nc.shape[1]), 1)
    return jnp.sum(
        jnp.where(col_ids == own[:, None], nc, 0),
        axis=1,
        dtype=jnp.int32,
    )


def _run_sharded_segment(
    neighbors,   # [n_pad, d_pad] sharded P('shards', None)
    adj_strip,   # [n_pad, words] uint32 sharded P('shards', None), or None
    state,       # ShardedState pytree (see _sharded_init for shardings)
    rip_limit,   # int32 scalar (replicated): stop when rip reaches it
    *,
    mesh: Mesh,
    params: MCMCParams,
    block: int,
    chains_per_dev: int,
    anneal: AnnealConfig,
    n_nodes: int,
    backend: str = "xla",
    active_cap: int | None = None,
    rows_from_strip: int | None = None,
):
    """Advance the sharded ensemble from ``state`` until every chain
    converged or ``rip`` reaches ``rip_limit`` (a traced scalar — ONE
    compiled program serves every segment length).  Segmenting the loop at
    a jit boundary is what enables host-visible checkpoint/resume of the
    whole (chains, shards) ensemble."""
    n_pad, d_pad = neighbors.shape
    ms = mesh.shape["shards"]
    n_loc = n_pad // ms
    cl = chains_per_dev
    cap = active_cap
    n_colors = params.n_colors
    z = jnp.int32(params.tailcut_threshold(n_nodes))
    eps_cap = 0.4 / max(n_colors - 1, 1)

    def body_fn(
        neigh_loc,
        strip_loc,
        colors0,
        taboo0,
        cnt0,
        keydata0,
        rip0,
        conflicts0,
        trace0,
        eps0,
        pp0,
        stall0,
        accstats0,
        rip_lim,
    ):
        shard_id = jax.lax.axis_index("shards")
        offset = shard_id.astype(jnp.int32) * jnp.int32(n_loc)
        self_gids = offset + jnp.arange(n_loc, dtype=jnp.int32)
        real_loc = self_gids < jnp.int32(n_nodes)
        full_real = jnp.arange(n_pad, dtype=jnp.int32) < jnp.int32(n_nodes)

        # PRNG keys cross the shard_map boundary as raw uint32 key data
        # (checkpointable with plain npz; avoids extended-dtype specs)
        loop_keys = jax.vmap(jax.random.wrap_key_data)(keydata0)

        def cnt_of(cf):
            """[n_loc] same-color-neighbor counts of the owned vertices
            (one full local gather)."""
            cf_ext = jnp.concatenate([cf, jnp.full((1,), -1, jnp.int32)])
            nc = jnp.take(cf_ext, neigh_loc, axis=0)
            own = jnp.take(cf, jnp.clip(self_gids, 0, n_pad - 1))
            return jnp.sum((nc == own[:, None]).astype(jnp.int32), axis=1)

        def conflicts_from_cnt(cnt):
            """[cl] global conflict-edge counts: each conflict edge is
            counted by the owners of both endpoints, so the psum'd total
            halves exactly (distributed ``idx < neigh`` dedup)."""
            local = jnp.sum(cnt, axis=1, dtype=jnp.int32)
            return jax.lax.psum(local, "shards") // 2

        n_col_pad = (n_colors + 127) // 128 * 128

        def nc_of(cf):
            """[n_loc, n_col_pad] neighbor color counts of the owned
            vertices as ONE contraction against this shard's packed
            adjacency strip (matmul backend; the sharded rendition of
            ops/dense_adj.py:neighbor_color_counts).  Subsumes the
            occupancy, the per-vertex same-color counts, AND the
            Hastings reverse occupancy — no neighbor gathers at all."""
            return _strip_nc(strip_loc, cf, full_real, n_colors)

        def cnt_of_nc(nc, cf):
            own = jnp.take(cf, jnp.clip(self_gids, 0, n_pad - 1))
            return _nc_own_count(nc, own)

        undone0 = jax.lax.psum(
            jnp.sum((conflicts0 > z).astype(jnp.int32)), "chains"
        )

        def cond(carry):
            (_, _, _, _, rip, conflicts, _, undone, *_a) = carry
            return (
                (undone > 0)
                & (rip < rip_lim)
                & (rip < jnp.int32(params.max_iterations))
            )

        def loop_body(carry):
            (
                colors_full,
                taboo,
                cnt,
                ks,
                rip,
                conflicts,
                trace,
                undone,
                eps_scale,
                prev_pooled,
                stall,
                accstats,
            ) = carry
            active = conflicts > z  # [cl]
            eps_eff = jnp.minimum(
                jnp.float32(params.epsilon) * eps_scale, eps_cap
            )

            def chain_sweep(cf, tb, key):
                key, ku = jax.random.split(key)
                u_loc = jax.random.uniform(
                    jax.random.fold_in(ku, shard_id),
                    (n_loc,),
                    dtype=jnp.float32,
                )
                if _needs_histogram(params):
                    hist = (
                        jnp.zeros((n_colors,), jnp.int32)
                        .at[jnp.where(full_real, cf, n_colors)]
                        .add(1, mode="drop")
                    )
                else:
                    hist = None
                p_eff = _variant_distribution(params, hist, n_nodes)
                cf_ext = jnp.concatenate(
                    [cf, jnp.full((1,), -1, jnp.int32)]
                )
                cur_loc = jnp.take(cf, jnp.clip(self_gids, 0, n_pad - 1))

                if backend == "matmul":
                    # occupancy from this shard's strip contraction; the
                    # proposal math is the gather branch's, verbatim, on
                    # the padded color axis — bit-identical chains
                    nc_full = nc_of(cf)
                    p_eff_pad = None
                    if p_eff is not None:
                        p_eff_pad = (
                            jnp.zeros((n_col_pad,), jnp.float32)
                            .at[:n_colors]
                            .set(p_eff)
                        )
                    n_blocks = n_loc // block

                    def block_fn_mm(xs):
                        nc_blk, cur_b, tb_b, u_b, real_b = xs
                        occ = nc_blk > 0
                        q = _proposal_q(
                            cur_b,
                            occ,
                            params,
                            p_eff_pad,
                            eps_eff,
                            n_colors=n_colors,
                        )
                        chosen = _sample_cdf(q, u_b, n_colors=n_colors)
                        qstar = jnp.take_along_axis(
                            q, chosen[:, None], axis=1
                        )[:, 0]
                        t_act = tb_b > 0
                        keep_prob = 1.0 - (n_colors - 1) * eps_eff
                        chosen = jnp.where(t_act, cur_b, chosen)
                        qstar = jnp.where(t_act, keep_prob, qstar)
                        new_tb = jnp.where(
                            t_act,
                            tb_b - 1,
                            jnp.where(
                                chosen == cur_b,
                                jnp.int32(params.taboo_iterations),
                                0,
                            ),
                        )
                        chosen = jnp.where(real_b, chosen, cur_b)
                        qstar = jnp.where(real_b, qstar, 1.0)
                        logq = jnp.sum(jnp.log(jnp.maximum(qstar, 1e-30)))
                        return chosen, new_tb, logq

                    xs = (
                        nc_full.reshape(n_blocks, block, n_col_pad),
                        cur_loc.reshape(n_blocks, block),
                        tb.reshape(n_blocks, block),
                        u_loc.reshape(n_blocks, block),
                        real_loc.reshape(n_blocks, block),
                    )
                    star_b, tb_b, logq_b = jax.lax.map(block_fn_mm, xs)
                    return (
                        star_b.reshape(n_loc),
                        tb_b.reshape(n_loc),
                        key,
                        jnp.sum(logq_b),
                    )

                n_blocks = n_loc // block

                def block_fn(xs):
                    nb, cur_b, tb_b, u_b, real_b = xs
                    nc = jnp.take(cf_ext, nb, axis=0)
                    occ = occupancy_matrix(nc, n_colors)
                    q = _proposal_q(cur_b, occ, params, p_eff, eps_eff)
                    chosen = _sample_cdf(q, u_b)
                    qstar = jnp.take_along_axis(
                        q, chosen[:, None], axis=1
                    )[:, 0]
                    t_act = tb_b > 0
                    keep_prob = 1.0 - (n_colors - 1) * eps_eff
                    chosen = jnp.where(t_act, cur_b, chosen)
                    qstar = jnp.where(t_act, keep_prob, qstar)
                    new_tb = jnp.where(
                        t_act,
                        tb_b - 1,
                        jnp.where(
                            chosen == cur_b,
                            jnp.int32(params.taboo_iterations),
                            0,
                        ),
                    )
                    chosen = jnp.where(real_b, chosen, cur_b)
                    qstar = jnp.where(real_b, qstar, 1.0)
                    logq = jnp.sum(jnp.log(jnp.maximum(qstar, 1e-30)))
                    return chosen, new_tb, logq

                xs = (
                    neigh_loc.reshape(n_blocks, block, d_pad),
                    cur_loc.reshape(n_blocks, block),
                    tb.reshape(n_blocks, block),
                    u_loc.reshape(n_blocks, block),
                    real_loc.reshape(n_blocks, block),
                )
                star_b, tb_b, logq_b = jax.lax.map(block_fn, xs)
                return (
                    star_b.reshape(n_loc),
                    tb_b.reshape(n_loc),
                    key,
                    jnp.sum(logq_b),
                )

            def reverse_logq_loc(cf, star_full):
                """Σ log q(old | star) over the OWNED vertices — the
                vectorized lookOldColoring (coloringMCMC_standard.cu:88-135)
                per shard; the global sum is one psum away."""
                star_ext = jnp.concatenate(
                    [star_full, jnp.full((1,), -1, jnp.int32)]
                )
                cur_loc = jnp.take(cf, jnp.clip(self_gids, 0, n_pad - 1))
                star_own = jnp.take(
                    star_full, jnp.clip(self_gids, 0, n_pad - 1)
                )
                n_blocks = n_loc // block

                def blk(xs):
                    nb, cur_b, star_b, real_b = xs
                    nc = jnp.take(star_ext, nb, axis=0)
                    occ = occupancy_matrix(nc, n_colors)
                    zn = jnp.sum(occ, axis=1, dtype=jnp.int32)
                    zp = jnp.int32(n_colors) - zn
                    cidx = jnp.clip(cur_b, 0, n_colors - 1)[:, None]
                    sidx = jnp.clip(star_b, 0, n_colors - 1)[:, None]
                    occ_star = jnp.take_along_axis(occ, sidx, axis=1)[:, 0]
                    occ_cur = jnp.take_along_axis(occ, cidx, axis=1)[:, 0]
                    move_q = jnp.where(
                        occ_cur,
                        eps_eff,
                        (1.0 - eps_eff * zn.astype(jnp.float32))
                        / jnp.maximum(zp, 1).astype(jnp.float32),
                    )
                    keep_q = jnp.where(
                        star_b == cur_b,
                        1.0 - (n_colors - 1) * eps_eff,
                        eps_eff,
                    )
                    q_old = jnp.where(occ_star, move_q, keep_q)
                    q_old = jnp.where(zp == 0, 1.0, q_old)
                    q_old = jnp.where(real_b, q_old, 1.0)
                    return jnp.sum(jnp.log(jnp.maximum(q_old, 1e-30)))

                xs = (
                    neigh_loc.reshape(n_blocks, block, d_pad),
                    cur_loc.reshape(n_blocks, block),
                    star_own.reshape(n_blocks, block),
                    real_loc.reshape(n_blocks, block),
                )
                return jnp.sum(jax.lax.map(blk, xs))

            def reverse_logq_nc(nc_star, cf, star_full):
                """`reverse_logq_loc` fed by the precomputed NC(star)
                strip (matmul backend; mirrors
                models/mcmc.py:_reverse_logq_matmul per shard)."""
                cur_loc = jnp.take(cf, jnp.clip(self_gids, 0, n_pad - 1))
                star_own = jnp.take(
                    star_full, jnp.clip(self_gids, 0, n_pad - 1)
                )
                n_blocks = n_loc // block

                def blk(xs):
                    nc_blk, cur_b, star_b, real_b = xs
                    col_ids = jax.lax.broadcasted_iota(
                        jnp.int32, (1, n_col_pad), 1
                    )
                    occ = nc_blk > 0
                    col_valid = col_ids < n_colors
                    zn = jnp.sum(occ & col_valid, axis=1, dtype=jnp.int32)
                    zp = jnp.int32(n_colors) - zn
                    occ_star = (
                        jnp.sum(
                            jnp.where(
                                col_ids == star_b[:, None], nc_blk, 0
                            ),
                            axis=1,
                            dtype=jnp.int32,
                        )
                        > 0
                    )
                    occ_cur = (
                        jnp.sum(
                            jnp.where(
                                col_ids == cur_b[:, None], nc_blk, 0
                            ),
                            axis=1,
                            dtype=jnp.int32,
                        )
                        > 0
                    )
                    move_q = jnp.where(
                        occ_cur,
                        eps_eff,
                        (1.0 - eps_eff * zn.astype(jnp.float32))
                        / jnp.maximum(zp, 1).astype(jnp.float32),
                    )
                    keep_q = jnp.where(
                        star_b == cur_b,
                        1.0 - (n_colors - 1) * eps_eff,
                        eps_eff,
                    )
                    q_old = jnp.where(occ_star, move_q, keep_q)
                    q_old = jnp.where(zp == 0, 1.0, q_old)
                    q_old = jnp.where(real_b, q_old, 1.0)
                    return jnp.sum(jnp.log(jnp.maximum(q_old, 1e-30)))

                xs = (
                    nc_star.reshape(n_blocks, block, n_col_pad),
                    cur_loc.reshape(n_blocks, block),
                    star_own.reshape(n_blocks, block),
                    real_loc.reshape(n_blocks, block),
                )
                return jnp.sum(jax.lax.map(blk, xs))

            def full_branch(cf, tb, cnt_c, key):
                """Full synchronous sweep + halo exchange + cnt recompute
                (the recompute IS the conflict count's gather).  With
                ``hastings`` the λ-weighted acceptance gates the swap —
                the shard-replicated chain key draws one uniform, so all
                shards agree (coloringMCMC_main.cu:223-261, gated here
                unlike the shipped reference, SURVEY §9.2)."""
                star_loc, new_tb, key, logq_star_loc = chain_sweep(
                    cf, tb, key
                )
                star_full = jax.lax.all_gather(
                    star_loc, "shards", axis=0, tiled=True
                )
                nc_star = nc_of(star_full) if backend == "matmul" else None
                cnt_star = (
                    cnt_of_nc(nc_star, star_full)
                    if backend == "matmul"
                    else cnt_of(star_full)
                )
                if params.hastings:
                    key, k_acc = jax.random.split(key)
                    logq_star = jax.lax.psum(logq_star_loc, "shards")
                    logq_old = jax.lax.psum(
                        reverse_logq_nc(nc_star, cf, star_full)
                        if backend == "matmul"
                        else reverse_logq_loc(cf, star_full),
                        "shards",
                    )
                    conf_old = (
                        jax.lax.psum(
                            jnp.sum(cnt_c, dtype=jnp.int32), "shards"
                        )
                        // 2
                    )
                    conf_star = (
                        jax.lax.psum(
                            jnp.sum(cnt_star, dtype=jnp.int32), "shards"
                        )
                        // 2
                    )
                    log_ratio = (
                        -jnp.float32(params.lambda_)
                        * (conf_star - conf_old).astype(jnp.float32)
                        + logq_old
                        - logq_star
                    )
                    accept = (
                        jnp.log(
                            jnp.maximum(
                                jax.random.uniform(
                                    k_acc, (), dtype=jnp.float32
                                ),
                                1e-30,
                            )
                        )
                        < log_ratio
                    )
                    star_full = jnp.where(accept, star_full, cf)
                    cnt_star = jnp.where(accept, cnt_star, cnt_c)
                else:
                    # the shipped reference swaps unconditionally
                    # (SURVEY §9.2): every sweep counts as accepted
                    accept = jnp.bool_(True)
                return star_full, new_tb, cnt_star, key, accept

            def active_branch(cf, tb, cnt_c, key):
                """Frontier sweep: resample only the ≤cap eligible owned
                vertices (cnt>0, taboo-free); apply passive dynamics
                (taboo decrement/reset + one sparse ε-flip) to the rest;
                maintain cnt exactly from the changed vertices' rows via
                one psum'd delta vector.  Mirrors
                models/mcmc_active.py:_active_iteration per shard."""
                key, ku, kf1, kf2, kf3 = jax.random.split(key, 5)
                t_iter = jnp.int32(params.taboo_iterations)
                eligible = (cnt_c > 0) & (tb == 0) & real_loc
                (lids,) = jnp.nonzero(eligible, size=cap, fill_value=n_loc)
                lvalid = lids < n_loc
                lids_c = jnp.minimum(lids, n_loc - 1)
                gids = jnp.where(lvalid, offset + lids, jnp.int32(n_pad))
                if rows_from_strip is not None:
                    from mcmc_colorer_tpu.ops.dense_adj import (
                        packed_rows_to_ids,
                    )

                    # resident: slice the ≤cap owned rows from the
                    # packed strip and unpack to ascending id lists
                    # (order-invariant for every consumer below)
                    rows = packed_rows_to_ids(
                        jnp.take(strip_loc, lids_c, axis=0),
                        rows_from_strip,
                        n_pad,
                    )
                else:
                    rows = jnp.take(neigh_loc, lids_c, axis=0)
                rows = jnp.where(lvalid[:, None], rows, jnp.int32(n_pad))
                cur = jnp.where(
                    lvalid,
                    jnp.take(cf, jnp.minimum(gids, n_pad - 1)),
                    jnp.int32(n_colors),
                )
                cf_ext = jnp.concatenate(
                    [cf, jnp.full((1,), -1, jnp.int32)]
                )
                nc = jnp.take(cf_ext, rows, axis=0)
                if _needs_histogram(params):
                    hist = (
                        jnp.zeros((n_colors,), jnp.int32)
                        .at[jnp.where(full_real, cf, n_colors)]
                        .add(1, mode="drop")
                    )
                else:
                    hist = None
                p_eff = _variant_distribution(params, hist, n_nodes)
                u = jax.random.uniform(
                    jax.random.fold_in(ku, shard_id),
                    (cap,),
                    dtype=jnp.float32,
                )
                occ = occupancy_matrix(nc, n_colors)
                q = _proposal_q(cur, occ, params, p_eff, eps_eff)
                chosen = _sample_cdf(q, u)
                new_tb_a = jnp.where(chosen == cur, t_iter, 0)
                chosen = jnp.where(lvalid, chosen, cur)

                # sparse ε-flip: with prob 1-(1-(nCol-1)ε)^|passive| one
                # passive vertex redraws a non-current color (chain-level
                # decision — the chain key is replicated over shards)
                p_per = jnp.minimum(
                    (n_colors - 1)
                    * jnp.asarray(eps_eff, jnp.float32),
                    jnp.float32(0.999999),
                )
                passive = (cnt_c == 0) & (tb == 0) & real_loc
                n_passive = jax.lax.psum(
                    jnp.sum(passive.astype(jnp.float32)), "shards"
                )
                p_any = 1.0 - jnp.exp(n_passive * jnp.log1p(-p_per))
                do_flip = jax.random.uniform(kf1, ()) < p_any
                fv = jax.random.randint(
                    kf2, (), 0, n_nodes, dtype=jnp.int32
                )
                fv_lid = fv - offset
                fv_mine = (fv_lid >= 0) & (fv_lid < n_loc)
                fv_lid_c = jnp.clip(fv_lid, 0, n_loc - 1)
                fv_elig = fv_mine & jnp.take(passive, fv_lid_c)
                fv_ok = do_flip & (
                    jax.lax.psum(fv_elig.astype(jnp.int32), "shards") > 0
                )
                fv_old = jnp.take(cf, fv)
                offs = jax.random.randint(
                    kf3, (), 1, max(n_colors, 2), dtype=jnp.int32
                )
                fv_new = jax.lax.rem(fv_old + offs, jnp.int32(n_colors))
                x_valid = fv_ok & fv_elig
                x_lid = jnp.where(x_valid, fv_lid_c, jnp.int32(n_loc))
                if rows_from_strip is not None:
                    from mcmc_colorer_tpu.ops.dense_adj import (
                        packed_rows_to_ids,
                    )

                    x_row = packed_rows_to_ids(
                        strip_loc[fv_lid_c][None],
                        rows_from_strip,
                        n_pad,
                    )[0]
                else:
                    x_row = jnp.take(neigh_loc, fv_lid_c, axis=0)
                x_row = jnp.where(x_valid, x_row, jnp.int32(n_pad))

                # changed-slot arrays: the ≤cap frontier plus the flip slot
                lids2 = jnp.concatenate([lids, x_lid[None]])
                lvalid2 = jnp.concatenate([lvalid, x_valid[None]])
                old2 = jnp.concatenate([cur, fv_old[None]])
                new2 = jnp.concatenate(
                    [chosen, jnp.where(x_valid, fv_new, fv_old)[None]]
                )
                rows2 = jnp.concatenate([rows, x_row[None, :]], axis=0)

                # passive taboo dynamics: decrement if locked, else the
                # keep-draw resets to T; active slots take kernel results;
                # the flipped vertex drew a change -> 0
                tb_next = jnp.where(
                    tb > 0, tb - 1, jnp.where(real_loc, t_iter, 0)
                )
                tb_next = tb_next.at[lids].set(new_tb_a, mode="drop")
                tb_next = tb_next.at[x_lid].set(0, mode="drop")

                star_loc = jax.lax.dynamic_slice(cf, (offset,), (n_loc,))
                star_loc = star_loc.at[lids2].set(
                    jnp.where(lvalid2, new2, 0), mode="drop"
                )
                changed2 = lvalid2 & (new2 != old2)
                changed_loc = (
                    jnp.zeros((n_loc,), jnp.bool_)
                    .at[lids2]
                    .set(changed2, mode="drop")
                )
                # ONE all_gather moves both the new colors and the changed
                # flags (color<<1 | changed); sentinel -2 decodes to
                # color -1, changed 0
                packed_loc = jax.lax.shift_left(
                    star_loc, 1
                ) | changed_loc.astype(jnp.int32)
                packed_full = jax.lax.all_gather(
                    packed_loc, "shards", axis=0, tiled=True
                )
                star_full = jax.lax.shift_right_arithmetic(packed_full, 1)
                packed_ext = jnp.concatenate(
                    [packed_full, jnp.full((1,), -2, jnp.int32)]
                )
                nb2 = jnp.take(packed_ext, rows2, axis=0)
                t_changed = (nb2 & 1) == 1
                t_color = jax.lax.shift_right_arithmetic(nb2, 1)

                # cnt deltas: contributions to *unchanged* neighbors (a
                # changed neighbor's own recount already accounts for me),
                # plus exact recounts of the changed vertices themselves
                contrib = jnp.where(
                    changed2[:, None] & ~t_changed,
                    (t_color == new2[:, None]).astype(jnp.int32)
                    - (t_color == old2[:, None]).astype(jnp.int32),
                    0,
                )
                delta = (
                    jnp.zeros((n_pad,), jnp.int32)
                    .at[rows2.reshape(-1)]
                    .add(contrib.reshape(-1), mode="drop")
                )
                recount = jnp.sum(
                    (t_color == new2[:, None]).astype(jnp.int32), axis=1
                )
                cnt_old2 = jnp.take(cnt_c, jnp.clip(lids2, 0, n_loc - 1))
                self_t = jnp.where(
                    changed2, offset + jnp.minimum(lids2, n_loc - 1), n_pad
                )
                delta = delta.at[self_t].add(
                    jnp.where(changed2, recount - cnt_old2, 0), mode="drop"
                )
                delta = jax.lax.psum(delta, "shards")
                cnt_next = cnt_c + jax.lax.dynamic_slice(
                    delta, (offset,), (n_loc,)
                )
                return star_full, tb_next, cnt_next, key, jnp.bool_(True)

            # python loop over the per-device chains (cl is small & static)
            stars, taboos, cnts, keys_out, accs = [], [], [], [], []
            for c in range(cl):
                if cap is None:
                    s, t, ct, k, a = full_branch(
                        colors_full[c], taboo[c], cnt[c], ks[c]
                    )
                else:
                    elig_cnt = jnp.sum(
                        (
                            (cnt[c] > 0) & (taboo[c] == 0) & real_loc
                        ).astype(jnp.int32)
                    )
                    use_active = (
                        jax.lax.pmax(elig_cnt, "shards") <= jnp.int32(cap)
                    )
                    # the active branch approximates the passive dynamics
                    # with at most ONE ε-flip per sweep — valid only while
                    # the expected flip count n_passive·(nCol−1)·ε is
                    # small.  Pooled annealing can boost ε far beyond
                    # that; fall back to full sweeps there so the boost
                    # actually injects the exploration it is meant to.
                    n_passive = jax.lax.psum(
                        jnp.sum(
                            ((cnt[c] == 0) & real_loc).astype(jnp.float32)
                        ),
                        "shards",
                    )
                    p_per = jnp.minimum(
                        (n_colors - 1) * eps_eff, jnp.float32(0.999999)
                    )
                    use_active &= (n_passive * p_per) <= jnp.float32(1.0)
                    s, t, ct, k, a = jax.lax.cond(
                        use_active,
                        active_branch,
                        full_branch,
                        colors_full[c],
                        taboo[c],
                        cnt[c],
                        ks[c],
                    )
                stars.append(s)
                taboos.append(t)
                cnts.append(ct)
                keys_out.append(k)
                accs.append(a)
            star_full = jnp.stack(stars)       # [cl, n_pad] (replicated)
            new_taboo = jnp.stack(taboos)
            new_cnt = jnp.stack(cnts)
            new_keys = jnp.stack(keys_out)
            # per-chain acceptance bookkeeping (VERDICT r4 item 4): a
            # frozen (converged) chain neither attempts nor accepts
            acc_vec = jnp.stack(accs)
            accstats = accstats + jnp.stack(
                [
                    (acc_vec & active).astype(jnp.int32),
                    active.astype(jnp.int32),
                ],
                axis=1,
            )
            conflicts_star = conflicts_from_cnt(new_cnt)
            # freeze finished chains
            colors_next = jnp.where(
                active[:, None], star_full, colors_full
            )
            taboo_next = jnp.where(active[:, None], new_taboo, taboo)
            cnt_next = jnp.where(active[:, None], new_cnt, cnt)
            conflicts_next = jnp.where(active, conflicts_star, conflicts)
            rip = rip + 1
            trace = trace.at[:, rip].set(conflicts_next)
            undone = jax.lax.psum(
                jnp.sum((conflicts_next > z).astype(jnp.int32)), "chains"
            )
            # pooled annealing
            if anneal.enabled:
                pooled = (
                    jax.lax.psum(
                        jnp.sum(conflicts_next.astype(jnp.float32)),
                        "chains",
                    )
                    / jnp.float32(cl * mesh.shape["chains"])
                )
                rel = (prev_pooled - pooled) / jnp.maximum(prev_pooled, 1.0)
                stalled = rel < jnp.float32(anneal.tol)
                stall = jnp.where(stalled, stall + 1, 0)
                do_boost = stall >= jnp.int32(anneal.window)
                eps_scale = jnp.where(
                    do_boost, eps_scale * jnp.float32(anneal.boost), eps_scale
                )
                stall = jnp.where(do_boost, 0, stall)
                prev_pooled = pooled
            return (
                colors_next,
                taboo_next,
                cnt_next,
                new_keys,
                rip,
                conflicts_next,
                trace,
                undone,
                eps_scale,
                prev_pooled,
                stall,
                accstats,
            )

        init = (
            colors0,
            taboo0,
            cnt0,
            loop_keys,
            rip0,
            conflicts0,
            trace0,
            undone0,
            eps0,
            pp0,
            stall0,
            accstats0,
        )
        (
            colors_full,
            taboo_out,
            cnt_out,
            ks_out,
            rip,
            conflicts,
            trace,
            _undone,
            eps_scale,
            pp_out,
            stall_out,
            accstats_out,
        ) = jax.lax.while_loop(cond, loop_body, init)
        return (
            colors_full,
            taboo_out,
            cnt_out,
            jax.vmap(jax.random.key_data)(ks_out),
            rip,
            conflicts,
            trace,
            eps_scale,
            pp_out,
            stall_out,
            accstats_out,
        )

    state_specs = (
        P("chains", None),       # colors [C, n_pad]
        P("chains", "shards"),   # taboo  [C, n_pad]
        P("chains", "shards"),   # cnt    [C, n_pad]
        P("chains", None),       # key data [C, 2]
        P(),                     # rip
        P("chains"),             # conflicts [C]
        P("chains", None),       # trace [C, maxRip+1]
        P(),                     # eps_scale
        P(),                     # prev_pooled
        P(),                     # stall
        P("chains", None),       # accstats [C, 2] (accepted, attempted)
    )
    if adj_strip is None:
        mapped = jax.shard_map(
            lambda neigh_loc, *rest: body_fn(neigh_loc, None, *rest),
            mesh=mesh,
            in_specs=(P("shards", None),) + state_specs + (P(),),
            out_specs=state_specs,
            check_vma=False,
        )
        return mapped(neighbors, *state, rip_limit)
    mapped = jax.shard_map(
        body_fn,
        mesh=mesh,
        in_specs=(P("shards", None), P("shards", None))
        + state_specs
        + (P(),),
        out_specs=state_specs,
        check_vma=False,
    )
    return mapped(neighbors, adj_strip, *state, rip_limit)


def _sharded_init(
    neighbors,  # [n_pad, d_pad] sharded P('shards', None)
    keydata,    # [C, 2] uint32 key data, sharded P('chains', None)
    adj_strip=None,  # [n_pad, words] sharded P('shards', None), or None
    *,
    mesh: Mesh,
    params: MCMCParams,
    chains_per_dev: int,
    n_nodes: int,
):
    """Initial ensemble state (random colorings, counts, trace row 0) as a
    11-tuple matching `_run_sharded_segment`'s state specs.  With
    ``adj_strip`` the initial counts come from the NC contraction instead
    of the neighbor gather (bit-equal; required on resident graphs whose
    shim ELL has no real neighbor rows)."""
    n_pad, _ = neighbors.shape
    ms = mesh.shape["shards"]
    n_loc = n_pad // ms
    cl = chains_per_dev
    n_colors = params.n_colors
    use_nc = adj_strip is not None

    def body_fn(neigh_loc, keydata_loc, *maybe_strip):
        keys_loc = jax.vmap(jax.random.wrap_key_data)(keydata_loc)
        shard_id = jax.lax.axis_index("shards")
        offset = shard_id.astype(jnp.int32) * jnp.int32(n_loc)
        self_gids = offset + jnp.arange(n_loc, dtype=jnp.int32)
        full_real = jnp.arange(n_pad, dtype=jnp.int32) < jnp.int32(n_nodes)

        def init_chain(key):
            k_init, k_loop = jax.random.split(key)
            u = jax.random.uniform(k_init, (n_pad,), dtype=jnp.float32)
            cols = jnp.minimum(
                (u * n_colors).astype(jnp.int32), n_colors - 1
            )
            return jnp.where(full_real, cols, jnp.int32(n_colors)), k_loop

        colors0, loop_keys = jax.vmap(init_chain)(keys_loc)  # [cl, n_pad]

        if use_nc:
            strip_loc = maybe_strip[0]

            def cnt_of(cf):
                own = jnp.take(cf, jnp.clip(self_gids, 0, n_pad - 1))
                return _nc_own_count(
                    _strip_nc(strip_loc, cf, full_real, n_colors), own
                )

        else:

            def cnt_of(cf):
                cf_ext = jnp.concatenate(
                    [cf, jnp.full((1,), -1, jnp.int32)]
                )
                nc = jnp.take(cf_ext, neigh_loc, axis=0)
                own = jnp.take(cf, jnp.clip(self_gids, 0, n_pad - 1))
                return jnp.sum(
                    (nc == own[:, None]).astype(jnp.int32), axis=1
                )

        cnt0 = jax.vmap(cnt_of)(colors0)  # [cl, n_loc]
        conflicts0 = jax.lax.psum(
            jnp.sum(cnt0, axis=1, dtype=jnp.int32), "shards"
        ) // 2
        taboo0 = jnp.zeros((cl, n_loc), jnp.int32)
        trace0 = jnp.full((cl, params.max_iterations + 1), -1, jnp.int32)
        trace0 = trace0.at[:, 0].set(conflicts0)
        return (
            colors0,
            taboo0,
            cnt0,
            jax.vmap(jax.random.key_data)(loop_keys),
            conflicts0,
            trace0,
        )

    in_specs = [P("shards", None), P("chains", None)]
    args = [neighbors, keydata]
    if use_nc:
        in_specs.append(P("shards", None))
        args.append(adj_strip)
    mapped = jax.shard_map(
        body_fn,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(
            P("chains", None),
            P("chains", "shards"),
            P("chains", "shards"),
            P("chains", None),
            P("chains"),
            P("chains", None),
        ),
        check_vma=False,
    )
    colors0, taboo0, cnt0, keydata0, conflicts0, trace0 = mapped(*args)
    return (
        colors0,
        taboo0,
        cnt0,
        keydata0,
        jnp.int32(0),
        conflicts0,
        trace0,
        jnp.float32(1.0),
        jnp.float32(1e30),
        jnp.int32(0),
        jnp.zeros((keydata.shape[0], 2), jnp.int32),
    )


# ------------------------------ sharded tailcut -----------------------------


def _tailcut_strips_round(
    adj_strip,   # [n_pad, words] sharded P('shards', None)
    cols_full,   # [n_pad] int32 replicated (phantoms hold n_colors)
    keydata,     # raw uint32 key data (replicated)
    nc_prev=None,  # [n_loc, n_col_pad] P('shards', None): the previous
                   # round's exit NC (skips the entry contraction — the
                   # dominant cost of a round)
    *,
    mesh: Mesh,
    params: MCMCParams,
    n_nodes: int,
):
    """One strip-native independent-set repair round (the sharded
    rendition of models/mcmc_resident._tailcut_nc_round — the resident
    graph has no neighbor rows for the rank-space tailcut to gather):
    each shard flips coins over its conflicted owned vertices, ONE tiled
    all_gather shares the head set, heads with no head-neighbor (one
    ``strip & head_bits`` popcount pass) move to their first NC-free
    color, and a second all_gather publishes the new colors.  Movers are
    pairwise non-adjacent and land on colors unoccupied in their whole
    neighborhood, so conflicts are monotone while free colors exist.
    Returns (new cols_full replicated, global conflict count)."""
    from mcmc_colorer_tpu.models.mcmc_resident import _pack_mask

    n_pad = cols_full.shape[0]
    ms = mesh.shape["shards"]
    n_loc = n_pad // ms
    n_colors = params.n_colors

    def body(strip_loc, cols, kd, *maybe_nc):
        key = jax.random.wrap_key_data(kd)
        shard_id = jax.lax.axis_index("shards")
        offset = shard_id.astype(jnp.int32) * jnp.int32(n_loc)
        self_gids = offset + jnp.arange(n_loc, dtype=jnp.int32)
        real_loc = self_gids < jnp.int32(n_nodes)
        full_real = jnp.arange(n_pad, dtype=jnp.int32) < jnp.int32(n_nodes)

        own = jnp.take(cols, jnp.clip(self_gids, 0, n_pad - 1))
        nc = (
            maybe_nc[0]
            if maybe_nc
            else _strip_nc(strip_loc, cols, full_real, n_colors)
        )
        cnt = _nc_own_count(nc, own)
        conflicted = (cnt > 0) & real_loc
        heads = conflicted & (
            jax.random.uniform(
                jax.random.fold_in(key, shard_id),
                (n_loc,),
                dtype=jnp.float32,
            )
            < 0.5
        )
        heads_full = jax.lax.all_gather(
            heads, "shards", axis=0, tiled=True
        )
        head_bits = _pack_mask(heads_full, strip_loc.shape[1])
        nbr_heads = jnp.sum(
            jax.lax.population_count(
                strip_loc & head_bits[None, :]
            ).astype(jnp.int32),
            axis=1,
        )
        movers = heads & (nbr_heads == 0)
        n_col_pad = nc.shape[1]
        col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, n_col_pad), 1)
        free = (nc == 0) & (col_ids < n_colors)
        first_free = jnp.argmax(free, axis=1).astype(jnp.int32)
        has_free = jnp.any(free, axis=1)
        fallback = jnp.argmin(
            jnp.where(col_ids < n_colors, nc, jnp.int32(2**30)), axis=1
        ).astype(jnp.int32)
        newc = jnp.where(has_free, first_free, fallback)
        cols_loc = jnp.where(movers, newc, own)
        cols_new = jax.lax.all_gather(
            cols_loc, "shards", axis=0, tiled=True
        )
        nc2 = _strip_nc(strip_loc, cols_new, full_real, n_colors)
        own2 = jnp.take(cols_new, jnp.clip(self_gids, 0, n_pad - 1))
        cnt2 = _nc_own_count(nc2, own2)
        conflicts = (
            jax.lax.psum(
                jnp.sum(jnp.where(real_loc, cnt2, 0), dtype=jnp.int32),
                "shards",
            )
            // 2
        )
        return cols_new, conflicts, nc2

    in_specs = [P("shards", None), P(), P()]
    args = [adj_strip, cols_full, keydata]
    if nc_prev is not None:
        in_specs.append(P("shards", None))
        args.append(nc_prev)
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(), P(), P("shards", None)),
        check_vma=False,
    )
    return mapped(*args)


def _run_tailcut_sharded(
    neighbors,     # [n_pad, d_pad] sharded P('shards', None)
    cols_r,        # [n_pad] replicated RANK-SPACE colors
                   # (_sharded_tailcut_rank; phantoms hold nCol)
    key,
    rounds0,       # int32 scalar: global round index at segment entry
    budget,        # int32 scalar: max rounds this execution (traced —
                   # see utils/segmented.py)
    *,
    mesh: Mesh,
    params: MCMCParams,
    block: int,
    n_nodes: int,
):
    """Shard-resident tail-cutting epilogue (one budgeted segment).

    Same rank-space independent-set greedy as models/mcmc._tailcut
    (intended semantics of coloringMCMC_utils.cu:73-101), but each shard
    works only on its OWNED ELL rows: per round one local neighbor gather,
    a local first-fit, then two tiled all_gathers (movable flags, new
    colors).  Replaces the round-1 escape hatch that rebuilt a flat
    single-device ELL on the host — at 1M-node scale that rectangle is
    exactly what sharding exists to avoid (VERDICT r1)."""
    n_pad, d_pad = neighbors.shape
    ms = mesh.shape["shards"]
    n_loc = n_pad // ms
    n_colors = params.n_colors

    blk = block if n_loc % block == 0 else 128

    def body_fn(neigh_loc, cols_r, key, rounds0, budget):
        shard_id = jax.lax.axis_index("shards")
        offset = shard_id.astype(jnp.int32) * jnp.int32(n_loc)
        self_gids = offset + jnp.arange(n_loc, dtype=jnp.int32)
        real_loc = self_gids < jnp.int32(n_nodes)
        full_real = jnp.arange(n_pad, dtype=jnp.int32) < jnp.int32(n_nodes)

        def first_free(nc_r):
            def block_fn(xs):
                (nc_blk,) = xs
                occ = occupancy_matrix(nc_blk, n_colors)
                found = jnp.any(~occ, axis=1)
                k = jnp.argmax(~occ, axis=1).astype(jnp.int32)
                return jnp.where(found, k, -1)

            xs = (nc_r.reshape(n_loc // blk, blk, d_pad),)
            return jax.lax.map(block_fn, xs).reshape(n_loc)

        max_rounds = jnp.int32(n_nodes + 1000)
        limit = jnp.minimum(rounds0 + budget, max_rounds)

        def body(carry):
            cols_r_full, conf, rounds, _ = carry
            cols_ext = jnp.concatenate(
                [cols_r_full, jnp.full((1,), -1, jnp.int32)]
            )
            nc_r = jnp.take(cols_ext, neigh_loc, axis=0)
            own = jnp.take(
                cols_r_full, jnp.clip(self_gids, 0, n_pad - 1)
            )
            same = nc_r == own[:, None]
            conf = (
                jax.lax.psum(
                    jnp.sum(
                        same & (neigh_loc > self_gids[:, None]),
                        dtype=jnp.int32,
                    ),
                    "shards",
                )
            )
            flags = jnp.any(same, axis=1) & real_loc
            cand_r = first_free(nc_r)
            movable = flags & (cand_r >= 0)
            movable_full = jax.lax.all_gather(
                movable, "shards", axis=0, tiled=True
            )
            movable_ext = jnp.concatenate(
                [movable_full, jnp.zeros((1,), jnp.bool_)]
            )
            lower_movable = jnp.any(
                jnp.take(movable_ext, neigh_loc, axis=0)
                & (neigh_loc < self_gids[:, None]),
                axis=1,
            )
            active = movable & ~lower_movable
            any_active = (
                jax.lax.psum(
                    jnp.sum(active.astype(jnp.int32)), "shards"
                )
                > 0
            )
            stalled = (conf > 0) & ~any_active
            rnd = jax.random.randint(
                jax.random.fold_in(
                    jax.random.fold_in(key, rounds), shard_id
                ),
                (n_loc,),
                0,
                n_colors,
                dtype=jnp.int32,
            )
            new_loc = jnp.where(
                active, cand_r, jnp.where(stalled & flags, rnd, own)
            )
            new_full = jax.lax.all_gather(
                new_loc, "shards", axis=0, tiled=True
            )
            return new_full, conf, rounds + 1, conf == 0

        def cond(carry):
            _, conf, rounds, done = carry
            return (~done) & (rounds < limit)

        cols_r_out, conf, rounds, done = jax.lax.while_loop(
            cond,
            body,
            (cols_r, jnp.int32(2**30), rounds0, jnp.bool_(False)),
        )
        # re-derive done (the carry flag is False when the segment entered
        # with rounds0 == limit)
        done = done | (conf == 0)
        return cols_r_out, conf, rounds, done

    mapped = jax.shard_map(
        body_fn,
        mesh=mesh,
        in_specs=(P("shards", None), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return mapped(neighbors, cols_r, key, rounds0, budget)


def _sharded_tailcut_rank(colors_full, n_colors: int, n_nodes: int):
    """Rank-space relabel by ascending class size (replicated — identical
    on every shard/process; the reference's orderedIndex sort,
    coloringMCMC_main.cu:275-279).  Returns (cols_r, ordered)."""
    n_pad = colors_full.shape[0]
    full_real = jnp.arange(n_pad, dtype=jnp.int32) < jnp.int32(n_nodes)
    hist = (
        jnp.zeros((n_colors,), jnp.int32)
        .at[jnp.where(full_real, colors_full, n_colors)]
        .add(1, mode="drop")
    )
    ordered = jnp.argsort(hist).astype(jnp.int32)
    rank = jnp.zeros((n_colors,), jnp.int32).at[ordered].set(
        jnp.arange(n_colors, dtype=jnp.int32)
    )
    rank_ext = jnp.concatenate(
        [rank, jnp.full((1,), n_colors, jnp.int32)]
    )
    cols_r = jnp.take(
        rank_ext, jnp.clip(colors_full, 0, n_colors), axis=0
    )
    return jnp.where(full_real, cols_r, jnp.int32(n_colors)), ordered


def _sharded_tailcut_unrank(cols_r, ordered, n_colors: int, n_nodes: int):
    n_pad = cols_r.shape[0]
    full_real = jnp.arange(n_pad, dtype=jnp.int32) < jnp.int32(n_nodes)
    ordered_ext = jnp.concatenate(
        [ordered, jnp.full((1,), n_colors, jnp.int32)]
    )
    colors_out = jnp.take(
        ordered_ext, jnp.clip(cols_r, 0, n_colors), axis=0
    )
    return jnp.where(full_real, colors_out, jnp.int32(n_colors))
