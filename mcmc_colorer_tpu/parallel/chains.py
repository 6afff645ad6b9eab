"""Independent-chain MCMC ensemble.

The reference runs repetitions sequentially on one GPU (main.cu:82 loop).
Here N chains run simultaneously: `vmap` over the whole device-resident
chain (`models.mcmc._run_chain`), sharded over the ``chains`` mesh axis so
each device advances its own chains with zero communication; finished
chains freeze in place (lax.while_loop batching).  Best-of-chains selection
picks the chain with (fewest conflicts, most balanced classes).

Lock-step pooled annealing across chains lives in
:mod:`mcmc_colorer_tpu.parallel.sharded` (it needs a shared iteration
clock); this module keeps chains fully asynchronous.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mcmc_colorer_tpu.config import MCMCParams
from mcmc_colorer_tpu.graph.container import Graph
from mcmc_colorer_tpu.models.base import Coloring
from mcmc_colorer_tpu.models.mcmc import choose_block_size
from mcmc_colorer_tpu.utils import rng as rngu


class EnsembleMCMCColorer:
    """Run ``n_chains`` independent chains, return the best coloring.

    ``mesh`` may be None (all chains on the default device) or a
    `jax.sharding.Mesh` with a ``chains`` axis; ``n_chains`` must then be a
    multiple of that axis size.
    """

    def __init__(
        self,
        graph: Graph,
        params: MCMCParams,
        n_chains: int,
        mesh: Mesh | None = None,
        block_size: int | None = None,
        backend: str = "auto",
        layout: str = "flat",
    ) -> None:
        """``layout='bucketed'``: every chain runs over degree-bucketed
        rectangles (graph/container.py:BucketedEll) — required on skewed
        graphs whose flat max-degree rectangle exceeds device memory."""
        self.graph = graph
        self.params = params
        self.n_chains = n_chains
        self.mesh = mesh
        self.block = block_size or choose_block_size(
            graph.n, params.n_colors * max(1, n_chains // 8)
        )
        if backend == "auto":
            backend = "xla"
        if backend not in ("xla", "matmul"):
            raise ValueError(f"unknown backend {backend!r}")
        self.layout = layout
        if layout == "bucketed":
            self.block = min(self.block, 2048)
            g2, perm = graph.degree_relabel()
            self._perm = perm
            self.ell = g2.to_ell_bucketed(block=128)
            self._pos = self.ell.real_positions()
        elif layout == "flat":
            self._perm = None
            self.ell = graph.to_ell(pad_nodes_to=self.block)
        else:
            raise ValueError(f"unknown layout {layout!r}")

        from mcmc_colorer_tpu.models.mcmc import (
            _chain_final_conflicts,
            _chain_init,
            _chain_segment,
            _chain_segment_matmul,
            _tailcut_finish,
            _tailcut_init,
            _tailcut_segment,
        )

        # every chain's device loop is compiled once with a traced budget
        # and host-driven in segments (utils/segmented.py); the vmapped
        # while_loops lock-step the batch exactly like the former one-shot
        self._adj = None
        if backend == "matmul":
            from mcmc_colorer_tpu.ops.dense_adj import (
                get_adjacency,
                matmul_adjacency_kind,
            )

            if layout != "flat":
                raise ValueError("backend='matmul' is flat-layout only")
            # same kind selection as MCMCColorer
            kind = matmul_adjacency_kind(self.ell.n_pad)
            # ONE A serves every chain (the per-chain sweep matmuls
            # batch over it); cached per (graph, n_pad, kind)
            self._adj = get_adjacency(graph, self.ell.n_pad, kind, self.ell)
            self._fused_carry = True
            seg = jax.vmap(
                partial(
                    _chain_segment_matmul, params=params, block=self.block
                ),
                in_axes=(None, None, 0, None),
            )
            self._jit_segment_m = jax.jit(seg)
            self._jit_segment = lambda ell, c, b: self._jit_segment_m(
                ell, self._adj, c, b
            )
        else:
            self._fused_carry = False
            seg = jax.vmap(
                partial(_chain_segment, params=params, block=self.block),
                in_axes=(None, 0, None),
            )
            self._jit_segment = jax.jit(seg)
        init = jax.vmap(
            partial(_chain_init, params=params, fused=self._fused_carry),
            in_axes=(None, 0),
        )
        self._jit_final = jax.jit(
            jax.vmap(_chain_final_conflicts, in_axes=(None, 0))
        )
        self._jit_tc_init = jax.jit(
            jax.vmap(
                partial(_tailcut_init, params=params), in_axes=(None, 0)
            )
        )
        self._jit_tc_segment = jax.jit(
            jax.vmap(
                partial(_tailcut_segment, params=params, block=self.block),
                in_axes=(None, 0, 0, None),
            )
        )
        self._jit_tc_finish = jax.jit(
            jax.vmap(
                partial(_tailcut_finish, params=params),
                in_axes=(None, 0, 0),
            )
        )
        if mesh is not None:
            if "chains" not in mesh.axis_names:
                raise ValueError("mesh must have a 'chains' axis")
            c_ax = mesh.shape["chains"]
            if n_chains % c_ax:
                raise ValueError(
                    f"n_chains={n_chains} not divisible by mesh chains={c_ax}"
                )
            key_sharding = NamedSharding(mesh, P("chains"))
            repl = NamedSharding(mesh, P())
            self._jit_init = jax.jit(
                init, in_shardings=(repl, key_sharding)
            )
        else:
            self._jit_init = jax.jit(init)

    def run(self, seed: int, repetition: int = 0):
        """Returns (best Coloring, list of per-chain summaries)."""
        from mcmc_colorer_tpu.utils.segmented import drive_segments

        root = rngu.for_repetition(rngu.root_key(seed), repetition)
        keys = jax.vmap(lambda c: rngu.for_chain(root, c))(
            jnp.arange(self.n_chains, dtype=jnp.uint32)
        )
        params = self.params
        z = params.tailcut_threshold(self.graph.n)
        t0 = time.perf_counter()
        carry = self._jit_init(self.ell, keys)

        def progress(c):
            rips_h = np.asarray(c[3])
            if self._fused_carry:
                active = ~np.asarray(c[6]) & (
                    rips_h < params.max_iterations
                )
            else:
                active = (np.asarray(c[4]) > z) & (
                    rips_h < params.max_iterations
                )
            return int(rips_h.max()), not active.any()

        carry = drive_segments(
            lambda c, b: self._jit_segment(self.ell, c, jnp.int32(b)),
            carry,
            progress,
        )
        colors, _taboo, keyv, rips, conflicts, traces, _done = carry
        if self._fused_carry:
            conflicts = self._jit_final(self.ell, carry)
        tc_rounds = np.zeros(self.n_chains, np.int32)
        if params.tailcut:
            from mcmc_colorer_tpu.models.mcmc import _tailcut_max_rounds

            k_tc = jax.vmap(lambda k: jax.random.split(k)[1])(keyv)
            colors_r, ordered = self._jit_tc_init(self.ell, colors)
            tc = (
                colors_r,
                conflicts,
                jnp.zeros((self.n_chains,), jnp.int32),
                jnp.zeros((self.n_chains,), jnp.bool_),
            )
            tc_max = _tailcut_max_rounds(self.ell)

            def tc_progress(c):
                rounds_h = np.asarray(c[2])
                done_h = np.asarray(c[3]) | (rounds_h >= tc_max)
                return int(rounds_h.max()), bool(done_h.all())

            tc = drive_segments(
                lambda c, b: self._jit_tc_segment(
                    self.ell, c, k_tc, jnp.int32(b)
                ),
                tc,
                tc_progress,
            )
            colors = self._jit_tc_finish(self.ell, tc[0], ordered)
            conflicts, tc_rounds = tc[1], np.asarray(tc[2])
        raw = np.asarray(jax.device_get(colors))
        if self._perm is not None:
            colors = np.empty((self.n_chains, self.graph.n), np.int32)
            colors[:, self._perm] = raw[:, self._pos]
        else:
            colors = raw[:, : self.graph.n]
        conflicts = np.asarray(conflicts)
        rips = np.asarray(rips)
        dur = (time.perf_counter() - t0) * 1e3

        # best-of-chains: fewest conflicts, then smallest class-size std
        stds = np.array(
            [
                np.bincount(c, minlength=self.params.n_colors).std()
                for c in colors
            ]
        )
        order = np.lexsort((stds, conflicts))
        best = int(order[0])
        z = self.params.tailcut_threshold(self.graph.n)
        summaries = [
            {
                "chain": int(i),
                "iterations": int(rips[i]),
                "conflicts": int(conflicts[i]),
                "class_std": float(stds[i]),
            }
            for i in range(self.n_chains)
        ]
        best_coloring = Coloring(
            colors=colors[best],
            n_colors=self.params.n_colors,
            iterations=int(rips[best]),
            converged=int(conflicts[best]) <= z,
            duration_ms=dur,
            conflict_trace=np.asarray(traces[best])[: int(rips[best]) + 1],
            extra={
                "final_conflicts": int(conflicts[best]),
                "max_iter_reached": bool(
                    rips[best] >= self.params.max_iterations
                ),
                "best_chain": best,
                "n_chains": self.n_chains,
            },
        )
        return best_coloring, summaries
