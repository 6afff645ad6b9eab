"""Graph containers: host CSR + device ELL layout.

The reference stores graphs as CSR ``cumulDegs``/``neighs`` arrays walked
per-thread (reference src/graph/graph.h:37-79).  Per-vertex pointer
walks don't vectorize, so the device layout is a padded ELL matrix
``neighbors[n_pad, deg_pad]`` (int32, sentinel-padded): every per-vertex
neighbor scan becomes one vectorized gather, every occupancy test a
compare/segment-reduce over a rectangular array — the shapes XLA tiles well.

Undirected edges are stored in both directions (as the reference importer
does, graphCPU.cpp:122-134); self-loops are dropped at construction.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property

import numpy as np

try:  # jax is required for the device layout but not for host-only use
    import jax
    import jax.numpy as jnp
except ImportError:  # pragma: no cover
    jax = None
    jnp = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Graph:
    """Host-side graph: CSR over dense int node ids.

    ``row_ptr``/``cols`` mirror the reference's ``cumulDegs``/``neighs``
    (graph.h:37-79) with both directions of every undirected edge present.
    ``node_names`` preserves the importer's string-id mapping
    (fileImporter.cpp:20-62) when the graph came from a file.
    """

    n: int
    row_ptr: np.ndarray          # (n+1,) int64
    cols: np.ndarray             # (2m,) int32
    node_names: list[str] | None = None
    name: str = "graph"

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_edges(
        n: int,
        src: np.ndarray,
        dst: np.ndarray,
        *,
        both_directions_present: bool = False,
        node_names: list[str] | None = None,
        name: str = "graph",
    ) -> "Graph":
        """Build from an edge list.  Unless ``both_directions_present``,
        each undirected edge appears once in (src, dst) and the reverse is
        added here (reference graphCPU.cpp:122-134).  Self-loops dropped.
        Duplicate edges are NOT deduplicated, matching the reference
        (README.md:143 warns about them); use ``dedup_edges`` first if
        needed."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if not both_directions_present:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst[order]
        counts = np.bincount(src_s, minlength=n)
        row_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return Graph(
            n=n,
            row_ptr=row_ptr,
            cols=dst_s.astype(np.int32),
            node_names=node_names,
            name=name,
        )

    # -- properties --------------------------------------------------------

    @cached_property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int32)

    @property
    def n_edges(self) -> int:
        """Number of undirected edges (each stored twice in `cols`)."""
        return int(self.cols.shape[0]) // 2

    @cached_property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n else 0

    @cached_property
    def mean_degree(self) -> float:
        return float(self.degrees.mean()) if self.n else 0.0

    @property
    def density(self) -> float:
        if self.n < 2:
            return 0.0
        return 2.0 * self.n_edges / (self.n * (self.n - 1))

    def neighbors_of(self, i: int) -> np.ndarray:
        return self.cols[self.row_ptr[i] : self.row_ptr[i + 1]]

    # -- validation (reference GraphStruct::is_valid, graph.h:56-63,
    #    and CHECKRANDGRAPH duplicate/mirror checks, graphCPU.cpp:453-504) --

    def validate(self) -> None:
        assert self.row_ptr.shape == (self.n + 1,)
        assert self.row_ptr[0] == 0 and self.row_ptr[-1] == self.cols.shape[0]
        assert np.all(np.diff(self.row_ptr) >= 0)
        if self.cols.size:
            assert self.cols.min() >= 0 and self.cols.max() < self.n
        # mirrored-edge check: the multiset of (u,v) equals that of (v,u)
        u = np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)
        fwd = u * self.n + self.cols
        rev = self.cols.astype(np.int64) * self.n + u
        assert np.array_equal(np.sort(fwd), np.sort(rev)), "edges not mirrored"
        # no self-loops
        assert not np.any(u == self.cols), "self-loop present"

    def dedup_edges(self) -> "Graph":
        """Return a copy with duplicate parallel edges removed."""
        u = np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)
        keys = np.unique(u * self.n + self.cols)
        src = (keys // self.n).astype(np.int64)
        dst = (keys % self.n).astype(np.int64)
        return Graph.from_edges(
            self.n, src, dst, both_directions_present=True,
            node_names=self.node_names, name=self.name,
        )

    def degree_relabel(
        self, descending: bool = False
    ) -> tuple["Graph", np.ndarray]:
        """Relabel vertices by degree (stable).

        Returns (relabeled graph, perm) with ``perm[new_id] = old_id``.
        Foundation of the degree-bucketed ELL layout: contiguous id ranges
        then share a degree class, so per-bucket neighbor rectangles can be
        padded to their own class width instead of the global max degree
        (PERF.md roadmap item 5).

        ``descending=True`` puts hubs at LOW ids — for colorers whose
        tie-breaks favor lower ids (GreedyFF's conflict rule) this is the
        Welsh-Powell order and markedly reduces the used-color count."""
        key = -self.degrees if descending else self.degrees
        perm = np.argsort(key, kind="stable").astype(np.int64)
        inv = np.empty(self.n, np.int64)
        inv[perm] = np.arange(self.n, dtype=np.int64)
        degs = self.degrees[perm].astype(np.int64)
        row_ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(degs, out=row_ptr[1:])
        old_starts = self.row_ptr[perm]
        total = int(row_ptr[-1])
        idx = (
            np.repeat(old_starts, degs)
            + np.arange(total, dtype=np.int64)
            - np.repeat(row_ptr[:-1], degs)
        )
        cols = inv[self.cols[idx]].astype(np.int32)
        g = Graph(
            n=self.n,
            row_ptr=row_ptr,
            cols=cols,
            node_names=None,
            name=self.name + "_degsorted",
        )
        return g, perm

    # -- device layout -----------------------------------------------------

    def to_ell(
        self,
        *,
        pad_nodes_to: int = 8,
        pad_degree_to: int = 8,
        min_degree_pad: int = 1,
        device_build: bool | None = None,
        build_stats: dict | None = None,
    ) -> "EllGraph":
        """Pack the CSR into the padded ELL device layout.

        Padding slots (both phantom vertices and short rows) hold the
        sentinel ``n_pad`` so that gathers through an extended color array
        land on an always-invalid color; phantom vertices have degree 0 and
        are excluded from histograms via ``EllGraph.node_mask``.

        ``device_build`` selects where the rectangle is materialised:
        True ships only the O(2m+n) CSR (the reference's own H2D
        boundary, graphGPU.cu:211-226) and scatters the rectangle on the
        device (``ops/ell_build.py``); False builds it host-side and
        uploads [n_pad, d_pad] whole; None (default) picks the device
        build when the rectangle is big enough that the saved transfer
        clearly pays for the scatter.

        Cached per (n_pad, d_pad): repeated colorers on one graph —
        ratio sweeps, CLI repetitions, ensembles — reuse the rectangle
        (its host build + device transfer is minutes at the 1M scale)
        instead of paying it per construction.  The cache dies with the
        Graph, like the round-3 adjacency cache.
        """
        n_pad = _round_up(max(self.n, 1), pad_nodes_to)
        d_pad = _round_up(max(self.max_degree, min_degree_pad), pad_degree_to)
        cache = self.__dict__.setdefault("_ell_cache", {})
        hit = cache.get((n_pad, d_pad))
        if hit is not None:
            return hit
        degs = self.degrees
        rect_bytes = n_pad * d_pad * 4
        csr_bytes = (self.cols.shape[0] + self.n + 1) * 4
        # evict a smaller-or-equal cached rectangle BEFORE building the
        # new one (the "largest wins" rule used to run after): at
        # ER(1M) the old 4.7 GB rectangle + the 4 GB CSR upload + the
        # new 4.7 GB rectangle must not be resident at once
        cache_max = max((a * b for a, b in cache), default=0)
        if cache and n_pad * d_pad >= cache_max:
            cache.clear()
        if device_build is None:
            # auto: rectangle large enough that transfer dominates the
            # remote band compile (~1-2 s), and either meaningfully
            # larger than the CSR (skewed degrees) or so large that the
            # HOST-side rectangle materialisation + full-rectangle
            # upload dominates regardless (the ER(1M) config paid
            # ~735 s of setup through the host path, round 4 report —
            # the device build ships 2m+n words and scatters on chip)
            device_build = (
                rect_bytes > 32 * 1024 * 1024
                and (
                    rect_bytes > 1.3 * csr_bytes
                    or rect_bytes > 512 * 1024 * 1024
                )
                # int32 CSR index space (beyond it, the host path still
                # works; explicit device_build=True raises instead)
                and self.cols.shape[0] + 1 < 2**31
            )
        if device_build:
            from mcmc_colorer_tpu.ops.ell_build import (
                ell_neighbors_from_csr_device,
            )

            neigh_dev = ell_neighbors_from_csr_device(
                self.row_ptr, self.cols, n_pad, d_pad, stats=build_stats
            )
        else:
            neigh = np.full((n_pad, d_pad), n_pad, dtype=np.int32)
            # scatter CSR rows into the rectangle
            row = np.repeat(np.arange(self.n, dtype=np.int64), degs)
            col = (
                np.arange(self.cols.shape[0], dtype=np.int64)
                - np.repeat(self.row_ptr[:-1], degs)
            )
            neigh[row, col] = self.cols
            neigh_dev = jnp.asarray(neigh)
        degrees = np.zeros(n_pad, dtype=np.int32)
        degrees[: self.n] = degs
        ell = EllGraph(
            neighbors=neigh_dev,
            degrees=jnp.asarray(degrees),
            n_nodes=self.n,
            n_edges=self.n_edges,
            max_degree=self.max_degree,
        )
        # keep only the largest rectangle per graph: n_pad varies by
        # block size, and holding more than one n·d_pad device array per
        # graph risks doubling device memory at the scales where the
        # cache matters most.  "Largest" by element count (review r4)
        if not cache or n_pad * d_pad >= max(a * b for a, b in cache):
            cache.clear()
            cache[(n_pad, d_pad)] = ell
        return ell

    def to_ell_bucketed(
        self,
        *,
        block: int = 128,
        min_lane: int = 8,
        lane_factor: int = 4,
    ) -> "BucketedEll":
        """Pack the CSR into degree-bucketed ELL rectangles.

        The graph MUST be degree-ascending (use ``degree_relabel`` first).
        Vertices are grouped into contiguous degree classes of widths
        ``min_lane · lane_factor^k``; each class becomes one rectangle
        padded to its own width and to a ``block``-multiple height.
        Classes with fewer than ``block`` vertices are folded into the
        next wider class (bounds the rectangle count, hence per-shape
        kernel compiles).  See `BucketedEll` for why."""
        degs = self.degrees.astype(np.int64)
        assert self.n > 0
        asc = bool(np.all(np.diff(degs) >= 0))
        desc = bool(np.all(np.diff(degs) <= 0))
        assert asc or desc, (
            "to_ell_bucketed requires degree-monotonic ids - call "
            "degree_relabel() first"
        )
        maxd = max(int(degs.max()), 1)
        cap_w = _round_up(maxd, min_lane)
        widths = [min_lane]
        while widths[-1] < maxd:
            widths.append(min(widths[-1] * lane_factor, cap_w))
        segs: list[list[int]] = []  # [v0, v1, width]
        if asc:
            cut = np.searchsorted(degs, np.asarray(widths), side="right")
            v0 = 0
            for w, v1 in zip(widths, cut.tolist()):
                if v1 > v0:
                    segs.append([v0, v1, w])
                    v0 = v1
            # fold under-filled classes into the next wider one
            folded: list[list[int]] = []
            for seg in segs:
                if folded and folded[-1][1] - folded[-1][0] < block:
                    folded[-1][1] = seg[1]
                    folded[-1][2] = seg[2]
                else:
                    folded.append(seg)
            segs = folded
        else:
            # descending ids: widest class first.  bounds[k] = first index
            # with degree <= widths_desc[k]
            widths_d = widths[::-1]
            bounds = [
                int(np.searchsorted(-degs, -np.int64(w), side="left"))
                for w in widths_d
            ] + [self.n]
            for k, w in enumerate(widths_d):
                if bounds[k + 1] > bounds[k]:
                    segs.append([bounds[k], bounds[k + 1], w])
            # fold under-filled classes into the PREVIOUS (wider) one
            folded = []
            for seg in segs:
                if folded and (
                    seg[1] - seg[0] < block
                    or folded[-1][1] - folded[-1][0] < block
                ):
                    folded[-1][1] = seg[1]
                else:
                    folded.append(seg)
            segs = folded

        heights = [_round_up(b - a, block) for a, b, _ in segs]
        starts = np.concatenate([[0], np.cumsum(heights)])[:-1]
        n_pad = int(sum(heights))
        # padded-global position of every (relabeled) vertex id
        pos = np.empty(self.n, dtype=np.int64)
        for (a, b, _), s in zip(segs, starts.tolist()):
            pos[a:b] = s + np.arange(b - a, dtype=np.int64)

        degrees_pad = np.zeros(n_pad, dtype=np.int32)
        degrees_pad[pos] = degs.astype(np.int32)
        slices = []
        for (a, b, w), s, h_pad in zip(segs, starts.tolist(), heights):
            h = b - a
            seg_degs = degs[a:b]
            assert not len(seg_degs) or int(seg_degs.max()) <= w
            neigh = np.full((h_pad, w), n_pad, dtype=np.int32)
            total = int(seg_degs.sum())
            row = np.repeat(np.arange(h, dtype=np.int64), seg_degs)
            base = self.row_ptr[a]
            col = (
                np.arange(total, dtype=np.int64)
                - np.repeat(self.row_ptr[a:b] - base, seg_degs)
            )
            neigh[row, col] = pos[
                self.cols[base : self.row_ptr[b]]
            ].astype(np.int32)
            slices.append(
                EllSlice(
                    neighbors=jnp.asarray(neigh), start=int(s), n_real=h
                )
            )
        return BucketedEll(
            slices=tuple(slices),
            degrees=jnp.asarray(degrees_pad),
            n_nodes=self.n,
            n_edges=self.n_edges,
            max_degree=self.max_degree,
        )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class EllGraph:
    """Device-resident padded adjacency.

    ``neighbors[v, k]`` is the k-th neighbor of vertex v, or the sentinel
    ``n_pad`` (== ``neighbors.shape[0]``) in padding slots.  This replaces
    the reference's per-thread CSR walks (e.g. coloringMCMC_standard.cu
    inner loops) with rectangular gathers.
    """

    neighbors: "jnp.ndarray"     # (n_pad, d_pad) int32
    degrees: "jnp.ndarray"       # (n_pad,) int32
    n_nodes: int = dataclasses.field(metadata=dict(static=True))
    n_edges: int = dataclasses.field(metadata=dict(static=True))
    max_degree: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_pad(self) -> int:
        return self.neighbors.shape[0]

    @property
    def d_pad(self) -> int:
        return self.neighbors.shape[1]

    @property
    def node_mask(self) -> "jnp.ndarray":
        """(n_pad,) bool — True for real vertices."""
        return (
            jnp.arange(self.n_pad, dtype=jnp.int32) < jnp.int32(self.n_nodes)
        )

    @property
    def neighbor_mask(self) -> "jnp.ndarray":
        """(n_pad, d_pad) bool — True where a real neighbor is stored."""
        return self.neighbors < jnp.int32(self.n_pad)


# ---------------------------------------------------------------------------
# degree-bucketed ELL: per-degree-class neighbor rectangles
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class EllSlice:
    """One degree-class rectangle of a `BucketedEll`.

    ``neighbors[r, k]`` holds the PADDED-GLOBAL position of the k-th
    neighbor of the vertex at padded-global position ``start + r`` — or the
    sentinel (the total padded vertex count) in padding slots.  Rows past
    ``n_real`` are phantom."""

    neighbors: "jnp.ndarray"     # (h_pad, d_b) int32
    start: int = dataclasses.field(metadata=dict(static=True))
    n_real: int = dataclasses.field(metadata=dict(static=True))

    @property
    def h_pad(self) -> int:
        return self.neighbors.shape[0]

    @property
    def d_pad(self) -> int:
        return self.neighbors.shape[1]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BucketedEll:
    """Degree-bucketed device adjacency (PERF.md roadmap item 5).

    A flat ELL pads every row to the global max degree, so one sweep
    gathers n·d_max neighbor colors; on skewed-degree graphs
    (Barabási–Albert, most real-world networks) that is 10-100x more than
    the 2m real entries.  Here vertices are relabeled by ascending degree
    (`Graph.degree_relabel`) and grouped into a few contiguous degree
    classes, each packed into its own rectangle padded to the class width —
    the gather volume drops to Σ_b h_b·d_b ≈ 2m while every rectangle keeps
    the static shape XLA needs.  Node-indexed vectors (colors, taboo,
    uniforms) span the concatenation of the padded buckets."""

    slices: tuple[EllSlice, ...]
    degrees: "jnp.ndarray"  # (n_pad,) int32; 0 in phantom slots
    n_nodes: int = dataclasses.field(metadata=dict(static=True))
    n_edges: int = dataclasses.field(metadata=dict(static=True))
    max_degree: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_pad(self) -> int:
        last = self.slices[-1]
        return last.start + last.h_pad

    @property
    def node_mask(self) -> "jnp.ndarray":
        """(n_pad,) bool — True for real vertices (interleaved: each
        bucket carries its own phantom tail)."""
        return jnp.concatenate(
            [
                jnp.arange(s.h_pad, dtype=jnp.int32) < jnp.int32(s.n_real)
                for s in self.slices
            ]
        )

    @property
    def gather_elements(self) -> int:
        """Neighbor-color elements one full sweep gathers (the cost a flat
        ELL would pay is n_pad · max_degree_padded)."""
        return sum(s.h_pad * s.d_pad for s in self.slices)

    def real_positions(self) -> np.ndarray:
        """(n_nodes,) padded-global position of each (relabeled) vertex id
        — use to read per-vertex results out of padded vectors."""
        return np.concatenate(
            [s.start + np.arange(s.n_real, dtype=np.int64) for s in self.slices]
        )
