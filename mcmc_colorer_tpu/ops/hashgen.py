"""Hash-defined G(n,p): the graph is a FUNCTION, not an upload.

For *generated* (``--simulate``) graphs the host need not build and ship
an edge list at all (465 MB of ELL at ER(100k, 0.01)): define the edge
set by a stateless hash so both sides can materialise it independently —

    edge(i, j)  :=  mix32(seed, min(i,j), max(i,j)) < floor(p·2³²)

- the DEVICE evaluates the hash directly into the bit-packed adjacency
  (``er_packed_on_device``: [n_pad, words] uint32 in the
  ``packed_bit_coords`` order, ~10.5e9 hashes at ER(100k), zero bytes
  transferred), and
- the HOST enumerates the same pairs in threaded C++
  (``native/importer.cpp:mc_generate_er_hash``) for exact CSR /
  validation — bit-identical by construction (``tests`` cross-check).

The mix is the murmur3-style avalanche finalizer over uint32 lanes —
statistically fine for benchmark graphs (each unordered pair maps to one
well-mixed word; this is a PRNG-quality, not crypto, requirement) and
exactly reproducible in both languages with wrapping uint32 arithmetic.

The reference generates on the CPU and ships the graph to the GPU over
PCIe (datasetGenerator.cpp + graphCPU.cpp:291-404); re-deriving it on the
device moves nothing.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_colorer_tpu.ops.dense_adj import PACKED_K_CHUNK, packed_adj_words

# murmur3 fmix32 constants (public domain)
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_C3 = np.uint32(0x27D4EB2F)
_GOLD = np.uint32(0x9E3779B9)


def er_threshold(p: float) -> int:
    """uint32 acceptance threshold for Bernoulli(p)."""
    return min(0xFFFFFFFF, max(0, int(p * 4294967296.0)))


def _mix(seed, i, j):
    """Vectorized mix32(seed, i, j) on uint32 arrays (wraps mod 2^32,
    matching C++ unsigned arithmetic)."""
    h = seed ^ jnp.uint32(_GOLD)
    h = (h ^ i) * jnp.uint32(_C1)
    h = h ^ (h >> jnp.uint32(13))
    h = (h ^ j) * jnp.uint32(_C2)
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(_C3)
    h = h ^ (h >> jnp.uint32(15))
    return h


def hash_edges_reference(n: int, p: float, seed: int) -> np.ndarray:
    """Host numpy enumeration of the hash graph's (i, j) upper-triangle
    edges — the small-n oracle the device generator and the C++
    enumerator are tested against."""
    t = np.uint32(er_threshold(p))
    i, j = np.triu_indices(n, k=1)
    i32, j32 = i.astype(np.uint32), j.astype(np.uint32)
    with np.errstate(over="ignore"):
        h = np.uint32(seed) ^ _GOLD
        h = (h ^ i32) * _C1
        h ^= h >> np.uint32(13)
        h = (h ^ j32) * _C2
        h ^= h >> np.uint32(16)
        h = h * _C3
        h ^= h >> np.uint32(15)
    keep = h < t
    return np.stack([i[keep], j[keep]], axis=1)


def _gen_packed_rows(r0, n, t, seed32, row_chunk: int, words: int):
    """[row_chunk, words] packed adjacency rows [r0, r0+row_chunk) of the
    hash graph (traceable; ``r0`` may be a traced int32).  Bit order is
    ``packed_bit_coords``: word w (window w//128, lane w%128) bit b holds
    column ``(w//128)*PACKED_K_CHUNK + b*128 + w%128``."""
    rows = (
        r0 + jax.lax.broadcasted_iota(jnp.int32, (row_chunk, words), 0)
    ).astype(jnp.uint32)
    w = jax.lax.broadcasted_iota(jnp.int32, (row_chunk, words), 1)
    j_base = ((w // 128) * PACKED_K_CHUNK + w % 128).astype(jnp.uint32)

    def bit(b, acc):
        j = j_base + jnp.uint32(128) * b.astype(jnp.uint32)
        lo = jnp.minimum(rows, j)
        hi = jnp.maximum(rows, j)
        edge = (
            (_mix(seed32, lo, hi) < t)
            & (rows != j)
            & (j < jnp.uint32(n))
            & (rows < jnp.uint32(n))
        )
        return acc | (edge.astype(jnp.uint32) << b.astype(jnp.uint32))

    return jax.lax.fori_loop(
        0, 32, bit, jnp.zeros((row_chunk, words), jnp.uint32)
    )


def er_packed_on_device(
    n: int, p: float, seed: int, n_pad: int, row_chunk: int = 2048,
    stats: dict | None = None,
):
    """[n_pad, words] uint32 bit-packed adjacency of the hash graph,
    computed entirely on the default device (nothing transferred), in
    row bands.

    ``stats`` (optional dict) receives the one-time cost split into the
    AOT compile of the band program (``compile_s``), the band executions
    (``execute_s``) and the band count (``bands``)."""
    if n_pad % row_chunk:
        raise ValueError(f"row_chunk must divide n_pad ({n_pad})")
    words = packed_adj_words(n_pad)
    row_chunk = _bounded_band(row_chunk, words)
    # group bands into the largest row count that still divides n_pad
    # and stays within the hash budget: fewer, larger programs
    cap_rows = max(
        row_chunk, 2_500_000_000 // max(words * 32, 1)
    )
    best_g = 1
    for g in range(2, n_pad // row_chunk + 1):
        if n_pad % (row_chunk * g) == 0 and row_chunk * g <= cap_rows:
            best_g = g
    row_chunk *= best_g
    t = jnp.uint32(er_threshold(p))
    seed32 = jnp.uint32(seed & 0xFFFFFFFF)

    gen_rows = jax.jit(
        partial(
            _gen_packed_rows, n=n, row_chunk=row_chunk, words=words
        ),
        static_argnames=(),
    )
    band_starts = list(range(0, n_pad, row_chunk))

    if stats is None:
        chunks = [
            gen_rows(jnp.int32(r0), t=t, seed32=seed32)
            for r0 in band_starts
        ]
        return jnp.concatenate(chunks, axis=0)

    import time

    t0 = time.perf_counter()
    gen_c = gen_rows.lower(jnp.int32(0), t=t, seed32=seed32).compile()
    stats["compile_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    chunks = [gen_c(jnp.int32(r0), t=t, seed32=seed32) for r0 in band_starts]
    jax.block_until_ready(chunks)
    stats["execute_s"] = round(time.perf_counter() - t0, 3)
    stats["bands"] = len(band_starts)
    return jnp.concatenate(chunks, axis=0)


_PACKED_CACHE: dict = {}


def er_packed_on_device_cached(
    n: int, p: float, seed: int, n_pad: int, row_chunk: int = 2048,
    stats: dict | None = None,
):
    """Single-slot cache over :func:`er_packed_on_device`: a CLI run
    that colors the same hash graph with several resident colorers
    (e.g. ``--mcmcgpu --lubygpu --resident``) shares ONE device
    adjacency instead of materialising identical HBM-sized copies
    (the packed A is ~1.3 GB at ER(100k)).
    Only the most recent graph is kept, mirroring
    ``parallel.sharded._RESIDENT_STRIP_CACHE``."""
    ck = (n, float(p), int(seed), n_pad)
    if ck in _PACKED_CACHE:
        if stats is not None:
            stats["cached"] = True
        return _PACKED_CACHE[ck]
    a = er_packed_on_device(n, p, seed, n_pad, row_chunk, stats=stats)
    _PACKED_CACHE.clear()
    _PACKED_CACHE[ck] = a
    return a


def er_packed_strips_on_device(
    n: int, p: float, seed: int, n_pad: int, mesh, row_chunk: int = 512
):
    """[n_pad, words] packed adjacency of the hash graph, rows sharded
    ``P('shards', None)`` over the mesh — every shard materialises ITS
    [n_loc, n_pad] strip locally (same layout/bit order as
    ``parallel.sharded._build_packed_strips``), so nothing ships from
    the host and nothing crosses the mesh: the zero-upload rendition of
    the adjacency-strip build for generated graphs."""
    from jax.sharding import PartitionSpec as P

    from jax.sharding import NamedSharding

    ms = mesh.shape["shards"]
    if n_pad % ms:
        raise ValueError(f"shards must divide n_pad ({n_pad})")
    n_loc = n_pad // ms
    row_chunk = min(row_chunk, n_loc)
    while n_loc % row_chunk:
        row_chunk //= 2
    words = packed_adj_words(n_pad)
    row_chunk = _bounded_band(row_chunk, words)
    # group bands like er_packed_on_device: the largest row count that
    # divides n_loc and stays within the hash budget
    cap_rows = max(row_chunk, 2_500_000_000 // max(words * 32, 1))
    best = 1
    for g in range(2, n_loc // row_chunk + 1):
        if n_loc % (row_chunk * g) == 0 and row_chunk * g <= cap_rows:
            best = g
    row_chunk *= best
    t = jnp.uint32(er_threshold(p))
    seed32 = jnp.uint32(seed & 0xFFFFFFFF)

    # HOST-DRIVEN bands, like parallel.sharded._build_packed_strips: one
    # execution per band keeps each program's size bounded at any n
    def band_body(a_loc, r0):
        shard_id = jax.lax.axis_index("shards")
        r_base = shard_id.astype(jnp.int32) * jnp.int32(n_loc)
        blk = _gen_packed_rows(
            r_base + r0, n, t, seed32, row_chunk, words
        )
        return jax.lax.dynamic_update_slice(a_loc, blk, (r0, 0))

    band = jax.jit(
        jax.shard_map(
            band_body,
            mesh=mesh,
            in_specs=(P("shards", None), P()),
            out_specs=P("shards", None),
            check_vma=False,
        ),
        donate_argnums=(0,),
    )
    a = jax.jit(
        lambda: jnp.zeros((n_pad, words), jnp.uint32),
        out_shardings=NamedSharding(mesh, P("shards", None)),
    )()
    for r0 in range(0, n_loc, row_chunk):
        a = band(a, jnp.int32(r0))
    return a


def _bounded_band(
    row_chunk: int, words: int, budget_hashes: int = 2_500_000_000
) -> int:
    """Halve ``row_chunk`` (preserving divisibility) until one band's
    hash count (rows × words × 32) stays within ``budget_hashes``."""
    cap = max(128, budget_hashes // max(words * 32, 1))
    while row_chunk > cap and row_chunk > 128:
        row_chunk //= 2
    return row_chunk


def er_degrees_on_device(
    n: int, p: float, seed: int, row_chunk: int = 2048, mesh=None
) -> jnp.ndarray:
    """[n] degrees of the hash graph, computed in [row_chunk, words]
    blocks that are popcounted and DISCARDED — never materialises the
    full adjacency, so it works at any n (used to resolve ``n_colors =
    max degree`` before a sharded strip build).  With ``mesh`` the rows
    split over the 'shards' axis, so the O(n²) hash sweep runs S-way
    parallel instead of serially on one device."""
    words = packed_adj_words(n)
    t = jnp.uint32(er_threshold(p))
    seed32 = jnp.uint32(seed & 0xFFFFFFFF)
    if mesh is None:
        row_chunk = _bounded_band(row_chunk, words)
        deg_rows = jax.jit(
            lambda r0: jnp.sum(
                jax.lax.population_count(
                    _gen_packed_rows(r0, n, t, seed32, row_chunk, words)
                ).astype(jnp.int32),
                axis=1,
            )
        )
        n_pad = (n + row_chunk - 1) // row_chunk * row_chunk
        out = jnp.concatenate(
            [deg_rows(jnp.int32(r0)) for r0 in range(0, n_pad, row_chunk)]
        )
        return out[:n]

    from jax.sharding import NamedSharding, PartitionSpec as P

    ms = mesh.shape["shards"]
    n_loc = -(-n // (ms * row_chunk)) * row_chunk  # rows per shard
    row_chunk = _bounded_band(row_chunk, words)

    # HOST-DRIVEN bands: the O(n²/S) sweep runs as bounded programs
    def band_body(deg_loc, r0):
        shard_id = jax.lax.axis_index("shards")
        r_base = shard_id.astype(jnp.int32) * jnp.int32(n_loc)
        deg = jnp.sum(
            jax.lax.population_count(
                _gen_packed_rows(
                    r_base + r0, n, t, seed32, row_chunk, words
                )
            ).astype(jnp.int32),
            axis=1,
        )
        return jax.lax.dynamic_update_slice(deg_loc, deg, (r0,))

    band = jax.jit(
        jax.shard_map(
            band_body,
            mesh=mesh,
            in_specs=(P("shards"), P()),
            out_specs=P("shards"),
            check_vma=False,
        ),
        donate_argnums=(0,),
    )
    deg = jax.jit(
        lambda: jnp.zeros((ms * n_loc,), jnp.int32),
        out_shardings=NamedSharding(mesh, P("shards")),
    )()
    for r0 in range(0, n_loc, row_chunk):
        deg = band(deg, jnp.int32(r0))
    return deg[:n]


def degrees_from_packed(adj) -> jnp.ndarray:
    """Per-row popcount of the packed adjacency (device pass)."""
    return jax.jit(
        lambda a: jnp.sum(
            jax.lax.population_count(a).astype(jnp.int32), axis=1
        )
    )(adj)


def hash_er_graph(n: int, p: float, seed: int, name: str | None = None):
    """Host CSR of the SAME hash graph via the threaded C++ enumerator
    (falls back to the numpy oracle for small n) — for validation,
    analysis, and the log contract.  O(n²) hashes host-side; intended
    for n up to a few hundred thousand."""
    from mcmc_colorer_tpu.graph import native
    from mcmc_colorer_tpu.graph.container import Graph

    nm = name or f"er_hash_{n}_{p}"
    if native.available():
        g = native.generate_er_hash(
            n, er_threshold(p), seed & 0xFFFFFFFF, name=nm
        )
    else:
        e = hash_edges_reference(n, p, seed)
        g = Graph.from_edges(n, e[:, 0], e[:, 1], name=nm)
    g.simple_certified = True
    return g
