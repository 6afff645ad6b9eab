"""Checks that only the GPU can make: the compiled packed-NC contraction
on the card.  They skip elsewhere; run them on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_colorer_tpu.ops.dense_adj import neighbor_color_counts
from mcmc_colorer_tpu.ops.hashgen import er_packed_on_device

pytestmark = pytest.mark.gpu


def _packed_case(n=20_000, p=0.02, n_colors=500):
    n_pad = (n + 2047) // 2048 * 2048
    adj = er_packed_on_device(n, p, 3, n_pad)
    colors = jax.random.randint(
        jax.random.key(0), (n_pad,), 0, n_colors, dtype=jnp.int32
    )
    return adj, colors, jnp.arange(n_pad) < n, n_colors


def test_packed_nc_exact_on_gpu(gpu):
    """Packed NC on the card equals a per-row host count exactly."""
    adj, colors, mask, n_colors = _packed_case()
    nc = np.asarray(neighbor_color_counts(adj, colors, n_colors, mask))
    bits = np.unpackbits(
        np.asarray(adj[:64]).view(np.uint8), bitorder="little"
    ).reshape(64, -1, 128, 32)
    # packed_bit_coords: window w, word t, bit b -> column w*4096+b*128+t
    cols = bits.transpose(0, 1, 3, 2).reshape(64, -1)[:, : colors.shape[0]]
    c = np.where(np.asarray(mask), np.asarray(colors), -1)
    for i in range(64):
        want = np.bincount(c[cols[i] == 1], minlength=nc.shape[1])
        np.testing.assert_array_equal(nc[i], want[: nc.shape[1]])


def test_packed_nc_contraction_route_on_gpu(gpu):
    """The optimized HLO hands the int8 contraction to a gemm (cuBLAS or
    a Triton gemm fusion), not a generic loop."""
    from test_chip_smoke import load_root_module

    gemm_route = load_root_module("chip_smoke").gemm_route

    adj, colors, mask, n_colors = _packed_case()
    hlo = (
        jax.jit(lambda a, c: neighbor_color_counts(a, c, n_colors, mask))
        .lower(adj, colors)
        .compile()
        .as_text()
    )
    route, _fused = gemm_route(hlo)
    assert route in ("cublas", "triton_gemm")
