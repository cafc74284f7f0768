"""XNOR/binary GEMM: 1-bit packed weights, int8 products, scale epilogue.

Replaces the reference's fp32 ``F.linear`` over ±1-valued fp32 tensors
(SURVEY.md §3.1 hot loop):

    x int8 (M, K) [±1]      w uint32 (K/32, N) grouped-planar 1-bit
    out = (x @ (2·w_bits − 1)) · alpha[n] (· row_scale[m])

``alpha`` is the XNOR per-out-channel scale, ``row_scale`` the XNOR input
K-map column (both optional). :func:`binary_gemm` picks one of two forms
from what it can observe:

* **decode-sized M on the GPU** (``M <= TRITON_MAX_M``): a Pallas kernel on
  the Triton route. Each program owns a ``_BN``-column strip and a range of
  1024-row K groups. Per group it loads one (32, BN) uint32 word tile once;
  bit plane i of it is a (32, BN) ±1 int8 tile that multiplies the 32
  activation columns ``x[:, g·1024 + 32i : +32]`` (int8 -> int32). The
  weights cross HBM as 1-bit planes, 8x fewer bytes than int8 codes, which
  is what a weight-bound GEMM at small M pays for.
* **otherwise, and on the CPU**: the plain form — unpack to ±1 int8 codes,
  then XLA's int8 dot with int32 accumulation.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from pytorch_quantize_impls_tpu.kernels import common
from pytorch_quantize_impls_tpu.ops import pack as packlib

# Largest M that takes the Triton kernel on the GPU. Measured on an H100 in
# the serving LM's decode step: the kernel gave +7% tokens/s at batch 1 and
# +2% at batch 8, and -23% at batch 32 (see PERF.md).
TRITON_MAX_M = 8
_BN = 32  # column strip per program (the Triton dot wants every dim >= 16)
_MIN_M = 16  # the Triton dot's M floor: x is zero-padded up to it
_GROUP_K = packlib.planar_group_k(1)  # 1024 K rows per 32-word group
_TARGET_PROGRAMS = 132  # one wave on an H100 (132 SMs)


def pack_binary_weights(w: jax.Array) -> jax.Array:
    """±1-ish fp weights (K, N) -> planar 1-bit uint32 (ceil(K/32), N).

    Uses ``sign(w) >= 0 -> 1`` (matches ``ops.safe_sign``). K is zero-padded;
    padded rows decode to -1 but multiply against zero-padded activations.
    """
    return packlib.pack_bitplanes((w >= 0).astype(jnp.int32), 1)


def binarize_to_int8(x: jax.Array) -> jax.Array:
    """fp activations -> ±1 int8 (the BNN activation binarization)."""
    return jnp.where(x >= 0, 1, -1).astype(jnp.int8)


def use_kernel(m: int) -> bool:
    """Whether :func:`binary_gemm` runs the Triton kernel for M rows."""
    return common.platform() == "gpu" and m <= TRITON_MAX_M


def _kernel(x_ref, w_ref, o_ref, *, n_groups: int):
    """One (column strip, K-split) program: int32 partial sums (Mp, BN)."""
    mp, bn = x_ref.shape[0], w_ref.shape[1]

    def group(g, acc):
        words = w_ref[pl.ds(g * packlib.GROUP_ROWS, packlib.GROUP_ROWS), :]
        for i in range(32):
            plane = ((words >> jnp.uint32(i)) & jnp.uint32(1)).astype(jnp.int32)
            plane = (2 * plane - 1).astype(jnp.int8)  # (32, BN) ±1
            xs = x_ref[:, pl.ds(g * _GROUP_K + 32 * i, 32)]  # (Mp, 32) int8
            acc += jnp.dot(xs, plane, preferred_element_type=jnp.int32)
        return acc

    o_ref[...] = jax.lax.fori_loop(
        0, n_groups, group, jnp.zeros((mp, bn), jnp.int32)
    )


def _n_splits(n_groups: int, n_strips: int) -> int:
    """K splits: the largest divisor of the group count that keeps the grid
    within about one wave, or 1 when the column strips alone fill it."""
    best = 1
    for s in range(1, n_groups + 1):
        if n_groups % s == 0 and n_strips * s <= 2 * _TARGET_PROGRAMS:
            best = s
    return best if n_strips < _TARGET_PROGRAMS else 1


def _binary_gemm_triton(x_i8, w_packed, *, interpret: bool = False):
    """Triton-route kernel: (M, K) int8 @ (K/32, N) planar -> (M, N) int32."""
    m = x_i8.shape[0]
    r, n = w_packed.shape
    kp = common.round_up(r * 32, _GROUP_K)
    mp = max(_MIN_M, common.next_pow2(m))
    np_ = common.round_up(n, _BN)
    x = common.pad_dim(common.pad_dim(x_i8, 0, mp), 1, kp)
    w = common.pad_dim(common.pad_dim(w_packed, 0, kp // 32), 1, np_)
    n_groups, n_strips = kp // _GROUP_K, np_ // _BN
    splits = _n_splits(n_groups, n_strips)
    gps = n_groups // splits
    partial = pl.pallas_call(
        functools.partial(_kernel, n_groups=gps),
        grid=(n_strips, splits),
        in_specs=[
            pl.BlockSpec((mp, gps * _GROUP_K), lambda j, s: (0, s)),
            pl.BlockSpec((gps * packlib.GROUP_ROWS, _BN), lambda j, s: (s, j)),
        ],
        out_specs=pl.BlockSpec((None, mp, _BN), lambda j, s: (s, 0, j)),
        out_shape=jax.ShapeDtypeStruct((splits, mp, np_), jnp.int32),
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="binary_decode_gemm",
    )(x, w)
    return jnp.sum(partial, axis=0)[:m, :n]


def _binary_gemm_plain(x_i8, w_packed):
    w = decode_binary_weights(w_packed)
    x = common.pad_dim(x_i8, 1, w.shape[0])
    return jax.lax.dot_general(
        x, w, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def binary_gemm(
    x_i8: jax.Array,
    w_packed: jax.Array,
    alpha: Optional[jax.Array] = None,
    row_scale: Optional[jax.Array] = None,
    *,
    out_dtype=jnp.float32,
):
    """(M,K) int8 ±1 @ planar-1-bit (K/32,N) -> (M,N) out_dtype.

    ``alpha``: (N,) per-out-channel scale; ``row_scale``: (M,) per-row scale.
    K as seen by ``x_i8`` may be un-padded; it is zero-padded here to the
    packed K.
    """
    m, k = x_i8.shape
    assert k <= w_packed.shape[0] * 32, (k, w_packed.shape)
    if use_kernel(m):
        acc = _binary_gemm_triton(x_i8, w_packed)
    else:
        acc = _binary_gemm_plain(x_i8, w_packed)
    return common.scale_epilogue(acc, alpha, row_scale, out_dtype)


@jax.jit
def decode_binary_weights(w_packed: jax.Array) -> jax.Array:
    """Planar 1-bit (K/32, N) -> ±1 int8 (K, N): the one-time decode pass
    (XLA fuses the shift and mask into one elementwise kernel)."""
    r = w_packed.shape[0]
    return (2 * packlib.unpack_bitplanes(w_packed, 1, r * 32) - 1).astype(jnp.int8)


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def binary_gemm_decoded(
    x_i8: jax.Array,
    w_i8: jax.Array,
    alpha: Optional[jax.Array] = None,
    row_scale: Optional[jax.Array] = None,
    *,
    out_dtype=jnp.bfloat16,
):
    """Pre-decoded ±1 int8 weights through the int8 GEMM (weights stay 4x
    smaller than f32; the serving mode ``infer.prepare`` selects)."""
    from pytorch_quantize_impls_tpu.kernels import int8_matmul

    k = w_i8.shape[0]
    x_i8 = common.pad_dim(x_i8, 1, k)
    return int8_matmul.int8_gemm(
        x_i8, w_i8, alpha, row_scale, out_dtype=out_dtype
    )


def binary_gemm_reference(x_i8, w_packed, alpha=None, row_scale=None):
    """Independent f32 twin of :func:`binary_gemm` (parity checks). Exact:
    ±1 times int8 sums stay integers below 2^24 at every supported K."""
    r, n = w_packed.shape
    w = packlib.unpack_bitplanes(w_packed, 1, r * 32)
    w = (2 * w - 1).astype(jnp.float32)
    x = common.pad_dim(x_i8, 1, r * 32).astype(jnp.float32)
    out = jnp.dot(x, w, precision=jax.lax.Precision.HIGHEST)
    if alpha is not None:
        out = out * alpha.reshape(1, n)
    if row_scale is not None:
        out = out * row_scale.reshape(-1, 1)
    return out
