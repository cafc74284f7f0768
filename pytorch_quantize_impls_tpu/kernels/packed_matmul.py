"""DoReFa k-bit packed GEMM (INT2/INT4 weights) as an integer-code GEMM.

Math: DoReFa fake-quant weights lie on the grid ``w_q = (2 c_w - n_w)/n_w``
(codes ``c_w`` in [0, n_w], ``n_w = 2^b - 1``) and activations on
``a_q = c_a/n_a``. Decoding weights to *centered* integer codes
``d = 2 c_w - n_w`` (odd values in [-n_w, n_w] — int8-exact for b <= 4)
makes the product a single integer GEMM with a scalar epilogue:

    y = a_q · w_q = (c_a · d) / (n_a * n_w)

— exact, no dequant multiply inside the loop and no activation row-sum
correction pass. Codes are stored planar-packed (2/4-bit in uint32 words,
``ops.pack.pack_bitplanes``); :func:`dorefa_gemm` unpacks them to centered
int8 codes and runs XLA's int8 dot. (A fused-unpack kernel for this format
is worth writing again for weight-only int4 serving; see ROADMAP.)

``w_bits >= 8`` is rejected: centered 8-bit codes (±255) overflow int8 —
use the bf16 fake-quant path for 8-bit weights.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu.kernels import common
from pytorch_quantize_impls_tpu.kernels.int8_matmul import int8_gemm
from pytorch_quantize_impls_tpu.ops import pack as packlib


def _check_w_bits(bits: int) -> None:
    if bits >= 8:
        raise ValueError(
            f"w_bits={bits}: centered codes 2c-n_w span ±{2**bits - 1}, "
            "which overflows an int8 operand; use the bf16 fake-quant "
            "path for >=8-bit weights"
        )


def pack_dorefa_weights(wq: jax.Array, bits: int) -> jax.Array:
    """DoReFa fake-quant weights (K, N) -> planar packed codes.

    ``wq`` must already be on the DoReFa grid (output of
    ``ops.dorefa_weight`` with the same ``bits``).
    """
    _check_w_bits(bits)
    codes = packlib.dorefa_weight_to_codes(wq, bits)
    return packlib.pack_bitplanes(codes, bits)


def dorefa_act_to_int8(aq: jax.Array, bits: int) -> jax.Array:
    """DoReFa fake-quant activations ([0,1] grid) -> int8 codes.

    ``bits <= 7``: codes must fit signed int8 (2^8-1 = 255 overflows).
    8-bit activations should use the bf16 path instead.
    """
    if bits > 7:
        raise ValueError(
            f"a_bits={bits} overflows int8 activation codes (max 7); "
            "use bf16 fake-quant for 8-bit activations"
        )
    return packlib.dorefa_act_to_codes(aq, bits).astype(jnp.int8)


@functools.partial(jax.jit, static_argnames=("w_bits",))
def decode_dorefa_weights(w_packed: jax.Array, *, w_bits: int) -> jax.Array:
    """Planar packed codes -> centered int8 codes 2c - n_w, shape (K, N).

    The one-time decode pass for serving: hot weights stay int8 (4x smaller
    than f32; the packed form is 8x-16x smaller still for cold storage).
    """
    _check_w_bits(w_bits)
    k = w_packed.shape[0] * (32 // w_bits)
    c = packlib.unpack_bitplanes(w_packed, w_bits, k)
    return (2 * c - (2**w_bits - 1)).astype(jnp.int8)


@functools.partial(
    jax.jit, static_argnames=("w_bits", "a_bits", "out_dtype")
)
def dorefa_gemm_decoded(
    a_codes: jax.Array,
    w_i8: jax.Array,
    *,
    w_bits: int,
    a_bits: int,
    out_dtype=jnp.float32,
):
    """Pre-decoded centered int8 weight codes through the int8 GEMM; the
    1/(n_a*n_w) dequant rides the alpha epilogue."""
    n_w = 2**w_bits - 1
    n_a = 2**a_bits - 1
    k, n = w_i8.shape
    a_codes = common.pad_dim(a_codes, 1, k)
    alpha = jnp.full((n,), 1.0 / (n_w * n_a), jnp.float32)
    return int8_gemm(a_codes, w_i8, alpha, out_dtype=out_dtype)


@functools.partial(
    jax.jit, static_argnames=("w_bits", "a_bits", "out_dtype")
)
def dorefa_gemm(
    a_codes: jax.Array,
    w_packed: jax.Array,
    *,
    w_bits: int,
    a_bits: int,
    out_dtype=jnp.float32,
):
    """(M,K) int8 activation codes @ planar w codes -> (M,N) fake-quant-exact.

    Output equals ``dorefa_activation(x, a_bits) @ dorefa_weight(w, w_bits)``
    up to f32 rounding.
    """
    d = decode_dorefa_weights(w_packed, w_bits=w_bits)
    return dorefa_gemm_decoded(
        a_codes, d, w_bits=w_bits, a_bits=a_bits, out_dtype=out_dtype
    )


def dorefa_gemm_reference(a_codes, w_packed, *, w_bits: int, a_bits: int):
    """Independent int32 twin using the same integer formulation (bit-exact:
    centered integer code GEMM + identical f32 scale epilogue)."""
    f = 32 // w_bits
    r, n = w_packed.shape
    c_w = packlib.unpack_bitplanes(w_packed, w_bits, r * f)
    n_w = 2**w_bits - 1
    n_a = 2**a_bits - 1
    d = (2 * c_w.astype(jnp.int32) - n_w)
    a = common.pad_dim(a_codes, 1, r * f).astype(jnp.int32)
    acc = (a @ d).astype(jnp.float32)
    return acc * (1.0 / (n_w * n_a))
