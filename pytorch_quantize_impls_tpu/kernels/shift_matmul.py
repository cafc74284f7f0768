"""Log-quant matmul: power-of-2 weights assembled as exact bf16 patterns.

Log-quantized weights are ``±2^e`` (``ops.log_quant``). Rather than turning
multiplies into integer shifts, the decode assembles the bf16 *bit pattern*
directly —

    bf16(±2^e) = sign << 15 | (e + 127) << 7      (mantissa = 0, exact)

— a few integer ops per weight that XLA fuses into one elementwise pass,
then a bf16 dot with f32 accumulation. Weight storage is the packed
(sign, exponent-index) code from ``ops.pack.log_to_codes`` (8-bit planar
fields, 4 codes per uint32 word -> 4x HBM saving vs f32). (A fused-decode
shift GEMM is worth writing again; see ROADMAP.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu.kernels import common
from pytorch_quantize_impls_tpu.ops import pack as packlib
from pytorch_quantize_impls_tpu.ops import log_lin

CODE_BITS = 8  # sign + (bits+1)-bit exponent index; bits <= 6


def pack_log_weights(w: jax.Array, fsr: float, bits: int) -> jax.Array:
    """fp weights (K, N) -> planar 8-bit (sign, exp-idx) codes.

    Note: code 0 decodes to -2^lo (the log grid has no zero); K-padding
    rows decode to that tiny level and are cancelled by zero-padded
    activations.
    """
    sign, idx = log_lin.log_quant_exponent(w, fsr, bits)
    codes = packlib.log_to_codes(sign.astype(jnp.int32), idx, bits)
    return packlib.pack_bitplanes(codes, CODE_BITS)


@functools.partial(jax.jit, static_argnames=("fsr", "bits"))
def decode_log_weights(w_packed: jax.Array, *, fsr: float, bits: int) -> jax.Array:
    """Packed log codes -> bf16 ±2^e weights (K, N): one-time decode pass.

    Serving keeps hot log-quant weights decoded (bf16 is exact for powers
    of two, 2x smaller than f32); cold/TP-resident weights stay packed
    (4x smaller)."""
    lo = int(fsr) - 2**bits
    c = packlib.unpack_bitplanes(w_packed, CODE_BITS, w_packed.shape[0] * 4)
    # code sign bit: 1 = positive; IEEE sign bit: 1 = NEGATIVE
    neg = 1 - ((c >> (bits + 1)) & 1)
    exp = (c & (2 ** (bits + 1) - 1)) + (lo + 127)  # bf16 biased exponent
    u16 = ((neg << 15) | (exp << 7)).astype(jnp.uint16)
    return jax.lax.bitcast_convert_type(u16, jnp.bfloat16)


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def shift_gemm_decoded(
    x: jax.Array, w_bf16: jax.Array, *, out_dtype=jnp.float32
):
    """Pre-decoded bf16 power-of-2 weights through the plain bf16 dot (the
    shift semantics are already burnt into the exact bf16 bit patterns)."""
    k = w_bf16.shape[0]
    xb = common.pad_dim(x.astype(jnp.bfloat16), 1, k)
    return jnp.dot(xb, w_bf16, preferred_element_type=jnp.float32).astype(
        out_dtype
    )


@functools.partial(jax.jit, static_argnames=("fsr", "bits", "out_dtype"))
def shift_gemm(
    x: jax.Array,
    w_packed: jax.Array,
    *,
    fsr: float,
    bits: int,
    out_dtype=jnp.float32,
):
    """(M,K) bf16/f32 @ packed log weights -> (M,N).

    Exact vs ``x @ log_quant(w, fsr, bits)`` in bf16 arithmetic.
    """
    w = decode_log_weights(w_packed, fsr=fsr, bits=bits)
    return shift_gemm_decoded(x, w, out_dtype=out_dtype)


def shift_gemm_reference(x, w_packed, *, fsr: float, bits: int):
    """Independent twin in the same bf16 arithmetic (weights rebuilt through
    ``ops.log_lin`` rather than bit assembly)."""
    r, n = w_packed.shape
    codes = packlib.unpack_bitplanes(w_packed, CODE_BITS, r * 4)
    sign, idx = packlib.codes_to_log(codes, bits)
    w = log_lin.log_quant_from_exponent(
        sign.astype(jnp.float32), idx, fsr, bits
    ).astype(jnp.bfloat16)
    xb = common.pad_dim(x.astype(jnp.bfloat16), 1, r * 4)
    return jnp.dot(xb, w, preferred_element_type=jnp.float32)
