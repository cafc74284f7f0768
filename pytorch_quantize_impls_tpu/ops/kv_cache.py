"""KV-cache quantization codecs — NEW scope (inference extension).

The reference does fake-quant training of MLP/CNNs only (SURVEY.md §2); this
framework's quantized-transformer extension also serves autoregressively,
and the KV cache is the HBM-resident state that dominates decode memory
traffic. Symmetric int8 codes with one fp32 scale per (batch, position,
head) group cut cache bytes ~4x vs fp32 (~2x vs bf16) while keeping the
group's dynamic range: attention reads dequantize on the fly in the compute
dtype (or fold the scales, kernels/decode_attention.py).

Scale granularity rationale: per-(position, head) tracks the token-to-token
magnitude drift that per-tensor scales smear, at a scale overhead of
1/(head_dim) fp32 per entry (<1% for head_dim >= 64 at int8).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


def quantize_kv(x: Array, bits: int = 8) -> Tuple[Array, Array]:
    """(..., head_dim) fp -> (codes int8, scale f32 over the last axis).

    Symmetric, no -2^(bits-1) code (NCCL/EQuARX convention, matching
    ``parallel.quantize_symmetric``); all-zero groups get scale 1 so the
    round-trip is exactly zero instead of NaN.

    Codes are ``round(x * (qmax / amax))``: a product, not ``x / scale``.
    When x and amax are integers (K/V from a binary GEMM), ``x / scale``
    often lands exactly on a half code, and whether it rounds up or down
    then depends on how the compiler evaluates the division (XLA may fold
    ``x / (amax / qmax)`` into ``x * qmax / amax`` in one program and not
    in another). A correctly rounded product of the same two operands is
    the same everywhere.
    """
    if not 2 <= bits <= 8:
        raise ValueError(f"kv bits must be in [2, 8], got {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)
    scale = jnp.where(amax > 0, amax / qmax, 1.0)
    inv = jnp.where(amax > 0, qmax / amax, 1.0)
    codes = jnp.clip(
        jnp.round(x.astype(jnp.float32) * inv[..., None]), -qmax, qmax
    ).astype(jnp.int8)
    return codes, scale.astype(jnp.float32)


def dequantize_kv(codes: Array, scale: Array, dtype=jnp.float32) -> Array:
    """Inverse of :func:`quantize_kv`: ``codes * scale`` in ``dtype``."""
    return (codes.astype(jnp.float32) * scale[..., None]).astype(dtype)
