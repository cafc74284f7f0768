"""Bit packing: 1/2/4-bit codes <-> uint32 words.

NEW scope (no reference counterpart — the reference does fake-quant only,
SURVEY.md §2 "Native-kernel components"). These are the host/XLA-side packing
utilities backing the packed GEMMs; layout rules:

* pack along the **last** dimension, ``factor = 32 // bits`` codes per
  ``uint32`` word;
* inputs are unsigned *codes* in ``[0, 2^bits)`` (signed values map through
  offset or sign encodings below);
* sizes are padded with zero-codes to a multiple of the pack factor —
  callers keep the logical size (``unpack`` takes ``size``). For TP, shard
  BEFORE packing so shard boundaries stay on unpacked-element boundaries
  (SURVEY.md §2 parallelism table).

Round-trip invariant (property-tested): ``unpack(pack(c, b), b, n) == c``.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu.ops.common import Array

SUPPORTED_BITS = (1, 2, 4, 8)


def pack_factor(bits: int) -> int:
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    return 32 // bits


def packed_size(n: int, bits: int) -> int:
    f = pack_factor(bits)
    return -(-n // f)


def pack(codes: Array, bits: int) -> Array:
    """Pack unsigned codes (last dim) into uint32 lanes, little-endian in bits.

    ``codes[..., i]`` lands in lane ``i // factor`` at bit offset
    ``bits * (i % factor)``.
    """
    f = pack_factor(bits)
    codes = jnp.asarray(codes)
    n = codes.shape[-1]
    pad = packed_size(n, bits) * f - n
    if pad:
        codes = jnp.concatenate(
            [codes, jnp.zeros(codes.shape[:-1] + (pad,), codes.dtype)], axis=-1
        )
    c = codes.astype(jnp.uint32).reshape(*codes.shape[:-1], -1, f)
    shifts = jnp.arange(f, dtype=jnp.uint32) * jnp.uint32(bits)
    return jnp.bitwise_or.reduce(c << shifts, axis=-1)


def unpack(packed: Array, bits: int, size: int) -> Array:
    """Inverse of :func:`pack`; returns int32 codes with last dim ``size``."""
    f = pack_factor(bits)
    shifts = jnp.arange(f, dtype=jnp.uint32) * jnp.uint32(bits)
    mask = jnp.uint32(2**bits - 1)
    c = (packed[..., None] >> shifts) & mask
    return c.reshape(*packed.shape[:-1], -1)[..., :size].astype(jnp.int32)


# --- signed/value encodings per scheme -------------------------------------


def binary_to_codes(w: Array) -> Array:
    """±1 values -> {0,1} codes (+1 -> 1; matches ``safe_sign``: 0 -> +1)."""
    return (w >= 0).astype(jnp.int32)


def codes_to_binary(c: Array, dtype=jnp.float32) -> Array:
    return (2 * c - 1).astype(dtype)


def int_to_codes(v: Array, bits: int) -> Array:
    """Signed ints in [-2^(b-1), 2^(b-1)-1] -> offset codes in [0, 2^b)."""
    return (v + (1 << (bits - 1))).astype(jnp.int32)


def codes_to_int(c: Array, bits: int) -> Array:
    return c.astype(jnp.int32) - (1 << (bits - 1))


def pack_binary(w: Array) -> Array:
    """Pack a ±1-valued tensor to 1-bit codes in uint32 lanes."""
    return pack(binary_to_codes(w), 1)


def unpack_binary(packed: Array, size: int, dtype=jnp.float32) -> Array:
    return codes_to_binary(unpack(packed, 1, size), dtype)


def dorefa_weight_to_codes(wq: Array, bits: int) -> Array:
    """DoReFa fake-quant weights (grid ``{2i/(2^k-1) - 1}``) -> codes i."""
    n = float(2**bits - 1)
    return jnp.round((wq + 1.0) * 0.5 * n).astype(jnp.int32)


def codes_to_dorefa_weight(c: Array, bits: int, dtype=jnp.float32) -> Array:
    n = float(2**bits - 1)
    return (2.0 * c.astype(dtype) / n - 1.0).astype(dtype)


def dorefa_act_to_codes(aq: Array, bits: int) -> Array:
    """DoReFa fake-quant activations (grid ``{i/(2^k-1)}``) -> codes i."""
    n = float(2**bits - 1)
    return jnp.round(aq * n).astype(jnp.int32)


def log_to_codes(sign: Array, exp_idx: Array, bits: int) -> Array:
    """(sign, exponent-index) from ``log_quant_exponent`` -> codes.

    The exponent grid ``clip(round(log2|x|), fsr - 2^bits, fsr)`` has
    ``2^bits + 1`` levels (index in ``[0, 2^bits]``), so the index needs
    ``bits + 1`` bits and the sign sits at bit ``bits + 1`` — total
    ``bits + 2`` bits, packed at the next supported width.
    """
    sign_bit = (sign > 0).astype(jnp.int32)
    return (sign_bit << (bits + 1)) | jnp.clip(exp_idx, 0, 2**bits)


def codes_to_log(c: Array, bits: int):
    sign = 2 * ((c >> (bits + 1)) & 1) - 1
    return sign.astype(jnp.int32), (c & (2 ** (bits + 1) - 1)).astype(jnp.int32)


# --- grouped-planar (bit-plane) packing: the packed-kernel layout ----------
#
# ``pack`` above interleaves codes *within* a lane word (little-endian along
# the last dim) — the natural Python layout. The packed GEMMs instead want
# GROUPED-PLANAR packing along the *contraction* (second-to-last) axis:
#
#   factor   f = 32 // bits          codes per uint32 word
#   group    GROUP_ROWS = 32 words   covering group_k = f * 32 k-rows
#   word[g * 32 + r, n] stores code ``codes[g * group_k + i * 32 + r, n]``
#   in bit field ``[bits*i, bits*(i+1))``.
#
# Bit field i of one 32-word group is a contiguous 32-row slab of K, so a
# kernel extracts it with one shift+mask and multiplies it against the
# matching 32 activation columns; any K range that is a multiple of
# ``group_k`` decodes without global context, so kernels may split K freely.

GROUP_ROWS = 32


def planar_group_k(bits: int) -> int:
    """K-rows covered by one self-contained packed group."""
    return pack_factor(bits) * GROUP_ROWS


def pack_bitplanes(codes: Array, bits: int) -> Array:
    """Grouped-planar-pack unsigned codes along axis -2 into uint32.

    K (axis -2) is zero-padded to a multiple of ``planar_group_k(bits)``.
    Zero-pad is safe for GEMM because the matching activation rows are
    zero-padded too (and decoders may emit arbitrary values there).
    """
    f = pack_factor(bits)
    gk = planar_group_k(bits)
    codes = jnp.asarray(codes)
    *lead, k, n = codes.shape
    kp = -(-k // gk) * gk
    if kp != k:
        pad_width = [(0, 0)] * len(lead) + [(0, kp - k), (0, 0)]
        codes = jnp.pad(codes, pad_width)
    # (..., G, f, 32, N): field i of word (g, r) holds row g*gk + i*32 + r;
    # the fields are disjoint, so OR-ing them is a sum
    c = codes.astype(jnp.uint32).reshape(*lead, kp // gk, f, GROUP_ROWS, n)
    shifts = (jnp.arange(f, dtype=jnp.uint32) * jnp.uint32(bits)).reshape(f, 1, 1)
    words = jnp.sum(c << shifts, axis=-3, dtype=jnp.uint32)
    return words.reshape(*lead, (kp // gk) * GROUP_ROWS, n)


def unpack_bitplanes(word: Array, bits: int, k: int) -> Array:
    """Inverse of :func:`pack_bitplanes`; returns int32 codes, axis -2 = k."""
    f = pack_factor(bits)
    mask = jnp.uint32(2**bits - 1)
    *lead, r, n = word.shape
    assert r % GROUP_ROWS == 0, r
    # (..., G, 1, 32, N) >> (f, 1, 1) -> (..., G, f, 32, N): row g*gk + i*32 + r
    grp = word.reshape(*lead, r // GROUP_ROWS, 1, GROUP_ROWS, n)
    shifts = (jnp.arange(f, dtype=jnp.uint32) * jnp.uint32(bits)).reshape(f, 1, 1)
    codes = (grp >> shifts) & mask
    return codes.reshape(*lead, r * f, n)[..., :k, :].astype(jnp.int32)
