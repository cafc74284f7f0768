"""Packed 2-D convolution: int8 conv from bit-packed weights.

Covers BASELINE configs 2-5 (conv models). The packed weight planes are
decoded to int8 codes (weights are KB-scale — the decode is noise next to
the conv) and run through XLA's native int8 ``conv_general_dilated`` with a
scalar epilogue, while weights stay 1/2/4-bit in HBM.

Layouts: x NHWC, weights HWIO flattened to (cin*kh*kw, cout) *before*
packing (feature dim ordered (cin, kh, kw), see ``_flatten_hwio``); the
decode inverts that flattening back to HWIO.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu.kernels import xnor_gemm as bg
from pytorch_quantize_impls_tpu.kernels import packed_matmul as pm
from pytorch_quantize_impls_tpu.kernels import shift_matmul as sm


class PackedConv(NamedTuple):
    """Frozen packed conv weights + metadata (inference export unit)."""

    scheme: str  # 'binary' | 'xnor' | 'dorefa' | 'log'
    packed: jax.Array
    kernel_size: Tuple[int, int]
    cin: int
    cout: int
    alpha: Optional[jax.Array] = None  # xnor per-out-channel scale
    w_bits: int = 1
    a_bits: int = 32
    fsr: float = 0.0


def _flatten_hwio(w: jax.Array) -> jax.Array:
    """HWIO (kh,kw,cin,cout) -> (cin*kh*kw, cout) in patch order.

    ``conv_general_dilated_patches`` with NHWC emits features ordered
    channel-major: (cin, kh, kw).
    """
    kh, kw, cin, cout = w.shape
    return w.transpose(2, 0, 1, 3).reshape(cin * kh * kw, cout)


def pack_conv_weights(
    w: jax.Array,
    scheme: str,
    *,
    w_bits: int = 1,
    a_bits: int = 32,
    fsr: float = 0.0,
) -> PackedConv:
    """Pack HWIO conv weights for the given scheme (weights already on-grid
    for 'dorefa'; raw fp for 'binary'/'xnor'/'log')."""
    kh, kw, cin, cout = w.shape
    flat = _flatten_hwio(w)
    alpha = None
    if scheme == "xnor":
        alpha = jnp.mean(jnp.abs(w), axis=(0, 1, 2))
        packed = bg.pack_binary_weights(flat)
    elif scheme == "binary":
        packed = bg.pack_binary_weights(flat)
    elif scheme == "dorefa":
        packed = pm.pack_dorefa_weights(flat, w_bits)
    elif scheme == "log":
        packed = sm.pack_log_weights(flat, fsr, w_bits)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return PackedConv(
        scheme, packed, (kh, kw), cin, cout, alpha, w_bits, a_bits, fsr
    )


_DN = ("NHWC", "HWIO", "NHWC")


def decode_conv_weights(pw: PackedConv) -> jax.Array:
    """Packed flat planes -> HWIO code weights for the int8 conv.

    binary/xnor: ±1 int8; dorefa: centered int8 codes ``2c - n_w``;
    log: exact ±2^e bf16. Inverts ``_flatten_hwio``'s (cin, kh, kw)
    channel-major flattening (decode pads K to the plane group — slice it).
    """
    kh, kw = pw.kernel_size
    k = pw.cin * kh * kw
    if pw.scheme in ("binary", "xnor"):
        flat = bg.decode_binary_weights(pw.packed)[:k]
    elif pw.scheme == "dorefa":
        flat = pm.decode_dorefa_weights(pw.packed, w_bits=pw.w_bits)[:k]
    elif pw.scheme == "log":
        flat = sm.decode_log_weights(pw.packed, fsr=pw.fsr, bits=pw.w_bits)[:k]
    else:
        raise ValueError(pw.scheme)
    return flat.reshape(pw.cin, kh, kw, pw.cout).transpose(1, 2, 0, 3)


def int8_conv(x, w, strides, padding):
    """int8 x int8 conv with exact integer sums returned as float32.

    cuDNN's integer convolutions give int8 or float32 results, never int32
    (XLA's GPU backend refuses an int32 one at compile time), so the sums
    are asked for in float32. That is exact while every |sum| < 2^24: binary
    layers reach at most K = kh*kw*cin <= 4,608 and 4-bit DoReFa layers at
    most 15 * 15 * 4,608 ~= 1.04M, so every layer of the model zoo qualifies.
    """
    return jax.lax.conv_general_dilated(
        x, w, strides, padding, dimension_numbers=_DN,
        preferred_element_type=jnp.float32,
    )


def packed_conv2d(
    x: jax.Array,
    pw: PackedConv,
    *,
    strides: Tuple[int, int] = (1, 1),
    padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
) -> jax.Array:
    """NHWC packed conv: decoded weights through XLA's int8 (bf16 for log)
    conv. Input handling per scheme:

    'binary'/'xnor': x is sign-binarized (full-binary conv; pre-scale real
    inputs outside if needed); 'dorefa': x is fake-quant [0,1] activations
    (``a_bits``); 'log': x used as-is in bf16.
    """
    w4 = decode_conv_weights(pw)
    if pw.scheme in ("binary", "xnor"):
        # Binarize real inputs to ±1 codes; conv's internal SAME-padding
        # zeros are exact (code 0 == value 0), matching fake-quant conv.
        xi = x if x.dtype == jnp.int8 else jnp.where(x >= 0, 1, -1).astype(jnp.int8)
        y = int8_conv(xi, w4, strides, padding)
        if pw.alpha is not None:
            y = y * pw.alpha
        return y
    if pw.scheme == "dorefa":
        codes = x if x.dtype == jnp.int8 else pm.dorefa_act_to_int8(x, pw.a_bits)
        y = int8_conv(codes, w4, strides, padding)
        n_w = 2**pw.w_bits - 1
        n_a = 2**pw.a_bits - 1
        return y * (1.0 / (n_w * n_a))
    if pw.scheme == "log":
        return jax.lax.conv_general_dilated(
            x.astype(jnp.bfloat16), w4, strides, padding,
            dimension_numbers=_DN, preferred_element_type=jnp.float32,
        )
    raise ValueError(pw.scheme)
