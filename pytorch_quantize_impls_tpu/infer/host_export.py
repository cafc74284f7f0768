"""Device-free packed export: trained params -> serving artifact, on host.

The on-device path (:mod:`infer.packed`) packs through jit/Pallas, which is
right when an accelerator is attached. Deployment pipelines usually are not: a CPU
box takes the training checkpoint and emits the packed artifact that serving
hosts load. This module produces BIT-IDENTICAL artifacts to
``infer.pack_model`` + ``infer.save_packed`` using numpy plus the native C++
codec (:mod:`utils.native`, threaded; falls back to numpy transparently).

The only JAX use here is one CPU-backend trace of the model on a dummy
sample to discover quantized-layer metadata (scheme, bits, fsr, shapes) —
no accelerator, no jit of the packing math itself.

Parity contract (tests/test_native.py): for every scheme,
``host_pack_model(...)`` == ``infer.pack_model(...)`` code-for-code.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

import flax.linen as fnn

from pytorch_quantize_impls_tpu.infer.packed import (
    PackedLayer,
    PackedModel,
    _flatten_conv_kernel,
    save_packed,
)
from pytorch_quantize_impls_tpu.nn.base import QuantConv, QuantDense
from pytorch_quantize_impls_tpu.utils import native


def collect_quant_layers(
    model: fnn.Module, variables, sample_x
) -> List[Tuple[Tuple[str, ...], Dict[str, Any], np.ndarray]]:
    """One forward trace -> [(path, metadata, master kernel as numpy)]."""
    found: List[Tuple[Tuple[str, ...], Dict[str, Any], np.ndarray]] = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        m = context.module
        if (
            context.method_name == "__call__"
            and isinstance(m, (QuantDense, QuantConv))
            and m.scheme != "none"
        ):
            meta = {
                "kind": "conv" if isinstance(m, QuantConv) else "dense",
                "scheme": m.scheme,
                "w_bits": m.w_bits,
                "a_bits": m.a_bits,
                "fsr": m.fsr,
            }
            kernel = np.asarray(m.variables["params"]["kernel"], np.float32)
            found.append((tuple(m.path), meta, kernel))
        return out

    with fnn.intercept_methods(interceptor):
        model.apply(variables, sample_x, train=False)
    return found


# --- numpy re-statements of the scheme grids (ops/* is the spec) -----------


def _dorefa_weight_np(w: np.ndarray, bits: int) -> np.ndarray:
    """ops.dorefa.dorefa_weight in f32 numpy (same grid, same guards)."""
    w = np.asarray(w, np.float32)
    if bits == 1:
        scale = np.mean(np.abs(w), dtype=np.float32)
        return (scale * np.where(w >= 0, 1.0, -1.0)).astype(np.float32)
    if bits >= 32:
        return w
    t = np.tanh(w, dtype=np.float32)
    m = np.max(np.abs(t))
    t = t / (np.float32(2.0) * (m if m > 0 else np.float32(1.0))) + np.float32(0.5)
    n = np.float32(2**bits - 1)
    q = (np.round(t * n) / n).astype(np.float32)
    return np.float32(2.0) * q - np.float32(1.0)


def _log_codes_np(w: np.ndarray, fsr: float, bits: int) -> np.ndarray:
    """ops.log_lin.log_quant_exponent + ops.pack.log_to_codes, in numpy."""
    lo, hi = fsr - 2**bits, fsr
    mag = np.abs(w)
    e = np.clip(
        np.round(np.log2(np.where(mag == 0, np.float32(2.0) ** lo, mag))),
        lo,
        hi,
    )
    idx = (e - lo).astype(np.int32)
    sign_bit = (w >= 0).astype(np.int32)  # safe_sign: sign(0) -> +1
    return (sign_bit << (bits + 1)) | np.clip(idx, 0, 2**bits)


def host_pack_kernel(meta: Dict[str, Any], kernel: np.ndarray) -> PackedLayer:
    """Pack one master kernel on host; mirrors ``infer.packed._pack_kernel``."""
    kind = meta["kind"]
    scheme = meta["scheme"]
    w_bits, a_bits, fsr = meta["w_bits"], meta["a_bits"], meta["fsr"]
    w2d = (
        _np_flatten_conv(kernel) if kind == "conv" else np.asarray(kernel)
    ).astype(np.float32)
    alpha = None
    if scheme in ("binary", "xnor"):
        if scheme == "xnor":
            axes = tuple(range(kernel.ndim - 1))
            alpha = np.mean(np.abs(kernel), axis=axes, dtype=np.float32)
        packed = native.pack_binary_planar(w2d)
    elif scheme == "dorefa":
        wq = _dorefa_weight_np(w2d, w_bits)
        n = np.float32(2**w_bits - 1)
        codes = np.round((wq + 1.0) * 0.5 * n).astype(np.int32)
        packed = native.pack_bitplanes(codes, w_bits)
    elif scheme == "log":
        packed = native.pack_bitplanes(_log_codes_np(w2d, fsr, w_bits), 8)
    elif scheme == "lin":
        step = np.float32(2.0 ** (fsr - w_bits))
        c = np.clip(np.round(w2d / step), -(2**w_bits), 2**w_bits)
        packed = native.pack_bitplanes((c + 2**w_bits).astype(np.int32), 8)
    elif scheme == "ternary":
        c = np.round(np.clip(w2d, -1, 1)) + 1  # {0,1,2}
        packed = native.pack_bitplanes(c.astype(np.int32), 2)
    else:
        raise ValueError(f"unpackable scheme {scheme!r}")
    return PackedLayer(
        packed=packed,
        alpha=alpha,
        kind=kind,
        scheme=scheme,
        w_bits=w_bits,
        a_bits=a_bits,
        fsr=fsr,
        kernel_shape=tuple(kernel.shape),
    )


def _np_flatten_conv(w: np.ndarray) -> np.ndarray:
    kh, kw, cin, cout = w.shape
    return w.transpose(2, 0, 1, 3).reshape(cin * kh * kw, cout)


_ = _flatten_conv_kernel  # same layout rule; jnp version kept for device path


def host_pack_model(model: fnn.Module, variables, sample_x) -> PackedModel:
    """Device-free twin of :func:`infer.packed.pack_model`."""
    return {
        path: host_pack_kernel(meta, kernel)
        for path, meta, kernel in collect_quant_layers(
            model, variables, sample_x
        )
    }


def export_packed(path: str, model: fnn.Module, variables, sample_x) -> int:
    """Pack on host and write the artifact; returns number of layers."""
    packed = host_pack_model(model, variables, sample_x)
    save_packed(path, packed)
    return len(packed)
