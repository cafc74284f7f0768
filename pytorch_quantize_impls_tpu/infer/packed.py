"""Generic packed-model export + execution via flax method interception.

Per-scheme execution plan (PERF.md has the measured rates):

| scheme  | inputs quantized?    | path                                        |
|---------|----------------------|---------------------------------------------|
| binary  | yes (a_bits=1)       | int8 GEMM on ±1 (exact)                     |
| xnor    | yes                  | int8 GEMM + alpha epilogue (exact)          |
| binary/xnor, fp inputs | no    | decoded ±1 weights -> float dot             |
| dorefa  | yes (a_bits>=1)      | integer-code GEMM + affine epilogue (exact) |
| dorefa, fp inputs      | no    | decoded grid weights -> float dot           |
| log     | any                  | shift (bf16 bit-assembly) GEMM              |
| lin     | any                  | decoded grid weights -> float dot           |
| ternary | any                  | decoded {-1,0,1} weights -> float dot       |

All paths keep weights packed in HBM (1-8 bits/value); ``prepare`` decodes
hot layers once (weight-stationary serving).
"""

from __future__ import annotations

import json
import zipfile
from typing import Any, Dict, Optional, Tuple

import flax.linen as fnn
import numpy as np

import jax
import jax.numpy as jnp
from flax import struct

from pytorch_quantize_impls_tpu.nn.base import QuantConv, QuantDense
from pytorch_quantize_impls_tpu.ops import log_lin
from pytorch_quantize_impls_tpu.ops import pack as packlib
import pytorch_quantize_impls_tpu.kernels as _k  # noqa: F401  (init modules)
import sys

_bg = sys.modules["pytorch_quantize_impls_tpu.kernels.xnor_gemm"]
_pm = sys.modules["pytorch_quantize_impls_tpu.kernels.packed_matmul"]
_sm = sys.modules["pytorch_quantize_impls_tpu.kernels.shift_matmul"]


@struct.dataclass
class PackedLayer:
    packed: jax.Array  # grouped-planar packed weight codes
    alpha: Optional[jax.Array] = None  # xnor per-out-channel scale
    decoded: Optional[jax.Array] = None  # prepare(): int8 or bf16 weights
    # static metadata
    kind: str = struct.field(pytree_node=False, default="dense")  # dense|conv
    scheme: str = struct.field(pytree_node=False, default="binary")
    w_bits: int = struct.field(pytree_node=False, default=1)
    a_bits: int = struct.field(pytree_node=False, default=0)
    fsr: float = struct.field(pytree_node=False, default=0.0)
    kernel_shape: Tuple[int, ...] = struct.field(pytree_node=False, default=())


PackedModel = Dict[Tuple[str, ...], PackedLayer]


def _flatten_conv_kernel(w):
    kh, kw, cin, cout = w.shape
    return w.transpose(2, 0, 1, 3).reshape(cin * kh * kw, cout)


def _pack_kernel(m, kernel) -> PackedLayer:
    kind = "conv" if isinstance(m, QuantConv) else "dense"
    w2d = _flatten_conv_kernel(kernel) if kind == "conv" else kernel
    alpha = None
    if m.scheme in ("binary", "xnor"):
        if m.scheme == "xnor":
            axes = tuple(range(kernel.ndim - 1))
            alpha = jnp.mean(jnp.abs(kernel), axis=axes)
        packed = _bg.pack_binary_weights(w2d)
    elif m.scheme == "dorefa":
        from pytorch_quantize_impls_tpu.ops.dorefa import dorefa_weight

        packed = _pm.pack_dorefa_weights(dorefa_weight(w2d, m.w_bits), m.w_bits)
    elif m.scheme == "log":
        packed = _sm.pack_log_weights(w2d, m.fsr, m.w_bits)
    elif m.scheme == "lin":
        # signed grid codes c = round(w/step) clipped to ±2^bits, offset into
        # [0, 2^(bits+1)]; 8-bit planar fields (bits <= 6).
        step = 2.0 ** (m.fsr - m.w_bits)
        c = jnp.clip(jnp.round(w2d / step), -(2**m.w_bits), 2**m.w_bits)
        packed = packlib.pack_bitplanes(
            (c + 2**m.w_bits).astype(jnp.int32), 8
        )
    elif m.scheme == "ternary":
        c = jnp.round(jnp.clip(w2d, -1, 1)) + 1  # {0,1,2}
        packed = packlib.pack_bitplanes(c.astype(jnp.int32), 2)
    else:
        raise ValueError(f"unpackable scheme {m.scheme!r}")
    return PackedLayer(
        packed=packed,
        alpha=alpha,
        kind=kind,
        scheme=m.scheme,
        w_bits=m.w_bits,
        a_bits=m.a_bits,
        fsr=m.fsr,
        kernel_shape=tuple(kernel.shape),
    )


def _decode_weights(rec: PackedLayer) -> jax.Array:
    """Packed codes -> execution-ready weights (int8 ±1 or bf16 grid)."""
    k2d = (
        rec.kernel_shape[0]
        if rec.kind == "dense"
        else int(np.prod(rec.kernel_shape[:-1]))
    )
    if rec.scheme in ("binary", "xnor"):
        return _bg.decode_binary_weights(rec.packed)[:k2d]
    if rec.scheme == "dorefa":
        # f32: the k-bit grid {2i/n - 1} is not bf16-exact
        c = packlib.unpack_bitplanes(rec.packed, rec.w_bits, k2d)
        n = 2**rec.w_bits - 1
        return ((2.0 * c - n) / n).astype(jnp.float32)
    if rec.scheme == "log":
        codes = packlib.unpack_bitplanes(rec.packed, _sm.CODE_BITS, k2d)
        sign, idx = packlib.codes_to_log(codes, rec.w_bits)
        return log_lin.log_quant_from_exponent(
            sign.astype(jnp.float32), idx, rec.fsr, rec.w_bits
        ).astype(jnp.bfloat16)
    if rec.scheme == "lin":
        c = packlib.unpack_bitplanes(rec.packed, 8, k2d) - 2**rec.w_bits
        step = 2.0 ** (rec.fsr - rec.w_bits)
        return (c * step).astype(jnp.float32)
    if rec.scheme == "ternary":
        c = packlib.unpack_bitplanes(rec.packed, 2, k2d) - 1
        return c.astype(jnp.bfloat16)
    raise ValueError(rec.scheme)


def pack_model(model: fnn.Module, variables, sample_x) -> PackedModel:
    """Trace the model once, packing every quantized layer's master kernel."""
    records: PackedModel = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        m = context.module
        if (
            context.method_name == "__call__"
            and isinstance(m, (QuantDense, QuantConv))
            and m.scheme != "none"
        ):
            kernel = m.variables["params"]["kernel"]
            records[tuple(m.path)] = _pack_kernel(m, kernel)
        return out

    with fnn.intercept_methods(interceptor):
        model.apply(variables, sample_x, train=False)
    return records


def _decode_execution(rec: PackedLayer):
    """The weight-stationary buffer the layer's hot path actually consumes.

    dorefa with int-quantized activations runs the integer GEMM, which
    wants CENTERED INT8 CODES (2c - n_w), not fake-quant f32 values; every
    other case executes on decoded values (``_decode_weights``). The rule
    matches the dispatch in ``_dense_forward_2d``: codes exactly when the
    fp fallback can never be taken for this record.
    """
    if rec.scheme == "dorefa" and 1 <= rec.a_bits <= 7:
        return _pm.decode_dorefa_weights(rec.packed, w_bits=rec.w_bits)
    return _decode_weights(rec)


def prepare(packed: PackedModel) -> PackedModel:
    """Decode every layer's execution buffer once (weight-stationary)."""
    return {
        path: rec.replace(decoded=_decode_execution(rec))
        for path, rec in packed.items()
    }


def _dense_forward(m: QuantDense, rec: PackedLayer, x, bias, tp_axis=None):
    # packed GEMM kernels take (M, K); fold any leading batch/sequence dims
    if x.ndim == 1:
        return _dense_forward_2d(m, rec, x[None], bias, tp_axis)[0]
    lead = x.shape[:-1]
    if x.ndim > 2:
        x = x.reshape(-1, x.shape[-1])
    y = _dense_forward_2d(m, rec, x, bias, tp_axis)
    return y.reshape(*lead, y.shape[-1]) if len(lead) != 1 else y


def _dense_forward_2d(m: QuantDense, rec: PackedLayer, x, bias, tp_axis=None):
    """One packed GEMM. ``tp_axis`` (a mesh axis name, inside shard_map):
    this rank holds a COLUMN SHARD of the packed codes (pack runs along K,
    so any N-split lands on unpacked element boundaries — SURVEY.md §2
    pack-after-shard discipline); the local GEMM computes an N-shard and a
    tiled all-gather reassembles the full output (column-parallel TP:
    "packed low-bit weights tensor-sharded over the mesh", BASELINE.json:5).
    """
    if rec.scheme in ("binary", "xnor") and rec.a_bits == 1:
        xi = jnp.where(x >= 0, 1, -1).astype(jnp.int8)
        if rec.decoded is not None:
            y = _bg.binary_gemm_decoded(
                xi, rec.decoded, rec.alpha, out_dtype=jnp.float32
            )
        else:
            y = _bg.binary_gemm(xi, rec.packed, rec.alpha)
    elif rec.scheme == "dorefa" and rec.a_bits >= 1 and rec.a_bits <= 7:
        from pytorch_quantize_impls_tpu.ops.dorefa import dorefa_activation

        aq = dorefa_activation(x, rec.a_bits)
        codes = _pm.dorefa_act_to_int8(aq, rec.a_bits)
        if rec.decoded is not None:
            # prepare()d weight-stationary serving mode (int8-resident),
            # same dispatch discipline as the binary branch above
            y = _pm.dorefa_gemm_decoded(
                codes, rec.decoded, w_bits=rec.w_bits, a_bits=rec.a_bits
            )
        else:
            y = _pm.dorefa_gemm(
                codes, rec.packed, w_bits=rec.w_bits, a_bits=rec.a_bits
            )
    elif rec.scheme == "log" and rec.decoded is None:
        y = _sm.shift_gemm(x, rec.packed, fsr=rec.fsr, bits=rec.w_bits)
    else:
        # fp-input fallback: decoded weights at the input dtype, default
        # precision (on the GPU f32 inputs run as TF32; on the CPU exact
        # f32).
        w = rec.decoded if rec.decoded is not None else _decode_weights(rec)
        y = jnp.dot(x, w.astype(x.dtype), preferred_element_type=jnp.float32)
        if rec.alpha is not None:
            y = y * rec.alpha[None, :]
    if tp_axis is not None:
        # local (M, N/n) column shard -> full (M, N); shard order == axis
        # order, so the tiled gather reassembles the original columns
        y = jax.lax.all_gather(y, tp_axis, axis=1, tiled=True)
    if bias is not None:
        y = y + bias
    return y.astype(x.dtype)


def _conv_forward(m: QuantConv, rec: PackedLayer, x, bias):
    from pytorch_quantize_impls_tpu.kernels.conv import PackedConv, packed_conv2d

    kh, kw, cin, cout = rec.kernel_shape
    if rec.scheme in ("binary", "xnor", "dorefa") and (
        rec.a_bits >= 1
    ):
        pc = PackedConv(
            scheme="xnor" if rec.scheme == "xnor" else rec.scheme,
            packed=rec.packed,
            kernel_size=(kh, kw),
            cin=cin,
            cout=cout,
            alpha=rec.alpha,
            w_bits=rec.w_bits,
            a_bits=rec.a_bits,
            fsr=rec.fsr,
        )
        xin = x
        if rec.scheme == "dorefa":
            from pytorch_quantize_impls_tpu.ops.dorefa import dorefa_activation

            xin = dorefa_activation(x, rec.a_bits)
        y = packed_conv2d(xin, pc, strides=m.strides, padding=m.padding)
    else:
        # fp-input convs: decoded weights, standard XLA conv at input dtype
        w2d = rec.decoded if rec.decoded is not None else _decode_weights(rec)
        w4d = (
            w2d.reshape(cin, kh, kw, cout).transpose(1, 2, 0, 3).astype(x.dtype)
        )
        y = jax.lax.conv_general_dilated(
            x,
            w4d,
            window_strides=m.strides,
            padding=m.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32,
        )
        if rec.alpha is not None:
            y = y * rec.alpha[None, None, None, :]
    if bias is not None:
        y = y + bias
    return y.astype(x.dtype)


def packed_apply(
    model: fnn.Module, variables, packed: PackedModel, x, *, tp_axis=None,
    **kwargs,
):
    """Eval forward with every quantized layer dispatched to its packed path.

    Non-quantized modules (BatchNorm, activations, pooling, K-maps, heads)
    run unchanged from ``variables``.

    ``tp_axis``: mesh axis name when called INSIDE shard_map with the dense
    layers' packed buffers column-sharded over that axis (see
    :func:`packed_tp_specs`) — each dense GEMM runs on its local N-shard and
    all-gathers the output.
    """

    def interceptor(next_fun, args, kwargs_, context):
        m = context.module
        if (
            context.method_name == "__call__"
            and isinstance(m, (QuantDense, QuantConv))
            and m.scheme != "none"
        ):
            rec = packed.get(tuple(m.path))
            if rec is not None:
                bias = (
                    m.variables["params"]["bias"] if m.use_bias else None
                )
                if isinstance(m, QuantConv):
                    return _conv_forward(m, rec, args[0], bias)
                return _dense_forward(m, rec, args[0], bias, tp_axis)
        return next_fun(*args, **kwargs_)

    with fnn.intercept_methods(interceptor):
        return model.apply(variables, x, train=False, **kwargs)


def packed_tp_specs(packed: PackedModel, axis: str):
    """PartitionSpec pytree (same treedef as ``packed``) for shard_map
    ``in_specs``: dense layers column-sharded over ``axis`` (codes and
    decoded buffers on their N axis, alpha on its only axis); conv layers
    replicated (conv TP is not wired — CNN serving shards on data)."""
    from jax.sharding import PartitionSpec as P

    out: Dict[Tuple[str, ...], PackedLayer] = {}
    for path, rec in packed.items():
        if rec.kind == "dense":
            out[path] = rec.replace(
                packed=P(None, axis),
                alpha=None if rec.alpha is None else P(axis),
                decoded=None if rec.decoded is None else P(None, axis),
            )
        else:
            out[path] = rec.replace(
                packed=P(),
                alpha=None if rec.alpha is None else P(),
                decoded=None if rec.decoded is None else P(),
            )
    return out


# --- inference-only export artifact ---------------------------------------


def save_packed(path: str, packed: PackedModel) -> None:
    """Write the packed model artifact: npz arrays + json metadata."""
    meta = {}
    arrays = {}
    for i, (mpath, rec) in enumerate(sorted(packed.items())):
        key = f"layer{i}"
        meta[key] = {
            "path": list(mpath),
            "kind": rec.kind,
            "scheme": rec.scheme,
            "w_bits": rec.w_bits,
            "a_bits": rec.a_bits,
            "fsr": rec.fsr,
            "kernel_shape": list(rec.kernel_shape),
            "has_alpha": rec.alpha is not None,
        }
        arrays[f"{key}_packed"] = np.asarray(rec.packed)
        if rec.alpha is not None:
            arrays[f"{key}_alpha"] = np.asarray(rec.alpha)
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_packed(path: str) -> PackedModel:
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    out: PackedModel = {}
    for key, m in meta.items():
        out[tuple(m["path"])] = PackedLayer(
            packed=jnp.asarray(data[f"{key}_packed"]),
            alpha=(
                jnp.asarray(data[f"{key}_alpha"]) if m["has_alpha"] else None
            ),
            kind=m["kind"],
            scheme=m["scheme"],
            w_bits=m["w_bits"],
            a_bits=m["a_bits"],
            fsr=m["fsr"],
            kernel_shape=tuple(m["kernel_shape"]),
        )
    return out
