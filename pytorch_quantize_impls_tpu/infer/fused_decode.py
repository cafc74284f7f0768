"""Fused serving-time decode step for the 1-bit transformer LM.

The CNN fused chains (infer/fused_chain.py) proved that model-level low-bit
wins live at the LAYER BOUNDARIES, not inside the GEMMs. This module applies
the same discipline to the autoregressive decode step (VERDICT r4 #4), which
the generic interception path (infer/packed.py::packed_apply) cannot: it
dispatches one QuantDense at a time, so activations round-trip through f32
between projections and the KV cache is dequantized wholesale every step.

The fused step (binary scheme, W1A1 — the serving bench workload):

  - ONE sign-binarize per boundary, shared by all consumers: the post-LN
    stream is binarized once and the Q/K/V projections run as a SINGLE
    int8 GEMM over the concatenated (d, 3d) weight (3x fewer dispatches).
  - Attention runs in ONE pass over the int8 KV cache
    (kernels/decode_attention.py): dequant scales fold into the score /
    attention vectors, so a dequantized cache copy — the dominant HBM
    traffic at batch >= 8 — never materializes.
  - The FFN hidden boundary collapses to a per-channel THRESHOLD on the
    int32 accumulator (sign(y + b) == [y >= -b]), exactly the fused-chain
    trick: the (b, d_ff) hidden activation crosses as int8 codes.
  - Weights are int8-resident (32x smaller than the f32 masters the
    fake-quant path re-reads every step; same residency as prepare()).

Cache layout is b-h-major ((b, h, cl, hd)) for unit-stride kernel reads,
with leaf NAMES mirroring the flax cache ("k_codes"/"k_scale"/.../"index",
"pos_index") so serve.DecodeEngine's slot admit/reset machinery works on
either pytree unchanged (leading dim is the slot axis in both).

Model reference: models/transformer.py (QuantTransformerLM, decode mode);
exact-parity contract with the fake-quant model per SURVEY.md §3.5.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu.kernels.decode_attention import decode_attention
from pytorch_quantize_impls_tpu.kernels.int8_matmul import int8_gemm
from pytorch_quantize_impls_tpu.kernels.xnor_gemm import (
    binary_gemm, pack_binary_weights,
)
from pytorch_quantize_impls_tpu.ops import kv_cache as kvlib


def _static(default):
    """A dataclass field that is pytree metadata, not a leaf."""
    return dataclasses.field(default=default, metadata={"static": True})


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FusedDecodeLayer:
    w_qkv: jax.Array  # (d, 3d) int8 ±1 — concatenated q|k|v sign codes
    w_out: jax.Array  # (d, d) int8 ±1
    w1: jax.Array  # (d, d_ff) int8 ±1
    thr1: jax.Array  # (d_ff,) f32 — hidden codes = +1 iff acc >= thr1 (-b1)
    w2: jax.Array  # (d_ff, d) int8 ±1
    b2: Optional[jax.Array]  # (d,) f32
    ln1_scale: jax.Array
    ln1_bias: jax.Array
    ln2_scale: jax.Array
    ln2_bias: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FusedDecodeModel:
    embed: jax.Array  # (vocab, d) f32 — tied head
    pos: jax.Array  # (max_len, d) f32
    layers: Tuple[FusedDecodeLayer, ...]
    lnf_scale: jax.Array
    lnf_bias: jax.Array
    # static
    n_heads: int = _static(8)
    max_len: int = _static(1024)
    kv_bits: int = _static(8)
    ln_eps: float = _static(1e-6)


def _sign_i8(x):
    return jnp.where(x >= 0, 1, -1).astype(jnp.int8)


def _ln(x, scale, bias, eps):
    x = x.astype(jnp.float32)
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mu), axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * scale + bias


def _gemm_i8(c, w):
    """±1 int8 codes @ weight -> f32 (exact integer accumulate).

    ``w`` is either int8 ±1 codes (``int8_gemm``, XLA's int8 dot) or
    planar-packed uint32 1-bit planes (``binary_gemm``: at decode-sized M
    on the GPU a Triton kernel that reads 8x fewer weight bytes per step).
    Both are exact."""
    if w.dtype == jnp.uint32:
        return binary_gemm(c, w, None, out_dtype=jnp.float32)
    return int8_gemm(c, w, out_dtype=jnp.float32)


def export_fused_decode(model, variables, *, weights: str = "int8") -> FusedDecodeModel:
    """Build the fused decode program from a trained ``QuantTransformerLM``.

    Requires ``scheme='binary', w_bits=1, a_bits=1`` (the 1-bit serving
    configuration), dense FFN (no MoE), quantized KV cache.

    ``weights``: ``"int8"`` keeps decoded ±1 int8 codes resident (XLA int8
    dot path); ``"packed"`` keeps planar 1-bit uint32 planes resident
    (``binary_gemm``, 8x less weight traffic per decode step).
    """
    if weights not in ("int8", "packed"):
        raise ValueError(f"weights must be 'int8' or 'packed', got {weights!r}")
    if model.scheme != "binary" or model.w_bits != 1 or model.a_bits != 1:
        raise ValueError(
            "fused decode supports the binary W1A1 serving config; got "
            f"scheme={model.scheme!r} w_bits={model.w_bits} a_bits={model.a_bits}"
        )
    if model.n_experts > 0:
        raise ValueError("fused decode does not support MoE FFNs")
    if model.kv_bits is None:
        raise ValueError("fused decode requires a quantized KV cache")
    p = variables["params"]

    def mk_w(codes_i8):
        if weights == "packed":
            return pack_binary_weights(codes_i8.astype(jnp.float32))
        return codes_i8

    layers = []
    for i in range(model.n_layers):
        bp = p[f"block{i}"]
        ap = bp["attn"]
        w_qkv = jnp.concatenate(
            [_sign_i8(ap[n]["kernel"]) for n in ("q", "k", "v")], axis=1
        )
        b1 = bp["ffn_in"].get("bias")
        d_ff = bp["ffn_in"]["kernel"].shape[1]
        layers.append(
            FusedDecodeLayer(
                w_qkv=mk_w(w_qkv),
                w_out=mk_w(_sign_i8(ap["out"]["kernel"])),
                w1=mk_w(_sign_i8(bp["ffn_in"]["kernel"])),
                thr1=(
                    -b1.astype(jnp.float32)
                    if b1 is not None
                    else jnp.zeros((d_ff,), jnp.float32)
                ),
                w2=mk_w(_sign_i8(bp["ffn_out"]["kernel"])),
                b2=(
                    bp["ffn_out"]["bias"].astype(jnp.float32)
                    if "bias" in bp["ffn_out"]
                    else None
                ),
                ln1_scale=bp["ln1"]["scale"].astype(jnp.float32),
                ln1_bias=bp["ln1"]["bias"].astype(jnp.float32),
                ln2_scale=bp["ln2"]["scale"].astype(jnp.float32),
                ln2_bias=bp["ln2"]["bias"].astype(jnp.float32),
            )
        )
    return FusedDecodeModel(
        embed=p["embed"]["embedding"].astype(jnp.float32),
        pos=p["pos_embed"].astype(jnp.float32),
        layers=tuple(layers),
        lnf_scale=p["ln_f"]["scale"].astype(jnp.float32),
        lnf_bias=p["ln_f"]["bias"].astype(jnp.float32),
        n_heads=model.n_heads,
        max_len=model.max_len,
        kv_bits=model.kv_bits,
    )


def fused_init_cache(fm: FusedDecodeModel, b: int):
    """Fresh cache pytree (flax-compatible leaf names, b-h-major layout)."""
    d = fm.embed.shape[1]
    h, hd, cl = fm.n_heads, d // fm.n_heads, fm.max_len
    cache = {
        f"block{i}": {
            "attn": {
                "k_codes": jnp.zeros((b, h, cl, hd), jnp.int8),
                "k_scale": jnp.zeros((b, h, cl), jnp.float32),
                "v_codes": jnp.zeros((b, h, cl, hd), jnp.int8),
                "v_scale": jnp.zeros((b, h, cl), jnp.float32),
                "index": jnp.zeros((b,), jnp.int32),
            }
        }
        for i in range(len(fm.layers))
    }
    cache["pos_index"] = jnp.zeros((b,), jnp.int32)
    return cache


# f32 products at full precision: on the GPU the default would round the
# operands to TF32, and a sign-binarized stream amplifies that rounding.
_HI = jax.lax.Precision.HIGHEST


def _attend_cached(q, att, offset, s, fm):
    """Multi-query attention over the full cache (prefill path, plain XLA):
    scales fold into scores / attention weights — no dequant cache copy."""
    b, _, h, hd = q.shape
    cl = att["k_codes"].shape[2]
    kf = att["k_codes"].astype(jnp.float32)
    scores = jnp.einsum("bqhd,bhkd->bhqk", q, kf, precision=_HI)
    scores = scores * att["k_scale"][:, :, None, :]
    scores = scores * hd**-0.5  # correctly rounded, as in decode_attention
    q_pos = offset[:, None] + jnp.arange(s)[None, :]  # (b, s)
    mask = jnp.arange(cl)[None, None, :] <= q_pos[..., None]  # (b, s, cl)
    scores = jnp.where(mask[:, None], scores, -1e30)
    attn = jax.nn.softmax(scores, axis=-1)
    attn = attn * att["v_scale"][:, :, None, :]
    vf = att["v_codes"].astype(jnp.float32)
    return jnp.einsum("bhqk,bhkd->bqhd", attn, vf, precision=_HI)


def fused_decode_apply(fm: FusedDecodeModel, cache, toks):
    """Forward ``toks`` (b, s) through the fused program.

    Returns ``(logits (b, s, vocab) f32, {"cache": new_cache})`` — the same
    contract as ``model.apply(..., mutable=["cache"])``, so the serving
    engine can swap this in as its execution backend. ``cache=None`` starts
    from a fresh cache (mirrors flax auto-init on first apply).

    s == 1 runs the fused single-token step (``decode_attention``);
    s > 1 is the prefill path (same math, batched queries, plain XLA).
    """
    b, s = toks.shape
    d = fm.embed.shape[1]
    h, hd = fm.n_heads, d // fm.n_heads
    if cache is None:
        cache = fused_init_cache(fm, b)
    new_cache = {}

    offset = cache["pos_index"]
    idx = jnp.clip(offset[:, None] + jnp.arange(s)[None, :], 0, fm.max_len - 1)
    x = fm.embed[toks] + fm.pos[idx]  # (b, s, d) f32
    new_cache["pos_index"] = offset + s

    rows = jnp.arange(b)[:, None, None]  # slot
    heads = jnp.arange(h)[None, :, None]

    for i, ly in enumerate(fm.layers):
        att = cache[f"block{i}"]["attn"]
        cur = att["index"]  # (b,) per-slot cursor
        hx = _ln(x, ly.ln1_scale, ly.ln1_bias, fm.ln_eps)
        c = _sign_i8(hx)  # ONE binarize feeds q, k, v
        qkv = _gemm_i8(c.reshape(b * s, d), ly.w_qkv).reshape(b, s, 3 * d)
        q, k, v = jnp.split(qkv, 3, axis=-1)
        q = q.reshape(b, s, h, hd)
        k_codes, k_scale = kvlib.quantize_kv(
            k.reshape(b, s, h, hd), fm.kv_bits
        )
        v_codes, v_scale = kvlib.quantize_kv(
            v.reshape(b, s, h, hd), fm.kv_bits
        )
        # write this call's K/V at the per-slot cursor (b-h-major layout)
        ccols = cur[:, None, None] + jnp.arange(s)[None, None, :]
        natt = {
            "k_codes": att["k_codes"].at[rows, heads, ccols].set(
                k_codes.transpose(0, 2, 1, 3)
            ),
            "k_scale": att["k_scale"].at[rows, heads, ccols].set(
                k_scale.transpose(0, 2, 1)
            ),
            "v_codes": att["v_codes"].at[rows, heads, ccols].set(
                v_codes.transpose(0, 2, 1, 3)
            ),
            "v_scale": att["v_scale"].at[rows, heads, ccols].set(
                v_scale.transpose(0, 2, 1)
            ),
            "index": cur + s,
        }
        new_cache[f"block{i}"] = {"attn": natt}
        if s == 1:
            cl = natt["k_codes"].shape[2]
            bias = jnp.where(
                jnp.arange(cl)[None, :] <= cur[:, None], 0.0, -1e30
            ).astype(jnp.float32)
            ctx = decode_attention(
                q[:, 0], natt["k_codes"], natt["k_scale"],
                natt["v_codes"], natt["v_scale"], bias,
            ).reshape(b, 1, d)
        else:
            ctx = _attend_cached(q, natt, cur, s, fm).reshape(b, s, d)
        c2 = _sign_i8(ctx)
        x = x + _gemm_i8(c2.reshape(b * s, d), ly.w_out).reshape(b, s, d)

        h2 = _ln(x, ly.ln2_scale, ly.ln2_bias, fm.ln_eps)
        c3 = _sign_i8(h2)
        y1 = _gemm_i8(c3.reshape(b * s, d), ly.w1)  # (b*s, d_ff) int acc
        # hidden boundary as a threshold: sign(y1 + bias1) == [y1 >= -b1]
        c4 = jnp.where(y1 >= ly.thr1[None, :], 1, -1).astype(jnp.int8)
        y2 = _gemm_i8(c4, ly.w2).reshape(b, s, d)
        if ly.b2 is not None:
            y2 = y2 + ly.b2
        x = x + y2

    x = _ln(x, fm.lnf_scale, fm.lnf_bias, fm.ln_eps)
    logits = jnp.einsum("bsd,vd->bsv", x, fm.embed, precision=_HI)
    return logits, {"cache": new_cache}
