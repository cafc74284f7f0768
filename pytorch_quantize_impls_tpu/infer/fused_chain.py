"""Fused int8-chained inference for sequential binary-conv stacks.

VERDICT r3 #3 / BASELINE.json:5 ("every dequant/popcount matmul kernel at
speed-of-light"): the generic packed path (``infer/packed.py``) runs each
conv's int32 accumulator through f32 (+α), eval BatchNorm, and pooling in
f32, then re-binarizes at the next conv's input — three full-activation
f32 HBM round-trips per stage; at the CIFAR widths that boundary traffic,
not the convs, is what the packed path spends its time on.

This module folds the entire stage boundary into the conv epilogue.
Eval-mode BatchNorm is a per-channel affine ``z = γ·(αy − μ)/s + β``
(``s = sqrt(σ² + ε)``, ``u = α·y`` the α-scaled conv accumulator) and the
next layer's input binarization is ``sign(z)`` — so the next layer's input
codes are a per-channel *threshold comparison* on the raw conv accumulator:

    code = hi  if y >= t,  else lo
    t    = (μ − β·s/γ) / α
    (hi, lo) = (+1, −1) if γ > 0;  (−1, +1) if γ < 0;  (sign(β),)·2 if γ = 0

Max-pooling commutes with the monotone ``sign`` (``pool(sign(z)) ==
sign(pool(z))``, including the γ<0 flip because the flip happens inside the
per-element code), so pooling runs on the int8 codes. Activations therefore
cross stage boundaries as ±1 int8 — 1 byte, never materialized in f32 —
and the hidden convs run int8×int8 with exact integer sums.

Exactness: every int8-input stage is exact integer arithmetic; the only
deviations from the fake-quant path are (a) the threshold is computed in a
different f32 expression order than BN's (boundary-ulp differences at
measure-zero inputs), and (b) for γ<0 a y exactly at the threshold codes −1
instead of +1 (the fake path's sign(0)→+1; measure-zero again). The parity
test gates on logits, not codes.

Constraint: the XNOR input scale map K must be off
(``XNORConvNet(use_input_scale_map=False)``) — K is computed from real
input magnitudes the code chain never materializes. The XNOR paper (§3.2
discussion) itself drops K at inference for speed.

Reference lineage: the reference (QuantTorch) has no true low-bit execution
at all (SURVEY.md §1: fake-quant only); this path is new scope mandated by
BASELINE.json:5.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu.kernels.conv import int8_conv


def _static(default):
    """A dataclass field that is pytree metadata, not a leaf."""
    return dataclasses.field(default=default, metadata={"static": True})


def _pytree_dataclass(cls):
    return jax.tree_util.register_dataclass(dataclasses.dataclass(frozen=True)(cls))


@_pytree_dataclass
class FusedStage:
    """One conv/dense stage with its boundary folded into the epilogue."""

    w: jax.Array  # HWIO weights: int8 ±1 codes (code-input) or fp (first)
    # binarize epilogue (hidden stages): per-cout threshold + codes
    thr: Optional[jax.Array] = None  # f32 per-cout
    hi: Optional[jax.Array] = None  # int8 per-cout, code when y >= thr
    lo: Optional[jax.Array] = None  # int8 per-cout, code when y <  thr
    # real epilogue (last stage): z = y*scale + bias  (BN+α folded)
    scale: Optional[jax.Array] = None
    bias: Optional[jax.Array] = None
    # static
    in_codes: bool = _static(True)
    pool: bool = _static(False)
    strides: Tuple[int, int] = _static((1, 1))
    padding: str = _static("SAME")
    dense: bool = _static(False)


@_pytree_dataclass
class FusedHead:
    w: jax.Array  # (features_in, classes) — ±1 codes or fp kernel
    alpha: Optional[jax.Array] = None  # xnor per-class scale
    bias: Optional[jax.Array] = None


@_pytree_dataclass
class FusedChain:
    stages: Tuple[FusedStage, ...]
    head: FusedHead


_DN = ("NHWC", "HWIO", "NHWC")
# Real-valued (stem, projection, head) products: exact f32 when the export
# keeps them in f32 (on the GPU, default precision would round to TF32);
# no effect on bf16 operands.
_HI = jax.lax.Precision.HIGHEST


def _bn_affine(params, stats, eps=1e-5):
    gamma = params["scale"].astype(jnp.float32)
    beta = params["bias"].astype(jnp.float32)
    mean = stats["mean"].astype(jnp.float32)
    s = jnp.sqrt(stats["var"].astype(jnp.float32) + eps)
    return gamma, beta, mean, s


def _binarize_epilogue(gamma, beta, mean, s, alpha):
    """(thr, hi, lo) for code = sign(BN(α·y)) as a threshold on raw y."""
    safe_g = jnp.where(gamma == 0, 1.0, gamma)
    safe_a = jnp.where(alpha == 0, 1.0, alpha)
    t = (mean - beta * s / safe_g) / safe_a
    sign_b = jnp.where(beta >= 0, 1, -1).astype(jnp.int8)
    hi = jnp.where(gamma > 0, 1, jnp.where(gamma < 0, -1, sign_b)).astype(jnp.int8)
    lo = jnp.where(gamma > 0, -1, jnp.where(gamma < 0, 1, sign_b)).astype(jnp.int8)
    # γ==0: code is constant sign(β); force the threshold comparison moot
    t = jnp.where(gamma == 0, -jnp.inf, t)
    # α==0 (dead all-zero kernel channel): the effective binarized weight is
    # α·sign(k) = 0, so the BN input is the constant 0 and the code is the
    # constant sign(β − γμ/s) — but the ±1 code plane w is all +1 there, so
    # the accumulator y is NOT zero. Force the constant code explicitly.
    const_code = jnp.where(beta - gamma * mean / s >= 0, 1, -1).astype(jnp.int8)
    hi = jnp.where(alpha == 0, const_code, hi)
    lo = jnp.where(alpha == 0, const_code, lo)
    t = jnp.where(alpha == 0, -jnp.inf, t)
    return t.astype(jnp.float32), hi, lo


def export_fused_chain(model, variables, *, first_dtype=jnp.bfloat16) -> FusedChain:
    """Build a :class:`FusedChain` from a trained ``XNORConvNet``.

    Requires ``quantized=True, binarize_inputs=True,
    use_input_scale_map=False`` (see module docstring). ``first_dtype``:
    compute dtype for the first (real-input) conv — ``bfloat16`` to serve,
    pass ``float32`` for bit-level parity testing on CPU.
    """
    if not (model.quantized and model.binarize_inputs):
        raise ValueError("fused chain needs quantized=True, binarize_inputs=True")
    if model.use_input_scale_map:
        raise ValueError(
            "fused chain needs use_input_scale_map=False (K depends on real "
            "input magnitudes the int8 code chain never materializes)"
        )
    params = variables["params"]
    stats = variables["batch_stats"]
    n = len(model.widths)
    stages = []
    for i in range(n):
        fp_first = model.fp32_first_last and i == 0
        if fp_first:
            kernel = params[f"conv{i}"]["kernel"].astype(jnp.float32)
            w = kernel.astype(first_dtype)
            alpha = jnp.ones((kernel.shape[-1],), jnp.float32)
        else:
            kernel = params[f"conv{i}"]["conv"]["kernel"].astype(jnp.float32)
            alpha = jnp.mean(jnp.abs(kernel), axis=(0, 1, 2))
            codes = jnp.where(kernel >= 0, 1, -1).astype(jnp.int8)
            w = codes if i > 0 else codes.astype(first_dtype)
        gamma, beta, mean, s = _bn_affine(params[f"bn{i}"], stats[f"bn{i}"])
        last = i == n - 1
        if last:
            # real epilogue: z = γ(αy − μ)/s + β = (γα/s)·y + (β − γμ/s)
            st = FusedStage(
                w=w,
                scale=(gamma * alpha / s).astype(jnp.float32),
                bias=(beta - gamma * mean / s).astype(jnp.float32),
                in_codes=i > 0,
                pool=i % 2 == 1,
            )
        else:
            thr, hi, lo = _binarize_epilogue(gamma, beta, mean, s, alpha)
            st = FusedStage(
                w=w, thr=thr, hi=hi, lo=lo, in_codes=i > 0, pool=i % 2 == 1
            )
        stages.append(st)
    if model.fp32_first_last:
        hp = params["head"]
        head = FusedHead(
            w=hp["kernel"].astype(jnp.float32), bias=hp.get("bias")
        )
    else:
        hp = params["head"]["dense"]
        k = hp["kernel"].astype(jnp.float32)
        head = FusedHead(
            w=jnp.where(k >= 0, 1.0, -1.0).astype(jnp.float32),
            alpha=jnp.mean(jnp.abs(k), axis=0),
            bias=hp.get("bias"),
        )
    return FusedChain(stages=tuple(stages), head=head)


def _max_pool(x):
    init = (
        jnp.array(np.iinfo(np.int8).min, x.dtype)
        if jnp.issubdtype(x.dtype, jnp.integer)
        else jnp.array(-jnp.inf, x.dtype)
    )
    return jax.lax.reduce_window(
        x, init, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID"
    )


def export_fused_lenet(model, variables, *, first_dtype=jnp.bfloat16) -> FusedChain:
    """Build a :class:`FusedChain` from a trained ``BNNLeNet`` (BASELINE
    config 2: W1A1, VALID-padding 5x5 convs + binary dense trunk).

    Same per-channel threshold fold as the XNOR chain — the BNN layer
    order is conv/dense → BN → [pool] → sign-binarize(next input), so
    every hidden boundary collapses into hi/lo codes on the raw
    accumulator; the conv→dense seam just flattens the int8 code maps.
    Requires ``quantized=True`` (deterministic binarization).
    """
    if not model.quantized:
        raise ValueError("fused lenet needs quantized=True")
    params = variables["params"]
    stats = variables["batch_stats"]

    def sign_codes(kernel):
        return jnp.where(kernel >= 0, 1, -1).astype(jnp.int8)

    def thr_stage(w, bn_p, bn_s, **kw):
        gamma, beta, mean, s = _bn_affine(bn_p, bn_s)
        ones = jnp.ones((w.shape[-1],), jnp.float32)
        thr, hi, lo = _binarize_epilogue(gamma, beta, mean, s, ones)
        return FusedStage(w=w, thr=thr, hi=hi, lo=lo, **kw)

    w = model.width
    del w
    stages = (
        # conv1: real pixels in, ±1 weights in fp compute; bn1 folds into
        # the codes epilogue; pool runs on the int8 codes
        thr_stage(
            sign_codes(params["conv1"]["conv"]["kernel"]).astype(first_dtype),
            params["bn1"], stats["bn1"],
            in_codes=False, pool=True, padding="VALID",
        ),
        # conv2: int8 x int8 -> int32, bn2 fold, pool on codes
        thr_stage(
            sign_codes(params["conv2"]["conv"]["kernel"]),
            params["bn2"], stats["bn2"],
            in_codes=True, pool=True, padding="VALID",
        ),
        # fc1: int8 dense on the flattened codes, bn3 fold
        thr_stage(
            sign_codes(params["fc1"]["dense"]["kernel"]),
            params["bn3"], stats["bn3"],
            in_codes=True, dense=True,
        ),
    )
    head = FusedHead(
        w=jnp.where(
            params["head"]["dense"]["kernel"] >= 0, 1.0, -1.0
        ).astype(jnp.float32),
    )
    return FusedChain(stages=stages, head=head)


# --- DoReFa ResNet-20 fused chain ------------------------------------------
#
# The same boundary-folding idea for k-bit DoReFa (BASELINE config 4):
# each conv consumes a_bits-level codes c ∈ [0, n_a] (the model quantizes
# conv INPUTS; the residual stream stays full-precision — models/resnet.py
# r4 note), and the conv1→conv2 boundary collapses to one per-channel
# affine + round + clip on the raw int32 conv accumulator:
#
#   aq   = round(clip(relu(BN(y/(n_w·n_a))), 0, 1) · n_a) / n_a
#   code = clip(round(a_c·y + b_c), 0, n_a)          (a, b fold BN, scales, n_a)
#
# (relu + the [0,1] clip fold into the final [0, n_a] clip; round is
# monotone, so round∘clip == clip∘round on the grid.) Unlike the binary
# threshold case no monotonicity trick is needed — the affine is computed
# directly, so negative-γ BN channels need no special handling. The real
# residual stream materializes once per block (junction relu), and the next
# block's input codes are one fused round/clip pass over it.


@_pytree_dataclass
class FusedResBlock:
    w1: jax.Array  # int8 centered codes (2c - n_w), HWIO
    a1: jax.Array  # codes epilogue: code = clip(round(a1*y + b1), 0, n_a)
    b1: jax.Array
    w2: jax.Array  # int8 centered codes, HWIO
    a2: jax.Array  # real epilogue: y_real = a2*y + b2
    b2: jax.Array
    wp: Optional[jax.Array] = None  # fp 1x1 proj kernel (runs on the real stream)
    ap: Optional[jax.Array] = None  # proj BN affine
    bp: Optional[jax.Array] = None
    strides: Tuple[int, int] = _static((1, 1))


@_pytree_dataclass
class FusedResNet:
    stem_w: jax.Array  # fp HWIO
    stem_a: jax.Array  # stem BN affine (real stream: r = relu(a*y + b))
    stem_b: jax.Array
    blocks: Tuple[FusedResBlock, ...]
    head_w: jax.Array
    head_b: jax.Array
    n_a: int = _static(15)


def export_fused_resnet20(model, variables, *, first_dtype=jnp.bfloat16):
    """Build a :class:`FusedResNet` from a trained ``DorefaResNet20``.

    Requires ``quantized=True`` and ``a_bits >= 1``. ``first_dtype``: compute
    dtype for the fp stem/proj convs (bf16 to serve; f32 for parity tests).
    """
    from pytorch_quantize_impls_tpu.ops.dorefa import dorefa_weight

    if not (model.quantized and model.a_bits):
        raise ValueError("fused resnet needs quantized=True and a_bits >= 1")
    params = variables["params"]
    stats = variables["batch_stats"]
    n_w = 2 ** model.w_bits - 1
    n_a = 2 ** model.a_bits - 1
    inv_wa = 1.0 / (n_w * n_a)

    def centered_codes(kernel):
        wq = dorefa_weight(kernel.astype(jnp.float32), model.w_bits)
        return jnp.round(wq * n_w).astype(jnp.int8)  # 2c - n_w, exact

    def bn(name_p, name_s):
        return _bn_affine(params[name_p], stats[name_s])

    g, b, mu, s = bn("bn_stem", "bn_stem")
    stem_a = g / s
    stem_b = b - g * mu / s
    blocks = []
    for stage, (f, s0) in enumerate([(1, 1), (2, 2), (4, 2)]):
        for bi in range(3):
            name = f"stage{stage}_block{bi}"
            bp_ = params[name]
            bs_ = stats[name]
            stride = s0 if bi == 0 else 1
            g1, b1_, m1, s1 = _bn_affine(bp_["bn1"], bs_["bn1"])
            g2, b2_, m2, s2 = _bn_affine(bp_["bn2"], bs_["bn2"])
            w1 = centered_codes(bp_["conv1"]["conv"]["kernel"])
            w2 = centered_codes(bp_["conv2"]["conv"]["kernel"])
            # conv1 epilogue -> codes: a = γ/(s·n_w·n_a)·n_a, b = (β−γμ/s)·n_a
            a1 = (g1 / s1) * inv_wa * n_a
            b1v = (b1_ - g1 * m1 / s1) * n_a
            # conv2 epilogue -> real: y_real = BN2(y/(n_w·n_a))
            a2 = (g2 / s2) * inv_wa
            b2v = b2_ - g2 * m2 / s2
            wp = ap = bpv = None
            if "proj" in bp_:
                gp, bpb, mp, sp = _bn_affine(bp_["bn_proj"], bs_["bn_proj"])
                # proj consumes the full-precision residual stream directly
                wp = bp_["proj"]["kernel"].astype(first_dtype)
                ap = gp / sp
                bpv = bpb - gp * mp / sp
            blocks.append(
                FusedResBlock(
                    w1=w1, a1=a1, b1=b1v, w2=w2, a2=a2, b2=b2v,
                    wp=wp, ap=ap, bp=bpv, strides=(stride, stride),
                )
            )
    return FusedResNet(
        stem_w=params["stem"]["kernel"].astype(first_dtype),
        stem_a=stem_a, stem_b=stem_b,
        blocks=tuple(blocks),
        head_w=params["head"]["kernel"].astype(jnp.float32),
        head_b=params["head"]["bias"].astype(jnp.float32),
        n_a=n_a,
    )


def _quant_codes(h, n_a):
    return jnp.clip(jnp.round(h), 0, n_a).astype(jnp.int8)


def fused_resnet_apply(net: FusedResNet, x: jax.Array) -> jax.Array:
    """Forward through the fused DoReFa ResNet. ``x``: NHWC real images.

    Carries two streams: the fp residual ``r`` (one map per block) and the
    int8 input codes ``c = clip(round(n_a·r), 0, n_a)`` the quantized convs
    consume (r ≥ 0 post-relu, so the [0,1] clip is the [0, n_a] clip)."""
    n_a = float(net.n_a)
    y = jax.lax.conv_general_dilated(
        x.astype(net.stem_w.dtype), net.stem_w, (1, 1), "SAME",
        dimension_numbers=_DN, preferred_element_type=jnp.float32,
        precision=_HI,
    )
    r = jax.nn.relu(y * net.stem_a + net.stem_b)
    c = _quant_codes(r * n_a, net.n_a)
    for blk in net.blocks:
        y1 = int8_conv(c, blk.w1, blk.strides, "SAME")
        c1 = _quant_codes(y1 * blk.a1 + blk.b1, net.n_a)
        y2 = int8_conv(c1, blk.w2, (1, 1), "SAME")
        y2r = y2 * blk.a2 + blk.b2
        if blk.wp is not None:
            pr = jax.lax.conv_general_dilated(
                r.astype(blk.wp.dtype), blk.wp, blk.strides, "SAME",
                dimension_numbers=_DN, preferred_element_type=jnp.float32,
                precision=_HI,
            )
            resr = pr * blk.ap + blk.bp
        else:
            resr = r
        r = jax.nn.relu(y2r + resr)
        c = _quant_codes(r * n_a, net.n_a)
    pooled = jnp.mean(r, axis=(1, 2))
    return jnp.dot(pooled, net.head_w, precision=_HI) + net.head_b


def fused_apply(chain: FusedChain, x: jax.Array) -> jax.Array:
    """Forward through the fused chain. ``x``: NHWC real images."""
    h = x
    for st in chain.stages:
        if st.dense:
            if h.ndim > 2:  # conv part -> dense part: flatten the codes
                h = h.reshape(h.shape[0], -1)
            if st.in_codes:
                y = jnp.dot(
                    h, st.w, preferred_element_type=jnp.int32
                ).astype(jnp.float32)
            else:
                y = jnp.dot(
                    h.astype(st.w.dtype), st.w,
                    preferred_element_type=jnp.float32, precision=_HI,
                )
        elif st.in_codes:
            y = int8_conv(h, st.w, st.strides, st.padding)
        else:
            y = jax.lax.conv_general_dilated(
                h.astype(st.w.dtype), st.w, st.strides, st.padding,
                dimension_numbers=_DN, preferred_element_type=jnp.float32,
                precision=_HI,
            )
        if st.thr is not None:
            h = jnp.where(y >= st.thr, st.hi, st.lo)  # int8 codes out
        else:
            h = y * st.scale + st.bias
        if st.pool:
            h = _max_pool(h)
    if h.ndim > 2:
        h = h.reshape(h.shape[0], -1)
    h = h.astype(jnp.float32)
    y = jnp.dot(h, chain.head.w, preferred_element_type=jnp.float32,
                precision=_HI)
    if chain.head.alpha is not None:
        y = y * chain.head.alpha
    if chain.head.bias is not None:
        y = y + chain.head.bias
    return y
