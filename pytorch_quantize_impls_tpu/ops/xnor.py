"""XNOR-Net scaling math.

Reference: computed inline in the reference's XNOR layers
(``QuantTorch/layers/xnor_layers.py`` — SURVEY.md §2-L0 "XNOR scaling math",
§3.4). Paper: XNOR-Net (arXiv:1603.05279):

* per-output-channel scale ``α_c = mean(|W_c|)`` (L1 norm / n), so
  ``W ≈ α_c · sign(W)``;
* optional input-side scale map ``K = conv(mean_c |I|, avg-kernel)`` for the
  "full XNOR" mode (binarized inputs).

Gradient note (SURVEY.md §3.4): α must stay differentiable w.r.t. W through
``|·|`` and ``mean`` — we therefore express ``xnor_quantize`` as the plain
composition ``α(W) * sign_ste(W)`` and let autodiff produce the paper's
gradient (1/n + α·STE term). Only the sign carries an STE.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu.ops.common import Array, safe_sign, ste, clip_mask


#: Sign binarization with the clipped STE (``g·1[|w|≤1]``). Public: the XNOR
#: layers use this for ``weight_quant`` so master kernels receive gradient
#: *through* the binarization (not just via α's mean(|w|) path, which is
#: parallel to sign(w) and can never flip a weight's sign).
sign_ste_clip = ste(safe_sign, clip_mask(1.0))
_sign_ste_clip = sign_ste_clip  # backward-compat internal alias


def xnor_alpha(w: Array, channel_axis: int = -1) -> Array:
    """Per-output-channel L1 scale ``α_c = mean over non-channel dims |W|``."""
    axes = tuple(i for i in range(w.ndim) if i != (channel_axis % w.ndim))
    return jnp.mean(jnp.abs(w), axis=axes, keepdims=True)


def xnor_quantize(w: Array, channel_axis: int = -1) -> Array:
    """``α_c · sign(W)`` with clipped STE on the sign, differentiable α."""
    return xnor_alpha(w, channel_axis) * _sign_ste_clip(w)


def xnor_input_scale_map(
    x: Array, kernel_size: Sequence[int], *, channel_axis: int = -1
) -> Array:
    """Input scale map ``K`` for full-XNOR conv (paper §3.2, survey §3.4).

    ``A = mean over channels |I|``; ``K = A * avg_pool-style conv with the
    all-ones/khkw kernel`` at stride 1, SAME padding. ``x`` is NHWC
    (channels-last layout); returns shape ``(N, H, W, 1)``.
    """
    a = jnp.mean(jnp.abs(x), axis=channel_axis, keepdims=True)
    kh, kw = kernel_size
    kern = jnp.full((kh, kw, 1, 1), 1.0 / (kh * kw), dtype=a.dtype)
    return jax.lax.conv_general_dilated(
        a,
        kern,
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST,
    )
