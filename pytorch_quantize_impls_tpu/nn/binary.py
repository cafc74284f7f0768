"""BinaryConnect / BNN layers (reference: ``QuantTorch/layers/binary_layers.py``
— SURVEY.md §2-L1 "Binary layers").

``LinearBin(features, deterministic=...)`` / ``BinConv(...)``: binarize the
fp32 master kernel per forward; "full BNN" mode (``binarize_input=True``)
additionally sign-binarizes the incoming activation with hard-tanh STE
(arXiv:1602.02830). ``ShiftNormBatch`` is the BNN paper's shift-based batch
norm approximated with power-of-2 scales.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Optional, Sequence, Tuple, Union

import flax.linen as nn
import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu import ops
from pytorch_quantize_impls_tpu.nn.base import QuantConv, QuantDense, stochastic


def _binary_weight_quant(deterministic: bool, ste_mode: str):
    if deterministic:
        return partial(ops.binary_connect_det, ste_mode=ste_mode)
    # Test-time rule for stochastic binarization (BinaryConnect §2.4): use
    # the real-valued master weights — E[W_b] = 2*hard_sigmoid(w)-1 = w, so
    # the clipped master IS the ensemble-average network. Evaluating with
    # sign(w) instead is a different net and collapses accuracy (~25% on
    # digits vs ~99%).
    return stochastic(
        partial(ops.binary_connect_stoch, ste_mode=ste_mode),
        eval_fn=lambda w: jnp.clip(w, -1.0, 1.0),
    )


def _input_binarizer(mod: nn.Module, x, act_scale: bool):
    """``binary_tanh`` input quantizer, optionally followed by a LEARNABLE
    per-input-channel scale g (init 1) — magnitude restoration for the
    binarized activation (the XNOR-K idea, made a trained parameter instead
    of a computed map). A learnable pre-sign threshold (ReActNet RSign) is
    deliberately NOT added: every binarization in the BNN models sits after a
    BatchNorm whose per-channel bias already parameterizes the threshold
    (max-pool between them commutes with the monotone affine). The scale is
    deployment-free: g is per-INPUT-channel, so ``conv(g*sign(x), Wb) ==
    conv(sign(x), g*Wb)`` — it folds into the kernel (or the previous
    boundary's threshold epilogue) at export."""
    if not act_scale:
        return ops.binary_tanh
    g = mod.param("act_scale", nn.initializers.ones_init(), (x.shape[-1],))

    def quant(v):
        return ops.binary_tanh(v) * g.astype(v.dtype)

    return quant


class LinearBin(nn.Module):
    """Binary-weight dense layer. ``deterministic=False`` -> stochastic
    binarization (needs ``rngs={'quant': key}`` at apply time)."""

    features: int
    deterministic: bool = True
    binarize_input: bool = False  # full-BNN mode
    act_scale: bool = False  # learnable per-channel scale on the binarized input
    ste_mode: str = "clip"
    use_bias: bool = True
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(self, x, train: bool = True):
        return QuantDense(
            features=self.features,
            weight_quant=_binary_weight_quant(self.deterministic, self.ste_mode),
            input_quant=(
                _input_binarizer(self, x, self.act_scale)
                if self.binarize_input
                else None
            ),
            use_bias=self.use_bias,
            dtype=self.dtype,
            scheme="binary",
            a_bits=1 if self.binarize_input else 0,
            name="dense",
        )(x, train=train)


class BinConv(nn.Module):
    """Binary-weight conv layer (NHWC)."""

    features: int
    kernel_size: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (1, 1)
    padding: Union[str, Sequence[Tuple[int, int]]] = "SAME"
    deterministic: bool = True
    binarize_input: bool = False
    act_scale: bool = False
    ste_mode: str = "clip"
    use_bias: bool = True
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(self, x, train: bool = True):
        return QuantConv(
            features=self.features,
            kernel_size=self.kernel_size,
            strides=self.strides,
            padding=self.padding,
            weight_quant=_binary_weight_quant(self.deterministic, self.ste_mode),
            input_quant=(
                _input_binarizer(self, x, self.act_scale)
                if self.binarize_input
                else None
            ),
            use_bias=self.use_bias,
            dtype=self.dtype,
            scheme="binary",
            a_bits=1 if self.binarize_input else 0,
            name="conv",
        )(x, train=train)


class ShiftNormBatch(nn.Module):
    """Batch norm whose scale is rounded to a power of 2 (BNN paper §2.3
    "shift-based batch normalization") so inference multiplies become shifts.

    Running statistics live in the ``'batch_stats'`` collection, matching
    ``flax.linen.BatchNorm`` conventions.
    """

    momentum: float = 0.9
    epsilon: float = 1e-5

    @nn.compact
    def __call__(self, x, train: bool = True):
        ra_mean = self.variable(
            "batch_stats", "mean", lambda: jnp.zeros(x.shape[-1], jnp.float32)
        )
        ra_var = self.variable(
            "batch_stats", "var", lambda: jnp.ones(x.shape[-1], jnp.float32)
        )
        gamma = self.param("scale", nn.initializers.ones_init(), (x.shape[-1],))
        beta = self.param("bias", nn.initializers.zeros_init(), (x.shape[-1],))
        if train:
            axes = tuple(range(x.ndim - 1))
            mean = jnp.mean(x, axis=axes)
            var = jnp.var(x, axis=axes)
            if not self.is_initializing():
                ra_mean.value = self.momentum * ra_mean.value + (1 - self.momentum) * mean
                ra_var.value = self.momentum * ra_var.value + (1 - self.momentum) * var
        else:
            mean, var = ra_mean.value, ra_var.value
        # AP2: approximate scale by nearest power of 2, identity STE.
        scale = gamma * jax.lax.rsqrt(var + self.epsilon)
        return (x - mean) * _ap2_ste(scale) + beta


def _ap2(x):
    mag = jnp.abs(x)
    e = jnp.round(jnp.log2(jnp.where(mag == 0, 1e-30, mag)))
    return jnp.sign(x) * jnp.exp2(e)


@jax.custom_vjp
def _ap2_ste(x):
    return _ap2(x)


_ap2_ste.defvjp(lambda x: (_ap2(x), None), lambda _, g: (g,))
