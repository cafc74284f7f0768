"""Generic quantized Dense/Conv modules (reference: ``QuantTorch/layers/common.py``
``QLayer`` mixin — SURVEY.md §2-L1).

``QuantDense`` / ``QuantConv`` hold an fp32 master ``kernel`` and apply a
weight quantizer (and optionally an input quantizer) on every forward call.
Scheme-specific layers (``LinearBin``, ``LinearDorefa``, ...) are thin
subclass-style wrappers configuring the quantizers.

The reference's ``clamp()`` (clip master weights after ``optimizer.step()``)
is a *parameter transform* here — see ``train/clipping.py`` — because JAX
optimizers are functional; per-layer clamp bounds travel in
``QuantDense.clip_bound`` metadata (collected via ``clip_bounds``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import flax.linen as nn
import jax
import jax.numpy as jnp

Array = jax.Array
Quantizer = Callable[..., Array]


def _apply_quant(q, x, mod: nn.Module, train: bool):
    """Call a quantizer, feeding it a fresh 'quant' RNG if it asks for one.

    Stochastic quantizers have signature ``(x, key)``; deterministic ones
    ``(x,)``. In eval mode stochastic quantizers fall back to their
    deterministic twin via the ``eval_fn`` attribute if present, matching the
    reference's freeze-on-eval behavior (SURVEY.md §3.5).
    """
    if q is None:
        return x
    needs_key = getattr(q, "stochastic", False)
    if needs_key:
        if train:
            return q(x, mod.make_rng("quant"))
        det = getattr(q, "eval_fn", None)
        if det is not None:
            return det(x)
        return q(x, jax.random.PRNGKey(0))
    return q(x)


def stochastic(fn: Quantizer, eval_fn: Optional[Quantizer] = None) -> Quantizer:
    """Tag a quantizer as stochastic (takes ``(x, key)``); ``eval_fn`` is the
    deterministic replacement used at eval time."""

    def wrapped(x, key):
        return fn(x, key)

    wrapped.stochastic = True
    wrapped.eval_fn = eval_fn
    return wrapped


class QuantDense(nn.Module):
    """Dense layer with quantized weights (and optionally inputs).

    Mirrors the reference hot loop (SURVEY.md §3.1): quantize the fp32 master
    kernel per call, then one matmul — which XLA fuses and runs on the tensor
    cores in bf16 for the fake-quant path.
    """

    features: int
    weight_quant: Optional[Quantizer] = None
    input_quant: Optional[Quantizer] = None
    use_bias: bool = True
    clip_bound: Optional[float] = 1.0  # clamp() domain for the master kernel
    dtype: Optional[Any] = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = nn.initializers.glorot_normal()
    bias_init: Callable = nn.initializers.zeros_init()
    # Per-out-channel scale computed from the master kernel, applied to the
    # OUTPUT (reference semantics, SURVEY.md §3.4: ``conv(Ib, Wb) * α``).
    # Scaling the output instead of folding α into the weights keeps the
    # fake-quant matmul integer-valued (exact in fp32/bf16 accumulation), so
    # it is bit-identical to the packed int8 kernels' α epilogue — folding α
    # in first accumulates fp rounding that can flip downstream sign
    # binarizations en masse (BN outputs form a value lattice; a lattice
    # point within 1e-7 of zero flips hundreds of positions at once).
    out_scale: Optional[Quantizer] = None
    # Packed-execution metadata (read by ``infer.pack_model``):
    scheme: str = "none"  # none|binary|xnor|dorefa|log|lin|ternary
    w_bits: int = 1
    a_bits: int = 0  # 0 = inputs not quantized
    fsr: float = 0.0

    @nn.compact
    def __call__(self, x: Array, train: bool = True) -> Array:
        kernel = self.param(
            "kernel", self.kernel_init, (x.shape[-1], self.features), self.param_dtype
        )
        x = _apply_quant(self.input_quant, x, self, train)
        wq = _apply_quant(self.weight_quant, kernel, self, train)
        y = jnp.dot(x.astype(self.dtype or x.dtype), wq.astype(self.dtype or wq.dtype))
        if self.out_scale is not None:
            y = y * self.out_scale(kernel).astype(y.dtype)
        if self.use_bias:
            bias = self.param("bias", self.bias_init, (self.features,), self.param_dtype)
            y = y + bias.astype(y.dtype)  # keep compute dtype (bf16 path)
        return y


class QuantConv(nn.Module):
    """2D conv (NHWC/HWIO) with quantized weights (and optionally inputs)."""

    features: int
    kernel_size: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (1, 1)
    padding: Union[str, Sequence[Tuple[int, int]]] = "SAME"
    weight_quant: Optional[Quantizer] = None
    input_quant: Optional[Quantizer] = None
    use_bias: bool = True
    clip_bound: Optional[float] = 1.0
    dtype: Optional[Any] = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = nn.initializers.glorot_normal()
    bias_init: Callable = nn.initializers.zeros_init()
    # Output α epilogue from the master kernel — see QuantDense.out_scale.
    out_scale: Optional[Quantizer] = None
    # Packed-execution metadata (read by ``infer.pack_model``):
    scheme: str = "none"
    w_bits: int = 1
    a_bits: int = 0
    fsr: float = 0.0

    @nn.compact
    def __call__(self, x: Array, train: bool = True) -> Array:
        kh, kw = self.kernel_size
        kernel = self.param(
            "kernel",
            self.kernel_init,
            (kh, kw, x.shape[-1], self.features),
            self.param_dtype,
        )
        x = _apply_quant(self.input_quant, x, self, train)
        wq = _apply_quant(self.weight_quant, kernel, self, train)
        y = jax.lax.conv_general_dilated(
            x.astype(self.dtype or x.dtype),
            wq.astype(self.dtype or wq.dtype),
            window_strides=self.strides,
            padding=self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        if self.out_scale is not None:
            y = y * self.out_scale(kernel).astype(y.dtype)
        if self.use_bias:
            bias = self.param("bias", self.bias_init, (self.features,), self.param_dtype)
            y = y + bias.astype(y.dtype)  # keep compute dtype (bf16 path)
        return y


def collect_elastic_losses(variables) -> Array:
    """Sum all penalties sown into the 'losses' collection by elastic layers."""
    losses = variables.get("losses", {})
    leaves = jax.tree_util.tree_leaves(losses)
    if not leaves:
        return jnp.zeros(())
    return sum(jnp.sum(l) for l in leaves)
