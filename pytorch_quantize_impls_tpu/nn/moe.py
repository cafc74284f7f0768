"""Quantized Mixture-of-Experts with top-1 (switch) routing — NEW scope
extension for expert parallelism (EP); the reference has no MoE and no
parallelism at all (SURVEY.md §2 "Parallelism & communication — NONE").

Design: routing is realized with dense one-hot dispatch/combine einsums
(the Switch-Transformer/flaxformer pattern) so everything is static-shape
matmul work — no gather/scatter, no data-dependent control flow under
jit. Expert FFN kernels are stacked on a leading ``n_experts`` axis, so EP
is just a NamedSharding ``P("expert")`` (or the "model" axis) on that axis:
GSPMD turns the dispatch/combine einsums into all-to-alls between devices.

The expert FFNs are *quantized*: each expert's two kernels go through a
scheme quantizer (binary/ternary/dorefa/log/lin — anything in
``ops.registry``) with fp32 masters, STE backward, and the usual
clamp-after-step domain, so MoE composes with the whole quantizer zoo.

Load-balancing: the switch aux loss ``E * sum_e f_e * p_e`` is sown into
the ``'losses'`` collection (same contract as the elastic penalties —
``nn.collect_elastic_losses`` picks it up).
"""

from __future__ import annotations

from typing import Any, Optional

import flax.linen as nn
import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu import ops
from pytorch_quantize_impls_tpu.nn.base import _apply_quant


class QuantMoE(nn.Module):
    """Top-1-routed FFN over ``n_experts`` quantized experts.

    Input (..., d_model) -> output (..., d_model). ``capacity_factor``
    bounds tokens per expert at ``ceil(T / E) * capacity_factor``; overflow
    tokens pass through on the residual path (standard switch behavior).

    ``scheme``/knobs configure the expert-kernel quantizer via
    ``ops.get_quantizer``; the router stays full-precision (its FLOPs are
    negligible and routing is precision-sensitive).
    """

    n_experts: int
    d_ff: int
    scheme: str = "binary"
    w_bits: int = 1
    fsr: float = 0.0
    capacity_factor: float = 2.0
    aux_loss_weight: float = 1.0
    dtype: Optional[Any] = None
    param_dtype: Any = jnp.float32

    def _quantizer(self):
        if self.scheme in ("binary", "xnor"):
            return ops.get_quantizer("binary")
        if self.scheme == "ternary":
            return ops.get_quantizer("ternary")
        if self.scheme == "dorefa":
            return ops.get_quantizer("dorefa_weight", bits=self.w_bits)
        if self.scheme == "log":
            return ops.get_quantizer("log", fsr=self.fsr, bits=self.w_bits)
        if self.scheme == "lin":
            return ops.get_quantizer("lin", fsr=self.fsr, bits=self.w_bits)
        if self.scheme == "none":
            return None
        raise ValueError(f"unknown MoE expert scheme {self.scheme!r}")

    @nn.compact
    def __call__(self, x, train: bool = True):
        *lead, d_model = x.shape
        t = 1
        for s in lead:
            t *= s
        xf = x.reshape(t, d_model)
        e = self.n_experts
        cap = int(-(-t // e) * self.capacity_factor)
        cap = max(min(cap, t), 1)

        # --- router (fp32) ---
        router = self.param(
            "router", nn.initializers.glorot_normal(), (d_model, e), jnp.float32
        )
        logits = xf.astype(jnp.float32) @ router
        probs = jax.nn.softmax(logits, axis=-1)  # (T, E)
        gate = jnp.max(probs, axis=-1)  # (T,)
        expert = jnp.argmax(probs, axis=-1)  # (T,)
        onehot = jax.nn.one_hot(expert, e, dtype=jnp.float32)  # (T, E)

        # switch aux load-balancing loss: E * sum_e fraction_e * prob_e
        frac = jnp.mean(onehot, axis=0)
        pmean = jnp.mean(probs, axis=0)
        self.sow(
            "losses", "moe_aux", self.aux_loss_weight * e * jnp.sum(frac * pmean)
        )

        # --- capacity + dispatch/combine tensors (static shapes) ---
        pos = jnp.cumsum(onehot, axis=0) * onehot  # 1-based slot per token
        keep = (pos <= cap) & (onehot > 0)  # (T, E)
        slot = jax.nn.one_hot(
            (pos - 1.0).astype(jnp.int32), cap, dtype=jnp.float32
        )  # (T, E, C)
        dispatch = slot * keep[..., None].astype(jnp.float32)  # (T, E, C)
        combine = dispatch * gate[:, None, None]  # (T, E, C)

        cdt = self.dtype or x.dtype
        xin = jnp.einsum(
            "tec,td->ecd", dispatch.astype(cdt), xf.astype(cdt)
        )  # (E, C, D)

        # --- quantized expert FFNs (stacked kernels; EP shards axis 0) ---
        wi = self.param(
            "wi_kernel",
            nn.initializers.glorot_normal(batch_axis=(0,)),
            (e, d_model, self.d_ff),
            self.param_dtype,
        )
        wo = self.param(
            "wo_kernel",
            nn.initializers.glorot_normal(batch_axis=(0,)),
            (e, self.d_ff, d_model),
            self.param_dtype,
        )
        q = self._quantizer()
        wi_q = _apply_quant(q, wi, self, train)
        wo_q = _apply_quant(q, wo, self, train)
        h = jnp.einsum("ecd,edf->ecf", xin, wi_q.astype(cdt))
        h = jax.nn.relu(h)
        hout = jnp.einsum("ecf,efd->ecd", h, wo_q.astype(cdt))

        out = jnp.einsum(
            "tec,ecd->td", combine.astype(cdt), hout
        )  # dropped tokens -> 0 (residual passthrough is the caller's add)
        return out.reshape(*lead, d_model)


def expert_sharding_rules(params_path: str) -> bool:
    """True if this param path is an expert-stacked kernel (leading axis =
    expert) — shard that axis over the EP mesh axis. The ``_kernel`` suffix
    also keeps them inside the default clamp-after-step filter."""
    return params_path.endswith("wi_kernel") or params_path.endswith("wo_kernel")
