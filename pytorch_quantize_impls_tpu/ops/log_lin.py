"""Log-domain (power-of-2) and linear FSR quantization.

Reference: ``QuantTorch/functions/log_lin_connect.py`` (SURVEY.md §2-L0).
Paper: Logarithmic Data Representation (arXiv:1603.01025, Miyashita et al.).

* ``log_quant(x; fsr, bits)``:
  ``sign(x) * 2^( clip( round(log2|x|), fsr - 2^bits, fsr ) )`` — exponents
  clipped to the full-scale range; 0 maps to the smallest level.
  ``with_sign=False`` drops the sign (magnitude-only, as for post-ReLU
  activations in the paper). ``lin_back=True`` (default) uses identity STE;
  ``lin_back=False`` scales the cotangent by d(2^log2|x|)/dx ≈ y/x evaluated
  at the quantized output (survey confidence MED on the exact reference rule —
  documented behavioral choice).
* ``lin_quant(x; fsr, bits)``: uniform grid, step ``Δ = 2^(fsr - bits)``,
  ``clip(round(x/Δ)Δ, -2^fsr, 2^fsr)``; identity STE.

This is the scheme the kernels turn into a shift-based matmul: a weight
becomes (sign, exponent) and multiplication becomes an exponent add — see
``kernels/shift_matmul.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu.ops.common import Array, safe_sign


def _log_levels(fsr: float, bits: int):
    lo = fsr - float(2**bits)
    hi = float(fsr)
    return lo, hi


def _log_quant_fwd_value(x: Array, fsr: float, bits: int, with_sign: bool) -> Array:
    lo, hi = _log_levels(fsr, bits)
    mag = jnp.abs(x)
    # 0 -> smallest level: log2(0) = -inf clips to `lo`.
    e = jnp.clip(jnp.round(jnp.log2(jnp.where(mag == 0, 2.0**lo, mag))), lo, hi)
    y = jnp.exp2(e)
    if with_sign:
        y = y * safe_sign(x)
    return y.astype(x.dtype)


def log_quant(
    x: Array,
    fsr: float = 0.0,
    bits: int = 4,
    *,
    with_sign: bool = True,
    lin_back: bool = True,
) -> Array:
    """Power-of-2 quantization with STE backward (see module docstring)."""

    @jax.custom_vjp
    def q(x):
        return _log_quant_fwd_value(x, fsr, bits, with_sign)

    def q_fwd(x):
        y = _log_quant_fwd_value(x, fsr, bits, with_sign)
        return y, (x, y)

    def q_bwd(res, g):
        x, y = res
        if lin_back:
            return (g,)
        # Scale by the log-domain surrogate derivative y/x (≈1 on levels),
        # guarded at x == 0.
        denom = jnp.where(x == 0, jnp.ones_like(x), x)
        scale = jnp.where(x == 0, jnp.zeros_like(x), jnp.abs(y) / jnp.abs(denom))
        return (g * scale * safe_sign(x) * safe_sign(y) if with_sign else g * scale,)

    q.defvjp(q_fwd, q_bwd)
    return q(x)


def lin_quant(x: Array, fsr: float = 0.0, bits: int = 4) -> Array:
    """Uniform FSR-grid quantization with identity STE (module docstring)."""
    step = 2.0 ** (fsr - bits)
    bound = 2.0**fsr

    @jax.custom_vjp
    def q(x):
        return jnp.clip(jnp.round(x / step) * step, -bound, bound).astype(x.dtype)

    q.defvjp(lambda x: (q(x), None), lambda _, g: (g,))
    return q(x)


def log_quant_exponent(x: Array, fsr: float = 0.0, bits: int = 4):
    """Return (sign, exponent-index) pair for packed/shift execution.

    ``exponent_index`` is in ``[0, 2^bits]`` with level value
    ``2^(fsr - 2^bits + index)``; used by ``ops.pack`` and the shift-matmul
    kernel. Inverse: ``log_quant_from_exponent``.
    """
    lo, hi = _log_levels(fsr, bits)
    mag = jnp.abs(x)
    e = jnp.clip(jnp.round(jnp.log2(jnp.where(mag == 0, 2.0**lo, mag))), lo, hi)
    idx = (e - lo).astype(jnp.int32)
    return safe_sign(x), idx


def log_quant_from_exponent(sign: Array, idx: Array, fsr: float = 0.0, bits: int = 4):
    lo, _ = _log_levels(fsr, bits)
    return sign * jnp.exp2(idx.astype(jnp.float32) + lo)
