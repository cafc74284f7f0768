"""Shared kernel utilities: platform dispatch and padding."""

from __future__ import annotations

import jax
import jax.numpy as jnp

SUPPORTED_PLATFORMS = ("cpu", "gpu")


def platform() -> str:
    """The backend the wrappers dispatch on: ``"gpu"`` runs the compiled
    kernels (where they won), ``"cpu"`` the plain XLA forms. Any other
    backend raises: there is no kernel or tuning for it."""
    p = jax.default_backend()
    if p not in SUPPORTED_PLATFORMS:
        raise NotImplementedError(
            f"platform {p!r} is not supported (expected one of "
            f"{SUPPORTED_PLATFORMS})"
        )
    return p


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def scale_epilogue(acc, alpha=None, row_scale=None, out_dtype=jnp.float32):
    """int32 accumulator -> out_dtype, times the optional per-column
    ``alpha`` (N,) and per-row ``row_scale`` (M,)."""
    out = acc.astype(jnp.float32)
    if alpha is not None:
        out = out * alpha.astype(jnp.float32).reshape(1, -1)
    if row_scale is not None:
        out = out * row_scale.astype(jnp.float32).reshape(-1, 1)
    return out.astype(out_dtype)


def pad_dim(x, axis: int, to: int):
    """Zero-pad ``axis`` of x up to length ``to``."""
    n = x.shape[axis]
    if n == to:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, to - n)
    return jnp.pad(x, pads)
