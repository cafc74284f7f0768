"""int8 x int8 -> int32 GEMM with a fused scale epilogue.

The plain XLA form: on the GPU, XLA hands an int8 dot with an int32 result
to an int8 tensor-core GEMM (cuBLASLt or its own GEMM emitter), and the
scale epilogue fuses into the consumer. Used by the decoded serving modes
(``*_gemm_decoded``) and by the int8-resident fused decode step.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu.kernels import common


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def int8_gemm(
    x_i8: jax.Array,
    w_i8: jax.Array,
    alpha: Optional[jax.Array] = None,
    row_scale: Optional[jax.Array] = None,
    *,
    out_dtype=jnp.float32,
):
    """(M,K) int8 @ (K,N) int8 -> (M,N) out_dtype, int32 accumulate.

    ``alpha``: (N,) per-out-channel f32 scale; ``row_scale``: (M,) per-row
    f32 scale — both applied to the exact int32 sums.
    """
    assert x_i8.shape[1] == w_i8.shape[0], (x_i8.shape, w_i8.shape)
    acc = jax.lax.dot_general(
        x_i8, w_i8, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )
    return common.scale_epilogue(acc, alpha, row_scale, out_dtype)


def int8_gemm_reference(x_i8, w_i8, alpha=None, row_scale=None):
    """Independent int32 twin (parity tests)."""
    out = (x_i8.astype(jnp.int32) @ w_i8.astype(jnp.int32)).astype(jnp.float32)
    if alpha is not None:
        out = out * alpha.reshape(1, -1)
    if row_scale is not None:
        out = out * row_scale.reshape(-1, 1)
    return out
