"""Single-token decode attention over the int8-quantized KV cache.

The serving decode step reads the whole KV cache every token; at batch >= 8
that is the step's dominant traffic (8 layers x 2 x b x 1 MB at cl 1024 for
the serving LM). Reading the int8 codes once, with the per-(position, head)
dequant scales folded into the score and attention vectors
(``q·(c·s) == (q·c)·s``), means a dequantized copy of the cache never
exists:

    scores = (k_codes · q) * k_scale * rsqrt(hd) + bias
    ctx    = softmax(scores) * v_scale · v_codes

:func:`decode_attention` picks one of two forms from what it can observe:

* **GPU** (``hd`` a power of two, ``cl`` a multiple of 16): a split-cache
  (flash-decoding) Pallas kernel on the Triton route. The grid is
  ``(b, h, n_split)``; each program streams ``cl / n_split`` cache rows in
  blocks of ``BLOCK_L`` with an online softmax and writes an unnormalised
  context plus its running max and sum; a plain-jnp pass combines the
  splits. The splits put enough programs in flight to fill the card at
  small batch. Both products are float32 multiply-adds on the CUDA cores
  (no tensor-core dot, so no TF32 rounding): the matvecs are bound by the
  cache bytes, not by arithmetic.
* **otherwise, and on the CPU**: the plain form, the same folding in
  ``jnp.einsum`` at ``Precision.HIGHEST``.

The mask is an additive f32 bias row per slot (0 valid / -1e30 invalid),
computed outside from the per-slot cursors — decode queries at position p
attend cache positions <= p (models/transformer.py cursor-causal rule).
Every row must hold at least one valid position. The score scale is the
correctly rounded constant ``hd**-0.5`` in every form (a device ``rsqrt``
may be approximate): scores reach ~1e3 in the binary LM, where one ulp of
scale can reorder a near tie between two keys.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from pytorch_quantize_impls_tpu.kernels import common

_MAX_BLOCK_L = 64
_TARGET_PROGRAMS = 264  # two waves on an H100 (132 SMs)


def _block_l(cl: int) -> int:
    return next(b for b in (_MAX_BLOCK_L, 32, 16) if cl % b == 0)


def kernel_eligible(cl: int, hd: int) -> bool:
    """Shapes the Triton kernel takes: power-of-two head dim, cl % 16 == 0."""
    return cl % 16 == 0 and hd & (hd - 1) == 0


def use_kernel(cl: int, hd: int) -> bool:
    """Whether :func:`decode_attention` runs the Triton kernel."""
    return common.platform() == "gpu" and kernel_eligible(cl, hd)


def n_splits(b: int, h: int, cl: int) -> int:
    """Cache splits: double until ``b*h*splits`` fills the card or a split
    would be shorter than one block."""
    bl = _block_l(cl)
    s = 1
    while b * h * s < _TARGET_PROGRAMS and cl % (2 * s * bl) == 0:
        s *= 2
    return s


def _kernel(q_ref, kc_ref, ks_ref, vc_ref, vs_ref, bias_ref,
            o_ref, m_ref, l_ref, *, block_l: int, scale: float):
    """One (slot, head, split) program over ``cl / n_split`` cache rows."""
    hd = q_ref.shape[0]
    n_blocks = kc_ref.shape[0] // block_l
    q = q_ref[...].astype(jnp.float32)

    def body(t, carry):
        acc, m, l = carry
        rows = pl.ds(t * block_l, block_l)
        k = kc_ref[rows, :].astype(jnp.float32)  # (BL, hd)
        s = jnp.sum(k * q[None, :], axis=1) * ks_ref[rows] * scale
        s = s + bias_ref[rows]  # (BL,)
        m_new = jnp.maximum(m, jnp.max(s))
        corr = jnp.exp(m - m_new)
        p = jnp.exp(s - m_new)
        v = vc_ref[rows, :].astype(jnp.float32)
        pv = (p * vs_ref[rows])[:, None] * v  # v dequant folded into p
        return acc * corr + jnp.sum(pv, axis=0), m_new, l * corr + jnp.sum(p)

    init = (jnp.zeros((hd,), jnp.float32), jnp.float32(-jnp.inf),
            jnp.float32(0.0))
    acc, m, l = jax.lax.fori_loop(0, n_blocks, body, init)
    o_ref[...] = acc
    m_ref[...] = jnp.full((1,), m, jnp.float32)
    l_ref[...] = jnp.full((1,), l, jnp.float32)


def _decode_attention_triton(q, k_codes, k_scale, v_codes, v_scale, mask_bias,
                             *, splits: int, interpret: bool = False):
    b, h, hd = q.shape
    cl = k_codes.shape[2]
    ls = cl // splits
    bl = _block_l(ls)
    o, m, l = pl.pallas_call(
        functools.partial(_kernel, block_l=bl, scale=float(hd) ** -0.5),
        grid=(b, h, splits),
        in_specs=[
            pl.BlockSpec((None, None, hd), lambda i, j, s: (i, j, 0)),
            pl.BlockSpec((None, None, ls, hd), lambda i, j, s: (i, j, s, 0)),
            pl.BlockSpec((None, None, ls), lambda i, j, s: (i, j, s)),
            pl.BlockSpec((None, None, ls, hd), lambda i, j, s: (i, j, s, 0)),
            pl.BlockSpec((None, None, ls), lambda i, j, s: (i, j, s)),
            pl.BlockSpec((None, ls), lambda i, j, s: (i, s)),
        ],
        out_specs=[
            pl.BlockSpec((None, None, None, hd), lambda i, j, s: (i, j, s, 0)),
            pl.BlockSpec((None, None, 1), lambda i, j, s: (i, j, s)),
            pl.BlockSpec((None, None, 1), lambda i, j, s: (i, j, s)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b, h, splits, hd), jnp.float32),
            jax.ShapeDtypeStruct((b, h, splits), jnp.float32),
            jax.ShapeDtypeStruct((b, h, splits), jnp.float32),
        ],
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="decode_attention_split",
    )(q, k_codes, k_scale, v_codes, v_scale, mask_bias)
    # combine the splits: rescale each to the global max
    w = jnp.exp(m - jnp.max(m, axis=-1, keepdims=True))  # (b, h, S)
    num = jnp.sum(w[..., None] * o, axis=2)
    return num / jnp.sum(w * l, axis=-1)[..., None]


def decode_attention_plain(q, k_codes, k_scale, v_codes, v_scale, mask_bias):
    """Plain XLA form of :func:`decode_attention` (scales folded, f32)."""
    hi = jax.lax.Precision.HIGHEST
    hd = q.shape[-1]
    s = jnp.einsum("bhd,bhkd->bhk", q.astype(jnp.float32),
                   k_codes.astype(jnp.float32), precision=hi)
    s = s * k_scale * hd**-0.5 + mask_bias[:, None, :]
    p = jax.nn.softmax(s, axis=-1) * v_scale
    return jnp.einsum("bhk,bhkd->bhd", p, v_codes.astype(jnp.float32),
                      precision=hi)


@jax.jit
def decode_attention(
    q: jax.Array,
    k_codes: jax.Array,
    k_scale: jax.Array,
    v_codes: jax.Array,
    v_scale: jax.Array,
    mask_bias: jax.Array,
) -> jax.Array:
    """One-token attention over the quantized cache.

    Args:
      q: (b, h, hd) query for the single decode position (f32/bf16).
      k_codes/v_codes: (b, h, cl, hd) int8 cache codes (b-h-major layout —
        the fused serving cache, infer/fused_decode.py).
      k_scale/v_scale: (b, h, cl) f32 per-(position, head) dequant scales.
      mask_bias: (b, cl) f32 additive bias, 0 where the position is
        attendable and -1e30 where not.
    Returns:
      (b, h, hd) f32 attention context.
    """
    b, h, hd = q.shape
    cl = k_codes.shape[2]
    assert k_codes.shape == (b, h, cl, hd), (k_codes.shape, (b, h, cl, hd))
    assert mask_bias.shape == (b, cl), mask_bias.shape
    if use_kernel(cl, hd):
        return _decode_attention_triton(
            q, k_codes, k_scale, v_codes, v_scale, mask_bias,
            splits=n_splits(b, h, cl),
        )
    return decode_attention_plain(q, k_codes, k_scale, v_codes, v_scale, mask_bias)
