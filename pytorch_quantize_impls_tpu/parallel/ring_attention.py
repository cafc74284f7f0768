"""Ring attention — context parallelism (CP) over a sequence-sharded ring.

NEW scope: the reference has no attention or sequence workloads at all
(SURVEY.md §5 "Long-context / sequence parallelism — absent and
inapplicable"); this module completes the framework's parallel surface
(DP/TP/PP/SP/EP + CP) for the quantized-transformer extension.

Realization (blockwise/ring attention, Liu et al.): every device
of a mesh axis holds one contiguous sequence chunk of Q, K, V. K/V chunks
rotate around the ring with ``jax.lax.ppermute`` (one hop per step)
while each device folds the visiting chunk into a numerically-stable
*online softmax* accumulator (the flash-attention recurrence: running max
``m``, running normalizer ``l``, unnormalized output ``o``). After
``axis_size`` steps every Q position has attended to the full sequence and
no device ever materialized more than an ``(s_local x s_local)`` score
block — sequence memory scales 1/P per device. ``ppermute`` is
differentiable (its transpose is the inverse rotation), so the same code
path serves training.

Causal masking is block-aware: a visiting K/V chunk strictly *before* the
local Q chunk attends fully, the diagonal chunk applies the in-block
triangular mask, and chunks *after* are fully masked (their contribution
underflows to zero in the online-softmax fold).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pytorch_quantize_impls_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

NEG = jnp.float32(-1e30)  # finite -inf: keeps m/l arithmetic NaN-free


def _block_fold(q, k, v, mask, o, m, l):
    """Fold one K/V block into the online-softmax state.

    q: (b, h, sq, d) fp32; k/v: (b, h, sk, d) fp32;
    mask: (sq, sk) bool or None; o: (b, h, sq, d); m/l: (b, h, sq).
    """
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k)
    if mask is not None:
        s = jnp.where(mask[None, None], s, NEG)
    m_new = jnp.maximum(m, jnp.max(s, axis=-1))
    p = jnp.exp(s - m_new[..., None])
    alpha = jnp.exp(m - m_new)
    l = l * alpha + jnp.sum(p, axis=-1)
    o = o * alpha[..., None] + jnp.einsum("bhqk,bhkd->bhqd", p, v)
    return o, m_new, l


def ring_attention_shard(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    axis_name: str,
    causal: bool = True,
    scale: Optional[float] = None,
) -> jax.Array:
    """Per-shard ring attention body (call under ``shard_map``).

    Arguments are the *local* sequence chunks, shaped ``(b, s_local, h, d)``
    (batch may itself be sharded over another axis — irrelevant here).
    Returns the local output chunk, same shape/dtype as ``q``.
    """
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d**0.5)
    p_size = jax.lax.psum(1, axis_name)
    my = jax.lax.axis_index(axis_name)
    out_dtype = q.dtype

    # (b, h, s, d) fp32 — softmax statistics in full precision.
    qf = jnp.transpose(q.astype(jnp.float32) * scale, (0, 2, 1, 3))
    kf = jnp.transpose(k.astype(jnp.float32), (0, 2, 1, 3))
    vf = jnp.transpose(v.astype(jnp.float32), (0, 2, 1, 3))

    o = jnp.zeros_like(qf)
    m = jnp.full((b, h, sq), NEG, jnp.float32)
    l = jnp.zeros((b, h, sq), jnp.float32)

    perm = [(i, (i + 1) % p_size) for i in range(p_size)]
    tri = jnp.tril(jnp.ones((sq, sq), bool)) if causal else None

    # Static unroll: p_size is a mesh constant; the diagonal chunk is
    # processed at t == 0 so m is finite from the first fold.
    for t in range(p_size):
        kv_idx = (my - t) % p_size  # owner of the chunk visiting at step t
        if not causal:
            mask = None
        elif t == 0:
            mask = tri  # diagonal block: in-block causal mask
        else:
            # kv chunk strictly before mine -> attend all; after -> none.
            before = kv_idx < my
            mask = jnp.broadcast_to(before, (sq, sq))
        o, m, l = _block_fold(qf, kf, vf, mask, o, m, l)
        if t < p_size - 1:
            kf = jax.lax.ppermute(kf, axis_name, perm)
            vf = jax.lax.ppermute(vf, axis_name, perm)

    out = o / l[..., None]
    return jnp.transpose(out, (0, 2, 1, 3)).astype(out_dtype)


def make_ring_attention(
    mesh: Mesh,
    *,
    seq_axis: str = MODEL_AXIS,
    batch_axis: Optional[str] = DATA_AXIS,
    causal: bool = True,
):
    """Build ``fn(q, k, v) -> out`` over global ``(b, s, h, d)`` arrays with
    the sequence axis sharded over ``seq_axis`` (CP) and batch over
    ``batch_axis`` (DP). Inject as ``QuantAttention(attention_fn=...)`` to
    run the quantized transformer context-parallel.
    """
    spec = P(batch_axis, seq_axis, None, None)
    shard = functools.partial(
        ring_attention_shard, axis_name=seq_axis, causal=causal
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    def ring_fn(q, k, v):
        return shard(q, k, v)

    def apply(q, k, v, *, causal_: Optional[bool] = None):
        del causal_  # fixed at build time
        p_size = mesh.shape[seq_axis]
        if q.shape[1] % p_size:
            raise ValueError(
                f"sequence length {q.shape[1]} not divisible by CP degree "
                f"{p_size} (axis {seq_axis!r})"
            )
        return ring_fn(q, k, v)

    return apply


def full_attention(q, k, v, *, causal: bool = True, scale=None):
    """Single-device reference twin of :func:`ring_attention_shard` —
    identical math (fp32 online-softmax-equivalent result), used by parity
    tests and as the default attention when no mesh is involved."""
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d**0.5)
    scores = (
        jnp.einsum("bqhd,bkhd->bhqk", q.astype(jnp.float32), k.astype(jnp.float32))
        * scale
    )
    if causal:
        mask = jnp.tril(jnp.ones((s, s), bool))
        scores = jnp.where(mask[None, None], scores, NEG)
    attn = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum("bhqk,bkhd->bqhd", attn, v.astype(jnp.float32))
    return out.astype(q.dtype)
