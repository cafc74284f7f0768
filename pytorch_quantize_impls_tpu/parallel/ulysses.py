"""Ulysses sequence parallelism — all-to-all head<->sequence resharding.

NEW scope: the reference has no sequence workloads (SURVEY.md §5 records
ring/Ulysses/CP as absent there); together with ``ring_attention.py`` this
completes both standard context-parallel attention strategies.

Realization (DeepSpeed-Ulysses, Jacobs et al. 2023): activations
arrive sequence-sharded — each device of the axis holds ``(b, s/P, h, d)``.
One ``jax.lax.all_to_all`` per tensor swaps the sharded dimension: split the
HEAD axis P ways, concatenate the SEQUENCE axis, leaving ``(b, s, h/P, d)``
— every device now sees the FULL sequence for a 1/P slice of heads and runs
ordinary (flash-style) attention locally with no inter-device math. A second
all-to-all swaps back. Two a2a pairs per attention vs the ring's P-1
ppermute rounds: Ulysses wins when P <= h and all-to-all bandwidth is
plentiful (one NVLink host), the ring wins for P > h or when overlap with the
fold matters. ``all_to_all`` is differentiable (its transpose is the
inverse all-to-all), so the same path serves training.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
from jax.sharding import Mesh, PartitionSpec as P

from pytorch_quantize_impls_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from pytorch_quantize_impls_tpu.parallel.ring_attention import full_attention


def ulysses_attention_shard(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    axis_name: str,
    causal: bool = True,
    scale: Optional[float] = None,
) -> jax.Array:
    """Per-shard Ulysses body (call under ``shard_map``).

    Arguments are local sequence chunks ``(b, s_local, h, d)`` with
    ``h % axis_size == 0``. Returns the local output chunk, same shape.
    """
    h = q.shape[2]
    p_size = jax.lax.psum(1, axis_name)
    if h % p_size:
        raise ValueError(f"n_heads {h} not divisible by SP degree {p_size}")
    # (b, s/P, h, d) -> (b, s, h/P, d): split heads, gather sequence
    a2a = functools.partial(
        jax.lax.all_to_all, axis_name=axis_name, split_axis=2, concat_axis=1,
        tiled=True,
    )
    qi, ki, vi = a2a(q), a2a(k), a2a(v)
    out = full_attention(qi, ki, vi, causal=causal, scale=scale)
    # (b, s, h/P, d) -> (b, s/P, h, d): split sequence, gather heads
    return jax.lax.all_to_all(
        out, axis_name=axis_name, split_axis=1, concat_axis=2, tiled=True
    )


def make_ulysses_attention(
    mesh: Mesh,
    *,
    seq_axis: str = MODEL_AXIS,
    batch_axis: Optional[str] = DATA_AXIS,
    causal: bool = True,
):
    """Build ``fn(q, k, v) -> out`` over global ``(b, s, h, d)`` arrays with
    the sequence axis sharded over ``seq_axis`` (SP) and batch over
    ``batch_axis`` (DP). Same injection contract as
    :func:`make_ring_attention`: pass as ``QuantAttention(attention_fn=...)``.
    """
    spec = P(batch_axis, seq_axis, None, None)
    shard = functools.partial(
        ulysses_attention_shard, axis_name=seq_axis, causal=causal
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    def ulysses_fn(q, k, v):
        return shard(q, k, v)

    def apply(q, k, v):
        p_size = mesh.shape[seq_axis]
        if q.shape[1] % p_size:
            raise ValueError(
                f"sequence length {q.shape[1]} not divisible by SP degree "
                f"{p_size} (axis {seq_axis!r})"
            )
        if q.shape[2] % p_size:
            raise ValueError(
                f"n_heads {q.shape[2]} not divisible by SP degree {p_size}"
            )
        return ulysses_fn(q, k, v)

    return apply
