"""Tensor-parallel packed matmuls with explicit, overlappable collectives.

Megatron-style TP over the mesh "model" axis, shard_map-explicit so the
collectives decompose into ring steps XLA can overlap with the per-chunk
matmuls (async collective-permute + latency-hiding scheduler), per
BASELINE.json:5 "all-gather/reduce-scatter collectives overlapped with the
packed-matmul compute":

* ``column_parallel_dense``: W col-sharded (out-features), x replicated on
  the model axis -> local packed GEMM, NO comm (output stays sharded).
* ``row_parallel_dense``: W row-sharded (in-features), x feature-sharded ->
  ring reduce-scatter of partial products overlapped with chunked local
  matmul; each device ends with its M-shard of the full output.
* ``allgather_matmul``: x M-sharded on the model axis, W replicated-local;
  the all-gather of x rides the ring one chunk per step, each chunk's
  matmul overlapping the next permute.

Packing discipline: column-sharding packed weights is free (packing runs
along K); row-sharding must cut on ``ops.pack.planar_group_k`` boundaries —
``shard_packed_rows`` enforces this.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from pytorch_quantize_impls_tpu.parallel.mesh import MODEL_AXIS


def _ring_perm(axis_name):
    n = jax.lax.axis_size(axis_name)
    return [(j, (j + 1) % n) for j in range(n)]


def allgather_matmul(x_local, w, axis_name: str = MODEL_AXIS):
    """``allgather(x, axis) @ w`` with the gather overlapped chunk-by-chunk.

    Call INSIDE shard_map. x_local: this device's M-shard (Mc, K); w: local
    weights (K, N) (replicated or column shard). Returns (Mc * n, N): the
    full M rows (for w column shards: this device's N-columns of them).
    """
    n = jax.lax.axis_size(axis_name)
    i = jax.lax.axis_index(axis_name)
    mc = x_local.shape[0]
    out = jnp.zeros((mc * n, w.shape[1]), jnp.result_type(x_local, w))

    def write(out, rows, src_idx):
        return jax.lax.dynamic_update_slice(out, rows, (src_idx * mc, 0))

    chunk = x_local
    out = write(out, chunk @ w, i)
    for t in range(1, n):
        # send current chunk to the right neighbor; after t hops we hold the
        # chunk of device (i - t). The permute is independent of this step's
        # matmul, so XLA overlaps them.
        chunk = jax.lax.ppermute(chunk, axis_name, _ring_perm(axis_name))
        src = (i - t) % n
        out = write(out, chunk @ w, src)
    return out


def matmul_reducescatter(x, w_local, axis_name: str = MODEL_AXIS):
    """``reduce_scatter(x @ W, axis)`` with the reduction ring overlapped.

    Call INSIDE shard_map. x: (M, K_local) — this device's K-shard of the
    activations; w_local: (K_local, N) row shard. Every device contributes a
    partial product for all M rows; the ring accumulates so device i ends
    with rows [i*Mc, (i+1)*Mc) of the REDUCED output (Mc = M // n).
    """
    n = jax.lax.axis_size(axis_name)
    i = jax.lax.axis_index(axis_name)
    m = x.shape[0]
    mc = m // n

    def partial(c):
        rows = jax.lax.dynamic_slice(x, (c * mc, 0), (mc, x.shape[1]))
        return rows @ w_local

    # Each buffer carries ONE chunk identity around the ring: the buffer
    # starting at device j carries chunk (j - 1); after t hops device i holds
    # the buffer originated at (i - t), i.e. chunk (i - t - 1), and adds its
    # own partial for that chunk. After n-1 hops device i holds chunk i,
    # fully reduced. Each step's partial matmul is independent of the
    # in-flight permute, so XLA overlaps them.
    buf = partial((i - 1) % n)
    for t in range(1, n):
        buf = jax.lax.ppermute(buf, axis_name, _ring_perm(axis_name))
        buf = buf + partial((i - t - 1) % n)
    return buf  # rows of chunk i, fully reduced


def shard_packed_rows(packed, n_shards: int, group_k: int):
    """Split grouped-planar packed weights along K into TP row-shards.

    Shard boundaries must land on group boundaries (``group_k`` K-rows =
    ``group_k // (32 // bits)`` packed rows) so each shard decodes
    independently.
    """
    r = packed.shape[0]
    if r % n_shards:
        raise ValueError(f"{r} packed rows not divisible by {n_shards} shards")
    rows_per = r // n_shards
    # r is in packed rows; groups are GROUP_ROWS=32 packed rows
    if rows_per % 32:
        raise ValueError(
            f"shard of {rows_per} packed rows splits a 32-row group; pad K "
            f"to a multiple of {n_shards} * {group_k}"
        )
    return packed.reshape(n_shards, rows_per, packed.shape[1])


def allgather_matmul_q8(
    x_local, w, axis_name: str = MODEL_AXIS, *, bits: int = 8
):
    """``allgather_matmul`` with an int8 wire format (VERDICT r3 #9).

    The bf16/f32 activation all-gather dominates TP comm bytes; here each
    device quantizes its M-shard ONCE (symmetric per-shard scale, the
    EQuARX-style codec from ``quantized_collectives``) and the ring carries
    int8 codes + one f32 scale — 4x fewer bytes than f32, 2x fewer than
    bf16. Every device dequantizes with the ORIGIN device's scale, so all
    devices compute from identical values: the only error vs
    :func:`allgather_matmul` is the one-time input quantization (bounded,
    tested). Call INSIDE shard_map. x_local (Mc, K); w local (K, N).

    If ``w.dtype == int8`` (e.g. decoded ±1 binary weights) the local
    compute is the int8 GEMM with the scale applied in the epilogue —
    composing with packed TP serving.
    """
    from pytorch_quantize_impls_tpu.parallel.quantized_collectives import (
        quantize_symmetric,
    )

    n = jax.lax.axis_size(axis_name)
    i = jax.lax.axis_index(axis_name)
    mc = x_local.shape[0]
    codes, scale = quantize_symmetric(x_local, bits)

    int8_w = w.dtype == jnp.int8
    out_dt = jnp.float32 if int8_w else jnp.result_type(x_local, w)
    out = jnp.zeros((mc * n, w.shape[1]), out_dt)

    def chunk_matmul(c, s):
        if int8_w:
            y = jnp.dot(c, w, preferred_element_type=jnp.int32)
            return y.astype(jnp.float32) * s
        return (c.astype(w.dtype) @ w) * s.astype(w.dtype)

    def write(out, rows, src_idx):
        return jax.lax.dynamic_update_slice(out, rows, (src_idx * mc, 0))

    out = write(out, chunk_matmul(codes, scale), i)
    for t in range(1, n):
        # int8 payload + f32 scale ride the ring; the permute is independent
        # of this step's matmul, so XLA overlaps them (same schedule as the
        # fp allgather_matmul).
        codes = jax.lax.ppermute(codes, axis_name, _ring_perm(axis_name))
        scale = jax.lax.ppermute(scale, axis_name, _ring_perm(axis_name))
        out = write(out, chunk_matmul(codes, scale), (i - t) % n)
    return out


def allgather_matmul_b1(x_codes, w, axis_name: str = MODEL_AXIS):
    """``allgather_matmul`` for BINARY (±1) activations with a bit-packed
    wire format: 32 sign codes per int32 lane — 32x fewer bytes than f32,
    and EXACT (±1 is losslessly 1-bit).

    Call INSIDE shard_map. ``x_codes``: this device's M-shard of ±1 int8
    activation codes (Mc, K), K % 32 == 0; ``w``: local weights — int8 ±1
    codes for the int8 GEMM path, or any fp dtype. This is the TP serving
    composition: binary activations cross the interconnect as 1-bit planes, exactly
    like the packed weights rest in HBM (BASELINE.json:5).
    """
    n = jax.lax.axis_size(axis_name)
    i = jax.lax.axis_index(axis_name)
    mc, k = x_codes.shape
    if k % 32:
        raise ValueError(f"K={k} must be a multiple of 32 for 1-bit packing")

    powers = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]

    def pack_rows(c):  # (Mc, K) ±1 -> (Mc, K//32) uint32 sign planes
        bits01 = (c > 0).astype(jnp.uint32).reshape(mc, k // 32, 32)
        return jnp.sum(bits01 * powers, axis=-1, dtype=jnp.uint32)

    def unpack_rows(p):  # planes -> (Mc, K) ±1 int8
        b = (p[..., None] >> jnp.arange(32, dtype=jnp.uint32)) & jnp.uint32(1)
        return jnp.where(b.reshape(mc, k) != 0, 1, -1).astype(jnp.int8)

    int8_w = w.dtype == jnp.int8
    out_dt = jnp.float32 if int8_w else w.dtype

    def chunk_matmul(c):
        if int8_w:
            return jnp.dot(
                c, w, preferred_element_type=jnp.int32
            ).astype(jnp.float32)
        return c.astype(w.dtype) @ w

    out = jnp.zeros((mc * n, w.shape[1]), out_dt)

    def write(out, rows, src_idx):
        return jax.lax.dynamic_update_slice(out, rows, (src_idx * mc, 0))

    planes = pack_rows(x_codes)
    out = write(out, chunk_matmul(x_codes), i)
    for t in range(1, n):
        planes = jax.lax.ppermute(planes, axis_name, _ring_perm(axis_name))
        out = write(out, chunk_matmul(unpack_rows(planes)), (i - t) % n)
    return out


def tp_binary_dense(
    x,
    w8,  # decoded ±1 int8 (K, N), to be column-sharded
    alpha: Optional[jax.Array],
    mesh: Mesh,
    *,
    gather_output: bool = True,
):
    """Column-parallel binary dense over the mesh model axis.

    x replicated on 'model' (sharded on 'data' as usual); w8 column-sharded.
    Local compute is the int8 GEMM; the optional output all-gather is the
    only collective.
    """

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, None), P(None, MODEL_AXIS), P(MODEL_AXIS)),
        out_specs=P(None, MODEL_AXIS) if not gather_output else P(None, None),
        check_vma=False,
    )
    def f(x, w_local, a_local):
        y = jnp.dot(x, w_local, preferred_element_type=jnp.int32).astype(
            jnp.float32
        )
        if alpha is not None:
            y = y * a_local[None, :]
        if gather_output:
            y = jax.lax.all_gather(y, MODEL_AXIS, axis=1, tiled=True)
        return y

    a = alpha if alpha is not None else jnp.ones((w8.shape[1],), jnp.float32)
    return f(x, w8, a)
