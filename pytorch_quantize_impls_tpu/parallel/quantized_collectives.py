"""Quantized gradient collectives — int8/int4 ring all-reduce for DP.

NEW scope, no reference counterpart (the reference has no distribution at
all — SURVEY.md §2 "Parallelism & communication components"). This is the
EQuARX-style compressed gradient exchange flagged in SURVEY.md §5
("collectives on packed int8/int32 payloads cut comm bytes 4-32x vs fp32"):
every hop of the ring reduce-scatter / all-gather carries a symmetric
per-chunk int8 (or packed int4) payload + one fp32 scale instead of fp32
gradients, cutting DP gradient-exchange bytes ~4x (int8) / ~8x (int4) at
the cost of bounded quantization noise (re-quantized once per hop).

All collectives here are written against ``jax.lax`` collective primitives
(``ppermute``/``all_gather``) and therefore must run inside ``shard_map``
(or pmap). ``make_quantized_dp_train_step`` packages the whole DP training
step that way; the GSPMD path (``parallel.sharding``) stays the default for
uncompressed training.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from pytorch_quantize_impls_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

Array = jax.Array


# -- symmetric quantize/dequantize codecs ---------------------------------


def quantize_symmetric(x: Array, bits: int = 8):
    """Symmetric per-tensor quantization: ``x ≈ codes * scale``.

    Returns ``(codes int8, scale f32 scalar)``. ``bits`` ≤ 8; codes live in
    [-(2^(bits-1)-1), 2^(bits-1)-1] (no -128: symmetric, like NCCL/EQuARX).
    """
    qmax = float(2 ** (bits - 1) - 1)
    scale = jnp.maximum(jnp.max(jnp.abs(x)) / qmax, jnp.finfo(jnp.float32).tiny)
    codes = jnp.clip(jnp.round(x / scale), -qmax, qmax).astype(jnp.int8)
    return codes, scale.astype(jnp.float32)


def dequantize_symmetric(codes: Array, scale: Array) -> Array:
    return codes.astype(jnp.float32) * scale


def _pack_int4(codes: Array) -> Array:
    """Two int4 code values per int8 byte (even length required)."""
    lo = codes[0::2] & 0x0F
    hi = (codes[1::2] & 0x0F) << 4
    return (lo | hi).astype(jnp.int8)


def _unpack_int4(packed: Array) -> Array:
    lo = (packed << 4).astype(jnp.int8) >> 4  # sign-extend low nibble
    hi = packed >> 4  # arithmetic shift sign-extends high nibble
    return jnp.stack([lo, hi], axis=-1).reshape(-1).astype(jnp.int8)


def _encode(x: Array, bits: int):
    codes, scale = quantize_symmetric(x, bits)
    if bits == 4:
        codes = _pack_int4(codes)
    return codes, scale


def _decode(payload: Array, scale: Array, bits: int, n: int) -> Array:
    if bits == 4:
        payload = _unpack_int4(payload)[:n]
    return dequantize_symmetric(payload, scale)


# -- ring all-reduce over quantized payloads ------------------------------


def ring_allreduce_quantized(
    x: Array, axis_name: str = DATA_AXIS, *, bits: int = 8
) -> Array:
    """All-reduce (sum) of ``x`` over ``axis_name`` with quantized wire format.

    Ring reduce-scatter then ring-free all-gather; every transfer is an
    int8 (or packed-int4) payload + fp32 scale. Must run inside shard_map.
    Partial sums are re-quantized at each of the n-1 reduce hops, so the
    result carries O(n·ulp(bits)) noise — acceptable for gradients (verified
    in tests against exact psum).
    """
    n = lax.psum(1, axis_name)
    if n == 1:
        return x
    if bits == 4:
        # packed nibbles need even chunk lengths
        pad_to = 2 * n
    else:
        pad_to = n
    shape, dtype = x.shape, x.dtype
    flat = x.astype(jnp.float32).reshape(-1)
    pad = (-flat.size) % pad_to
    padded = jnp.pad(flat, (0, pad))
    chunks = padded.reshape(n, -1)
    chunk_len = padded.size // n
    i = lax.axis_index(axis_name)
    perm = [(d, (d + 1) % n) for d in range(n)]  # send right

    # Ring reduce-scatter. At hop t device i sends the partial sum of chunk
    # (i - t) mod n and receives chunk (i - t - 1) mod n, adding its local
    # copy; after n-1 hops device i owns the fully reduced chunk (i+1) mod n.
    acc = jnp.take(chunks, i, axis=0)
    for t in range(n - 1):
        payload, scale = _encode(acc, bits)
        payload = lax.ppermute(payload, axis_name, perm)
        scale = lax.ppermute(scale, axis_name, perm)
        idx = (i - t - 1) % n
        acc = _decode(payload, scale, bits, chunk_len) + jnp.take(
            chunks, idx, axis=0
        )

    # All-gather of the reduced chunks (quantized once). Row d of the gather
    # came from device d, which owns chunk (d+1) mod n -> roll by one row.
    payload, scale = _encode(acc, bits)
    g_payload = lax.all_gather(payload, axis_name, axis=0)
    g_scale = lax.all_gather(scale, axis_name, axis=0)
    rows = [
        _decode(g_payload[d], g_scale[d], bits, chunk_len) for d in range(n)
    ]
    out = jnp.concatenate([rows[(c - 1) % n] for c in range(n)])
    if pad:
        out = out[:-pad]
    return out.reshape(shape).astype(dtype)


def pmean_quantized(tree, axis_name: str = DATA_AXIS, *, bits: int = 8):
    """Tree-wise quantized all-reduce-mean (the DP gradient exchange)."""
    n = lax.psum(1, axis_name)
    return jax.tree_util.tree_map(
        lambda g: ring_allreduce_quantized(g, axis_name, bits=bits) / n, tree
    )


# -- DP train step with compressed gradient exchange ----------------------


def make_quantized_dp_train_step(
    state,
    mesh: Mesh,
    *,
    bits: int = 8,
    elastic_weight: float = 0.0,
    loss_fn: Optional[Callable] = None,
    has_quant_rng: bool = False,
):
    """Pure-DP train step with int8/int4 gradient all-reduce.

    Same contract as ``parallel.make_sharded_train_step`` (returns
    ``(sharded_state, step_fn)``) but built on ``shard_map``: each device
    computes grads on its batch shard, grads are exchanged with
    ``ring_allreduce_quantized``, and the optimizer update runs replicated.
    Requires a DP-only mesh (model axis of size 1).

    BatchNorm caveat: normalization uses per-device (local) batch statistics
    — the standard local-BN DP convention — while the running averages are
    pmean-synced across devices. The GSPMD path normalizes over the global
    batch; expect small training-dynamics differences on BN models.

    ``loss_fn`` defaults to ``train.steps.cross_entropy``.
    """
    # the training layer (flax) is imported here, not at module import, so
    # the collectives serve the flax-free paths too
    from pytorch_quantize_impls_tpu.train.steps import (
        cross_entropy,
        make_compute_loss,
    )

    loss_fn = loss_fn or cross_entropy
    if MODEL_AXIS in mesh.shape and mesh.shape[MODEL_AXIS] != 1:
        raise ValueError(
            "quantized DP step is data-parallel only; use a (n, 1) mesh "
            f"(got model axis size {mesh.shape[MODEL_AXIS]})"
        )

    repl = NamedSharding(mesh, P())
    sharded_state = jax.device_put(state, repl)

    def local_step(state, batch):
        x, y = batch
        compute_loss = make_compute_loss(
            state, x, y,
            elastic_weight=elastic_weight, loss_fn=loss_fn,
            has_quant_rng=has_quant_rng,
        )
        (loss, (logits, new_stats)), grads = jax.value_and_grad(
            compute_loss, has_aux=True
        )(state.params)
        grads = pmean_quantized(grads, DATA_AXIS, bits=bits)
        state = state.apply_gradients(grads=grads)
        if new_stats is not None:
            state = state.replace(
                batch_stats=jax.tree_util.tree_map(
                    lambda a: lax.pmean(a, DATA_AXIS), new_stats
                )
            )
        metrics = {
            "loss": lax.pmean(loss, DATA_AXIS),
            "accuracy": lax.pmean(
                jnp.mean(jnp.argmax(logits, -1) == y), DATA_AXIS
            ),
        }
        return state, metrics

    batch_spec = (P(DATA_AXIS), P(DATA_AXIS))
    mapped = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), batch_spec),
        out_specs=(P(), P()),
        check_vma=False,
    )
    step = jax.jit(mapped, donate_argnums=(0,))
    return sharded_state, step


def comm_bytes_saved(tree, bits: int = 8) -> dict:
    """Report the wire-byte reduction of the compressed exchange vs fp32."""
    n_elems = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(tree))
    fp32 = 4 * n_elems
    comp = n_elems * bits // 8 + 4 * len(jax.tree_util.tree_leaves(tree))
    return {"fp32_bytes": fp32, "compressed_bytes": comp, "ratio": fp32 / comp}
