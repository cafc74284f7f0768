"""Block-wise 8-bit Adam: optimizer moments stored quantized in HBM.

NEW scope beyond the reference (which has no optimizer subsystem at all —
SURVEY.md §2-L2 uses plain torch Adam): at production scale the Adam
moments are 8 bytes/param of fp32 HBM — usually the single largest training
state after the params themselves. This transform stores them quantized:

* ``m`` (first moment, signed)  -> int8 sign+log-magnitude codes
* ``v`` (second moment, >= 0)   -> uint8 log codes

each with a per-block fp32 absmax = 2 bytes/param + 4/block bytes of
scales: a ~4x optimizer-state HBM cut, in the spirit of 8-bit Adam
(Dettmers et al., arXiv:2110.02861) but with an analytic block-wise LOG
code instead of the dynamic-tree LUT — the decode/encode must stay a
handful of fused elementwise ops (exp2/log2), not a 256-entry gather, to
disappear into the update's elementwise fusion under jit. The log domain
is load-bearing, not a convenience: see the note above ``_encode``.

Each update step decodes the moments, applies the standard Adam math in
fp32, and re-encodes — quantization error therefore enters the *state*,
not the gradient path, and block-wise absmax keeps the relative error at
the ~1/254 level per block. Convergence on the BASELINE tasks matches
fp32 Adam (tests/test_quantized_optim.py trains the BinaryConnect MLP to
the same accuracy).

Usage — drop-in where ``optax.adam`` went::

    tx = optax.chain(quantized_adam(1e-3), clip_quantized_weights())

The state is a pytree of ``Quantized8`` leaves, so orbax checkpointing and
sharding work unchanged (codes shard like the params they mirror).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax
from flax import struct


@struct.dataclass
class Quantized8:
    """A tensor stored as 8-bit codes + per-block fp32 absmax scales.

    ``size`` is static metadata (NOT a pytree leaf — as a leaf it would be
    traced under jit and break the unpad slice in ``_decode``).
    """

    codes: jax.Array  # int8 (signed payload) or uint8 (non-negative)
    scale: jax.Array  # f32 (n_blocks,) absmax / code-range
    size: int = struct.field(pytree_node=False)  # unpadded element count


class QuantizedAdamState(NamedTuple):
    count: jax.Array  # int32 step counter
    mu: optax.Params  # pytree of Quantized8 (signed)
    nu: optax.Params  # pytree of Quantized8 (unsigned)


# Log-domain code ranges (octaves below the block absmax). Linear absmax
# codes are WRONG for Adam moments: within one block v spans many decades,
# small entries quantize to code 0, and the next update divides a nonzero
# m by sqrt(0)+eps — the step explodes (seen directly in the r3 unit test:
# update norm 0.31 -> 12.6 in four steps). A log code bounds the RELATIVE
# error everywhere (~3% at these ranges), which is the property 1/sqrt(v)
# actually needs; this is the analytic stand-in for 8-bit Adam's dynamic
# tree code (a 256-entry LUT gather would not vectorize well on the VPU,
# exp2/log2 do).
_R_SIGNED = 12.0  # m: 127 magnitude levels over 2^-12..1 of absmax
_R_UNSIGNED = 24.0  # v: 255 levels over 2^-24..1 of absmax


def _encode(x: jax.Array, block: int, signed: bool) -> Quantized8:
    flat = x.astype(jnp.float32).reshape(-1)
    n = flat.size
    pad = (-n) % block
    flat = jnp.pad(flat, (0, pad)).reshape(-1, block)
    mag = jnp.abs(flat)
    absmax = jnp.max(mag, axis=1)
    inv = jnp.where(absmax > 0, 1.0 / jnp.where(absmax > 0, absmax, 1.0), 0.0)
    xn = mag * inv[:, None]
    r, levels = (_R_SIGNED, 126.0) if signed else (_R_UNSIGNED, 254.0)
    # log2 of the normalized magnitude, floored at -r (values below the
    # floor keep code 1 — NOT zero — so decode never collapses to 0).
    l = jnp.clip(jnp.log2(jnp.maximum(xn, 2.0**(-r - 1))), -r, 0.0)
    code = jnp.round(1.0 + (l + r) * (levels / r))
    code = jnp.where(xn > 0, code, 0.0)
    if signed:
        codes = (jnp.sign(flat) * code).astype(jnp.int8)
    else:
        codes = code.astype(jnp.uint8)
    return Quantized8(codes=codes, scale=absmax, size=n)


def _decode(q: Quantized8, shape) -> jax.Array:
    signed = q.codes.dtype == jnp.int8
    r, levels = (_R_SIGNED, 126.0) if signed else (_R_UNSIGNED, 254.0)
    c = q.codes.astype(jnp.float32)
    mag_code = jnp.abs(c)
    mag = jnp.where(
        mag_code > 0,
        jnp.exp2((mag_code - 1.0) * (r / levels) - r),
        0.0,
    ) * q.scale[:, None]
    flat = jnp.sign(c) * mag if signed else mag
    return flat.reshape(-1)[: q.size].reshape(shape)


def _zeros_like_q(p: jax.Array, block: int, signed: bool) -> Quantized8:
    n = p.size
    nb = -(-n // block)
    dtype = jnp.int8 if signed else jnp.uint8
    return Quantized8(
        codes=jnp.zeros((nb, block), dtype),
        scale=jnp.zeros((nb,), jnp.float32),
        size=n,
    )


def quantized_adam(
    learning_rate: optax.ScalarOrSchedule = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    block: int = 256,
    min_quantized_size: int = 2 * 256,
) -> optax.GradientTransformation:
    """Adam with int8/uint8 block-quantized moments (see module docstring).

    ``block``: elements per scale block (256 matches the 8-bit-Adam paper's
    sweet spot and is a lane multiple, so encode/decode vectorizes cleanly).
    ``min_quantized_size``: leaves smaller than this (biases, BN params)
    keep fp32 moments — their memory is negligible and small tensors are
    where quantization noise hurts most.
    """

    def tiny(p) -> bool:
        return p.size < min_quantized_size

    def init(params):
        mu = jax.tree_util.tree_map(
            lambda p: jnp.zeros_like(p, jnp.float32)
            if tiny(p)
            else _zeros_like_q(p, block, signed=True),
            params,
        )
        nu = jax.tree_util.tree_map(
            lambda p: jnp.zeros_like(p, jnp.float32)
            if tiny(p)
            else _zeros_like_q(p, block, signed=False),
            params,
        )
        return QuantizedAdamState(jnp.zeros((), jnp.int32), mu, nu)

    def update(updates, state, params=None):
        del params
        count = state.count + 1
        bc1 = 1.0 - b1 ** count.astype(jnp.float32)
        bc2 = 1.0 - b2 ** count.astype(jnp.float32)
        # optax convention: schedules are evaluated at the PRE-increment
        # count (first update uses schedule(0), last uses schedule(steps-1)),
        # so e.g. cosine_decay_schedule never runs a step at lr=0 and
        # trajectories match optax.adam exactly.
        lr = (
            learning_rate(state.count)
            if callable(learning_rate)
            else learning_rate
        )

        def upd(g, mq, vq):
            g = g.astype(jnp.float32)
            m = mq if isinstance(mq, jax.Array) else _decode(mq, g.shape)
            v = vq if isinstance(vq, jax.Array) else _decode(vq, g.shape)
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            step = -lr * (m / bc1) / (jnp.sqrt(v / bc2) + eps)
            m_out = m if isinstance(mq, jax.Array) else _encode(m, block, True)
            v_out = v if isinstance(vq, jax.Array) else _encode(v, block, False)
            return step, m_out, v_out

        is_leaf = lambda x: isinstance(x, Quantized8)  # noqa: E731
        flat_u, treedef = jax.tree_util.tree_flatten(updates)
        flat_m = treedef.flatten_up_to(state.mu)
        flat_v = treedef.flatten_up_to(state.nu)
        out = [upd(g, m, v) for g, m, v in zip(flat_u, flat_m, flat_v)]
        steps = treedef.unflatten([o[0] for o in out])
        mu = treedef.unflatten([o[1] for o in out])
        nu = treedef.unflatten([o[2] for o in out])
        del is_leaf
        return steps, QuantizedAdamState(count, mu, nu)

    return optax.GradientTransformation(init, update)


def optimizer_state_bytes(state) -> int:
    """Total bytes held by optimizer-state arrays (diagnostic)."""
    leaves = jax.tree_util.tree_leaves(state)
    return sum(l.size * l.dtype.itemsize for l in leaves if hasattr(l, "dtype"))
