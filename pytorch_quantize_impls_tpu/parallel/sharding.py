"""NamedSharding rules + SPMD train/eval steps (GSPMD path).

Default layout for the quantized CNN/MLP workloads:

* batch axis           -> ``"data"``  (DP: XLA psums grads across devices)
* weight out-features  -> ``"model"`` (TP: XLA all-gathers/reduce-scatters
  around the matmuls; degenerate (size-1) on pure-DP meshes)
* biases / norm params / scalars -> replicated

Packing discipline for the true low-bit path: TP shards are cut on
*unpacked* element boundaries and packed per-shard afterwards
(``kernels``/``infer``), so a packed uint32 word never straddles shards
(SURVEY.md §2 parallelism table).

The train step itself is the SAME function as single-chip
(``train.steps``) — sharded inputs make jit compile it SPMD; that is the
whole point of the jit+NamedSharding design. (The step builders import the
training layer, which needs flax, when they are called; placement helpers
such as ``batch_sharding`` do not.)
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pytorch_quantize_impls_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _spec_for_path(path: str, leaf) -> P:
    ndim = getattr(leaf, "ndim", 0)
    if "kernel" in path and ndim >= 2:
        # shard out-features (last axis) over the model axis
        return P(*([None] * (ndim - 1)), MODEL_AXIS)
    return P()


def param_shardings(tree: Any, mesh: Mesh):
    """NamedSharding pytree for params (or any state containing them —
    optimizer moments mirror the same rule via their 'kernel' paths)."""

    def shard(path, leaf):
        return NamedSharding(mesh, _spec_for_path(jax.tree_util.keystr(path), leaf))

    return jax.tree_util.tree_map_with_path(shard, tree)


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Batch tensors: leading axis over 'data', rest replicated."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (ndim - 1))))


def shard_train_state(state, mesh: Mesh):
    """Place a QuantTrainState on the mesh (params+opt moments TP-sharded,
    everything else replicated)."""
    shardings = param_shardings(state, mesh)
    return jax.device_put(state, shardings), shardings


def shard_batch(batch, mesh: Mesh):
    return tuple(
        jax.device_put(np.asarray(b), batch_sharding(mesh, np.asarray(b).ndim))
        for b in batch
    )


def make_sharded_train_step(state, mesh: Mesh, **step_kwargs):
    """Return ``(sharded_state, step_fn)``: the single-chip train step jitted
    with explicit in/out shardings over ``mesh``. XLA inserts the DP psum and
    TP all-gather/reduce-scatter collectives and overlaps them with compute
    (latency-hiding scheduler)."""
    from pytorch_quantize_impls_tpu.train.steps import make_train_step

    sharded_state, state_shardings = shard_train_state(state, mesh)
    inner = make_train_step(donate=False, jit=False, **step_kwargs)

    metric_sharding = {"loss": replicate(mesh), "accuracy": replicate(mesh)}
    jitted = jax.jit(
        inner,
        in_shardings=(state_shardings, None),
        out_shardings=(state_shardings, metric_sharding),
        donate_argnums=(0,),
    )
    return sharded_state, jitted


def make_sharded_eval_step(state_shardings, mesh: Mesh):
    from pytorch_quantize_impls_tpu.train.steps import make_eval_step

    inner = make_eval_step(jit=False)
    out = {
        "loss": replicate(mesh),
        "accuracy": replicate(mesh),
        "count": replicate(mesh),
    }
    return jax.jit(inner, in_shardings=(state_shardings, None), out_shardings=out)
