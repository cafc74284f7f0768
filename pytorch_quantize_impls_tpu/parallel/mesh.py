"""Device mesh construction (data x model axes).

One mesh serves every scale: a single card (1x1), one host (e.g. 4x1 or
2x2), or several hosts. Within a host the GPUs are joined all to all by
NVLink, every pair at the same rate, so the mesh shape follows the
algorithm alone: TP all-gathers are latency-bound and DP psums are
bandwidth-bound and overlap with backward, and neither cares which cards
share an axis. Only across hosts, where the network is much slower than
NVLink, should the "model" axis stay inside a host and "data" span hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a 2-D (data, model) mesh.

    ``shape=None`` auto-selects: all devices on the data axis (pure DP) —
    the right default for the CNN/MLP workloads of BASELINE configs 1-5,
    where weights fit on one card and batch scaling is what matters. Pass
    an explicit shape (e.g. ``(n // 2, 2)``) for TP; on one NVLink host any
    factorisation has the same link rate between every pair of cards.
    """
    devs = list(devices) if devices is not None else jax.devices()
    n = len(devs)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    # Auto axis types = GSPMD: we annotate inputs, XLA propagates shardings
    # and inserts collectives. (jax 0.9 defaults to Explicit, which demands
    # out_sharding annotations on ambiguous ops like the CE-loss gather.)
    auto = (jax.sharding.AxisType.Auto,) * len(axis_names)
    return jax.make_mesh(shape, axis_names, axis_types=auto, devices=devs)


def multihost_initialize(**kwargs) -> None:
    """Initialize JAX distributed runtime (one process per host).

    Thin wrapper over ``jax.distributed.initialize`` so scripts have a single
    entry point; no-op if already initialized or single-process.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        pass  # already initialized


def assert_host_sync(state, *, atol: float = 0.0) -> None:
    """Cross-host divergence guard (SURVEY.md §5 "race detection" row).

    All hosts of a multi-host job must hold identical step counters, quant
    RNG keys, and replicated parameter bytes — divergence here is the SPMD
    analogue of a data race (it silently corrupts training: each host then
    samples different stochastic quantization masks). Call periodically
    (e.g. alongside checkpoints); raises AssertionError on mismatch.
    No-op in single-process jobs.
    """
    if jax.process_count() == 1:
        return
    import numpy as np
    from jax.experimental import multihost_utils

    step = int(state.step)
    digest = float(
        sum(jnp.sum(jnp.abs(l.astype(jnp.float32))) for l in
            jax.tree_util.tree_leaves(state.params))
    )
    key = np.asarray(jax.random.key_data(state.quant_key)).astype(np.float64)
    local = np.array([float(step), digest, *key.ravel()], np.float64)
    gathered = multihost_utils.process_allgather(local)
    ref = gathered[0]
    for p, row in enumerate(gathered):
        if not np.allclose(row, ref, atol=atol, rtol=0.0):
            raise AssertionError(
                f"host {p} diverged: (step, param-digest, key)={row} "
                f"vs host 0 {ref}"
            )
