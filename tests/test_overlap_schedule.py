"""Comm/compute overlap evidence (SURVEY.md §7 hard-part 5: "verify overlap
in profiler, don't assume").

What CAN be verified without multi-chip hardware: the compiled HLO of the
ring collective-matmuls must show the chunked schedule — n-1 collective
permutes INTERLEAVED with the per-chunk matmuls (a dot between consecutive
permutes), never a monolithic all-gather followed by one dot. That
interleaving is exactly the structure XLA's latency-hiding scheduler needs
to run each permute asynchronously (collective-permute-start/done pairs)
while the current chunk's matmul executes. The remaining
hardware-level verification (profiler timeline showing the permute hidden
under the dot) needs >1 real chip — see docs/OVERLAP.md.
"""

import functools
import re

import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from pytorch_quantize_impls_tpu.parallel import make_mesh
from pytorch_quantize_impls_tpu.parallel.collective_matmul import (
    allgather_matmul,
    matmul_reducescatter,
)

N = 8


def _need_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def _schedule(fn, *args):
    """Ordered (kind,) list of collective-permute / dot ops in the compiled
    module's execution order."""
    txt = jax.jit(fn).lower(*args).compile().as_text()
    ops = []
    for line in txt.splitlines():
        if re.search(r"= .*collective-permute(-start)?\(", line):
            ops.append("permute")
        elif re.search(r"= .*dot\(", line):
            ops.append("dot")
        elif re.search(r"%\S*add\S* = .*(add|fusion)\(", line):
            # the ring accumulate — may be fused (CPU: %wrapped_add fusion)
            ops.append("add")
    return ops


def _assert_interleaved(ops, n):
    """The ring form: n-1 permutes, >= n chunk matmuls, and per-chunk
    compute (dot, or the dependent accumulate add for reduce-scatter)
    between consecutive permutes — never one monolithic collective followed
    by a single dot. (The CPU scheduler may hoist the permute-independent
    dots ahead of the ring; that independence is exactly what lets the GPU
    latency-hiding scheduler run them UNDER the in-flight permutes.)"""
    permutes = [i for i, k in enumerate(ops) if k == "permute"]
    compute = [i for i, k in enumerate(ops) if k in ("dot", "add")]
    n_dots = sum(1 for k in ops if k == "dot")
    assert len(permutes) == n - 1, ops
    assert n_dots >= n, ops
    for a, b in zip(permutes, permutes[1:]):
        assert any(a < d < b for d in compute), (
            f"no compute between permutes at {a} and {b}: {ops}"
        )


def test_allgather_matmul_schedule_interleaves():
    _need_devices(N)
    mesh = make_mesh((1, N))
    f = shard_map(
        functools.partial(allgather_matmul, axis_name="model"),
        mesh=mesh,
        in_specs=(P("model", None), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )
    x = jnp.ones((8 * N, 32))
    w = jnp.ones((32, 16))
    _assert_interleaved(_schedule(f, x, w), N)


def test_reducescatter_matmul_schedule_interleaves():
    _need_devices(N)
    mesh = make_mesh((1, N))
    f = shard_map(
        functools.partial(matmul_reducescatter, axis_name="model"),
        mesh=mesh,
        in_specs=(P(None, "model"), P("model", None)),
        out_specs=P("model", None),
        check_vma=False,
    )
    x = jnp.ones((8 * N, 4 * N))
    w = jnp.ones((4 * N, 16))
    _assert_interleaved(_schedule(f, x, w), N)
