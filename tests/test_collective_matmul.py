"""Ring-overlap collective matmul correctness on the 8-device CPU mesh."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from pytorch_quantize_impls_tpu import parallel
from pytorch_quantize_impls_tpu.parallel import collective_matmul as cm
from pytorch_quantize_impls_tpu.ops import pack as packlib

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

RNG = np.random.default_rng(0)


def _mesh():
    return parallel.make_mesh((1, 8))


def test_allgather_matmul():
    mesh = _mesh()
    m, k, n = 64, 32, 48  # m sharded 8-way on model
    x = jnp.asarray(RNG.normal(size=(m, k)).astype(np.float32))
    w = jnp.asarray(RNG.normal(size=(k, n)).astype(np.float32))

    f = shard_map(
        functools.partial(cm.allgather_matmul, axis_name="model"),
        mesh=mesh,
        in_specs=(P("model", None), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )
    got = f(x, w)
    np.testing.assert_allclose(np.asarray(got), np.asarray(x @ w), rtol=1e-5, atol=1e-5)


def test_matmul_reducescatter():
    mesh = _mesh()
    m, k, n = 64, 256, 32  # k sharded 8-way
    x = jnp.asarray(RNG.normal(size=(m, k)).astype(np.float32))
    w = jnp.asarray(RNG.normal(size=(k, n)).astype(np.float32))

    f = shard_map(
        functools.partial(cm.matmul_reducescatter, axis_name="model"),
        mesh=mesh,
        in_specs=(P(None, "model"), P("model", None)),
        out_specs=P("model", None),
        check_vma=False,
    )
    got = f(x, w)
    np.testing.assert_allclose(np.asarray(got), np.asarray(x @ w), rtol=1e-4, atol=1e-4)


def test_tp_binary_dense_matches_local():
    mesh = _mesh()
    m, k, n = 16, 128, 64
    x = jnp.asarray(RNG.normal(size=(m, k)).astype(np.float32))
    w = jnp.asarray(RNG.normal(size=(k, n)).astype(np.float32))
    w8 = jnp.where(w >= 0, 1, -1).astype(jnp.int8)
    xi = jnp.where(x >= 0, 1, -1).astype(jnp.int8)
    alpha = jnp.abs(w).mean(0)

    got = cm.tp_binary_dense(xi, w8, alpha, mesh)
    ref = (xi.astype(jnp.float32) @ w8.astype(jnp.float32)) * alpha[None, :]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5)

    got_sharded = cm.tp_binary_dense(xi, w8, alpha, mesh, gather_output=False)
    np.testing.assert_allclose(np.asarray(got_sharded), np.asarray(ref), rtol=1e-5)


def test_shard_packed_rows_boundaries():
    gk = packlib.planar_group_k(1)  # 1024
    k, n = 4 * gk, 16
    codes = RNG.integers(0, 2, size=(k, n))
    p = packlib.pack_bitplanes(jnp.asarray(codes), 1)
    shards = cm.shard_packed_rows(p, 4, gk)
    assert shards.shape == (4, p.shape[0] // 4, n)
    # each shard decodes independently to its K-slice
    for s in range(4):
        got = packlib.unpack_bitplanes(shards[s], 1, gk)
        np.testing.assert_array_equal(
            np.asarray(got), codes[s * gk : (s + 1) * gk]
        )
    with pytest.raises(ValueError):
        cm.shard_packed_rows(p, 3, gk)


def test_allgather_matmul_q8_matches_dequantized_reference():
    """int8-wire all-gather matmul (VERDICT r3 #9): every device computes
    from the ORIGIN shard's dequantized codes, so the result must equal the
    fp matmul of the (quantize->dequantize)'d input EXACTLY — the only error
    vs fp is the one-time input quantization."""
    from pytorch_quantize_impls_tpu.parallel.quantized_collectives import (
        dequantize_symmetric,
        quantize_symmetric,
    )

    mesh = _mesh()
    m, k, n = 64, 32, 48
    x = jnp.asarray(RNG.normal(size=(m, k)).astype(np.float32))
    w = jnp.asarray(RNG.normal(size=(k, n)).astype(np.float32))

    f = shard_map(
        functools.partial(cm.allgather_matmul_q8, axis_name="model"),
        mesh=mesh,
        in_specs=(P("model", None), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )
    got = f(x, w)
    # reference: per-shard quantize/dequantize then exact matmul
    shards = np.asarray(x).reshape(8, -1, k)
    deq = np.concatenate([
        np.asarray(dequantize_symmetric(*quantize_symmetric(jnp.asarray(s))))
        for s in shards
    ])
    np.testing.assert_allclose(
        np.asarray(got), deq @ np.asarray(w), rtol=1e-5, atol=1e-5
    )
    # and the quantization error itself is bounded
    np.testing.assert_allclose(np.asarray(got), np.asarray(x) @ np.asarray(w),
                               rtol=0.1, atol=0.15)


def test_allgather_matmul_q8_int8_weights_path():
    """With int8 ±1 weights the local compute is the integer GEMM."""
    mesh = _mesh()
    m, k, n = 32, 64, 16
    x = jnp.asarray(RNG.normal(size=(m, k)).astype(np.float32))
    w8 = jnp.asarray(RNG.choice([-1, 1], size=(k, n)), jnp.int8)

    f = shard_map(
        functools.partial(cm.allgather_matmul_q8, axis_name="model"),
        mesh=mesh,
        in_specs=(P("model", None), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )
    got = f(x, w8)
    assert got.dtype == jnp.float32
    ref = np.asarray(x) @ np.asarray(w8).astype(np.float32)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0.1, atol=0.2)


def test_allgather_matmul_b1_exact_binary_wire():
    """1-bit-packed activation all-gather (32x wire reduction) is EXACT for
    ±1 codes — the TP serving composition: binary activations cross the
    interconnect as sign planes, binary weights run as int8 GEMMs."""
    mesh = _mesh()
    m, k, n = 32, 64, 24  # k % 32 == 0
    codes = jnp.asarray(RNG.choice([-1, 1], size=(m, k)), jnp.int8)
    w8 = jnp.asarray(RNG.choice([-1, 1], size=(k, n)), jnp.int8)

    f = shard_map(
        functools.partial(cm.allgather_matmul_b1, axis_name="model"),
        mesh=mesh,
        in_specs=(P("model", None), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )
    got = f(codes, w8)
    ref = np.asarray(codes).astype(np.int32) @ np.asarray(w8).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(got), ref.astype(np.float32))

    # fp-weight variant stays exact too (±1 exactly representable)
    wf = jnp.asarray(RNG.normal(size=(k, n)).astype(np.float32))
    g2 = shard_map(
        functools.partial(cm.allgather_matmul_b1, axis_name="model"),
        mesh=mesh,
        in_specs=(P("model", None), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )(codes, wf)
    np.testing.assert_allclose(
        np.asarray(g2),
        np.asarray(codes).astype(np.float32) @ np.asarray(wf),
        rtol=1e-5, atol=1e-5,
    )
