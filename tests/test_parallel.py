"""Sharding/collective tests on the 8-device virtual CPU mesh (SURVEY.md §4:
the "fake backend" — same mesh code as on real cards)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pytorch_quantize_impls_tpu import models, parallel, train

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _make_state(model, x, sgd=False):
    variables = model.init({"params": jax.random.PRNGKey(0)}, x)
    # SGD for bit-exactness tests: Adam's rsqrt amplifies the (benign)
    # reduction-order float noise of the 8-way DP psum.
    opt = optax.sgd(0.1) if sgd else optax.adam(1e-3)
    tx = optax.chain(opt, train.clip_quantized_weights())
    return train.QuantTrainState.create_for(model, variables, tx)


def test_mesh_shapes():
    mesh = parallel.make_mesh()
    assert mesh.devices.size == len(jax.devices())
    mesh2 = parallel.make_mesh((4, 2))
    assert mesh2.axis_names == (parallel.DATA_AXIS, parallel.MODEL_AXIS)
    with pytest.raises(ValueError):
        parallel.make_mesh((3, 2))


def test_dp_train_step_matches_single_device():
    """The sharded step must compute the same numbers as the local step."""
    model = models.MLP(features=(32, 10), layer="bin")
    x = np.random.default_rng(0).normal(size=(16, 64)).astype(np.float32)
    y = (np.arange(16) % 10).astype(np.int32)

    state_local = _make_state(model, jnp.asarray(x[:1]), sgd=True)
    step_local = train.make_train_step(donate=False)
    sl, ml = step_local(state_local, (jnp.asarray(x), jnp.asarray(y)))

    mesh = parallel.make_mesh((8, 1))
    state = _make_state(model, jnp.asarray(x[:1]), sgd=True)
    state, step = parallel.make_sharded_train_step(state, mesh)
    xb, yb = parallel.shard_batch((x, y), mesh)
    ss, ms = step(state, (xb, yb))

    np.testing.assert_allclose(float(ml["loss"]), float(ms["loss"]), rtol=1e-5)
    for (pl_, a), (_, b) in zip(
        jax.tree_util.tree_flatten_with_path(sl.params)[0],
        jax.tree_util.tree_flatten_with_path(ss.params)[0],
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5), pl_


def test_tp_sharding_placement():
    model = models.MLP(features=(64, 10), layer="dorefa", bits=4)
    mesh = parallel.make_mesh((4, 2))
    state = _make_state(model, jnp.ones((1, 32)))
    sharded, shardings = parallel.shard_train_state(state, mesh)
    k = sharded.params["layer0"]["dense"]["kernel"]
    # out-features sharded 2-way over model axis
    assert k.sharding.spec == jax.sharding.PartitionSpec(None, parallel.MODEL_AXIS)
    db = k.sharding.shard_shape(k.shape)
    assert db[1] == k.shape[1] // 2


def test_dp_tp_train_step_runs_and_matches():
    model = models.MLP(features=(64, 10), layer="bin")
    x = np.random.default_rng(1).normal(size=(16, 32)).astype(np.float32)
    y = (np.arange(16) % 10).astype(np.int32)

    state_local = _make_state(model, jnp.asarray(x[:1]))
    step_local = train.make_train_step(donate=False)
    _, ml = step_local(state_local, (jnp.asarray(x), jnp.asarray(y)))

    mesh = parallel.make_mesh((4, 2))
    state = _make_state(model, jnp.asarray(x[:1]))
    state, step = parallel.make_sharded_train_step(state, mesh)
    xb, yb = parallel.shard_batch((x, y), mesh)
    ss, ms = step(state, (xb, yb))
    np.testing.assert_allclose(float(ml["loss"]), float(ms["loss"]), rtol=1e-5)


def test_graft_entry_dryrun():
    import importlib.util, pathlib

    spec = importlib.util.spec_from_file_location(
        "graft_entry", pathlib.Path(__file__).parent.parent / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fwd, args = mod.entry()
    out = jax.jit(fwd)(*args)
    assert out.shape == (8, 10)
    mod.dryrun_multichip(8)


def test_stochastic_quant_deterministic_across_mesh():
    """SURVEY.md §7 hard-part 3: stochastic quantizers must draw IDENTICAL
    samples on every device (key folded from host-invariant step), so
    replicated params stay bit-identical under DP."""
    import numpy as np
    import optax
    from pytorch_quantize_impls_tpu import models, train

    mesh = parallel.make_mesh((8, 1))
    model = models.BinaryConnectMLP(hidden=16, deterministic=False)
    x = np.random.default_rng(0).normal(size=(16, 784)).astype(np.float32)
    y = (np.arange(16) % 10).astype(np.int32)
    rngs = {"params": jax.random.PRNGKey(0), "quant": jax.random.PRNGKey(1)}
    variables = model.init(rngs, jnp.asarray(x[:1]), train=True)
    tx = optax.chain(optax.adam(1e-3), train.clip_quantized_weights())
    state = train.QuantTrainState.create_for(model, variables, tx, seed=3)
    state, step = parallel.make_sharded_train_step(
        state, mesh, has_quant_rng=True
    )
    batch = parallel.shard_batch((x, y), mesh)
    for _ in range(3):
        state, m = step(state, batch)
    # params are replicated: every device's copy must be bit-identical
    for leaf in jax.tree_util.tree_leaves(state.params):
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        for s in shards[1:]:
            np.testing.assert_array_equal(s, shards[0])
    assert np.isfinite(float(m["loss"]))
