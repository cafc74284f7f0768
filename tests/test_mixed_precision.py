"""Mixed-precision (bf16 compute / fp32 masters) across the model zoo.

Rationale: the fake-quant training path's cost is the GEMM; running it in
bfloat16 engages the tensor cores' fast path (SURVEY.md §7 "keep them
large, batched, and bfloat16"). Quantizers always read the fp32 master weights —
only the matmul/conv inputs are cast — so STE math and clamp domains are
unchanged; the loss upcasts logits to fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pytorch_quantize_impls_tpu import models, train


def _leaves_dtypes(params):
    return {leaf.dtype for leaf in jax.tree.leaves(params)}


MODELS = [
    ("binary_mlp", lambda: models.MLP(features=(64, 10), layer="bin",
                                      dtype=jnp.bfloat16), (4, 64)),
    ("bnn_lenet", lambda: models.BNNLeNet(width=8, dtype=jnp.bfloat16),
     (2, 28, 28, 1)),
    ("xnor_convnet", lambda: models.XNORConvNet(widths=(8, 8),
                                                dtype=jnp.bfloat16),
     (2, 16, 16, 3)),
    ("log_vgg", lambda: models.LogQuantVGGSmall(widths=(8, 8),
                                                dtype=jnp.bfloat16),
     (2, 16, 16, 3)),
    ("dorefa_resnet", lambda: models.DorefaResNet20(width=8,
                                                    dtype=jnp.bfloat16),
     (2, 16, 16, 3)),
]

# DorefaResNet20 deliberately keeps its classifier head in fp32 (DoReFa
# practice: full-precision final layer; its FLOPs are negligible), so its
# logits are fp32 even under a bf16 compute dtype.
FP32_HEAD = {"dorefa_resnet"}


@pytest.mark.parametrize("name,build,shape", MODELS, ids=[m[0] for m in MODELS])
def test_bf16_compute_fp32_masters(name, build, shape):
    model = build()
    x = jnp.ones(shape, jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(0)}, x, train=False)
    # Master weights stay fp32 — that is the whole point of the seam.
    assert _leaves_dtypes(variables["params"]) == {jnp.float32.dtype}
    out = model.apply(variables, x, train=False)
    assert out.dtype == (jnp.float32 if name in FP32_HEAD else jnp.bfloat16)
    assert bool(jnp.all(jnp.isfinite(out.astype(jnp.float32))))


def test_elastic_layers_preserve_compute_dtype():
    """ElasticLinear/ElasticConv must cast their fp32 bias to the compute
    dtype — with dtype=bf16 the output stays bf16 (no silent fp32 promote)."""
    from pytorch_quantize_impls_tpu import nn as qnn

    x = jnp.ones((2, 16), jnp.float32)
    lin = qnn.ElasticLinear(features=8, dtype=jnp.bfloat16)
    v = lin.init({"params": jax.random.PRNGKey(0)}, x)
    y, _ = lin.apply(v, x, mutable=["losses"])
    assert y.dtype == jnp.bfloat16

    xc = jnp.ones((2, 8, 8, 3), jnp.float32)
    conv = qnn.ElasticConv(features=4, dtype=jnp.bfloat16)
    vc = conv.init({"params": jax.random.PRNGKey(0)}, xc)
    yc, _ = conv.apply(vc, xc, mutable=["losses"])
    assert yc.dtype == jnp.bfloat16


def test_bf16_training_learns():
    """One bf16-compute model trains end-to-end and reduces loss."""
    model = models.MLP(features=(64, 10), layer="bin", dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 32)).astype(np.float32)
    y = (np.arange(128) % 10).astype(np.int32)

    variables = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:1]))
    tx = optax.chain(optax.adam(1e-2), train.clip_quantized_weights())
    state = train.QuantTrainState.create_for(model, variables, tx)
    step = train.make_train_step()

    losses = []
    for i in range(30):
        state, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[:3] + losses[-3:]
    # loss is computed in fp32 despite bf16 logits
    assert np.isfinite(losses[-1])
    # clamp invariant still holds on the fp32 masters
    kernel = state.params["layer0"]["dense"]["kernel"]
    assert kernel.dtype == jnp.float32
    assert float(jnp.max(jnp.abs(kernel))) <= 1.0 + 1e-6


def test_bf16_matches_fp32_forward_coarsely():
    """bf16 compute is an approximation of the fp32 path, not a different
    function: same params, same input -> outputs within bf16 tolerance."""
    m32 = models.MLP(features=(32, 10), layer="bin")
    m16 = models.MLP(features=(32, 10), layer="bin", dtype=jnp.bfloat16)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 16))
    variables = m32.init({"params": jax.random.PRNGKey(0)}, x, train=False)
    y32 = m32.apply(variables, x, train=False)
    y16 = m16.apply(variables, x, train=False).astype(jnp.float32)
    np.testing.assert_allclose(np.asarray(y32), np.asarray(y16),
                               rtol=0.05, atol=0.15)
