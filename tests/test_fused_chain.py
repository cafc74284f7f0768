"""Parity tests for the fused int8-chained serving path (VERDICT r3 #3).

The fused chain folds BN + next-layer binarization into a per-channel
threshold on the raw conv accumulator and carries activations as ±1 int8.
Gate: full-model logits match the fake-quant model (the behavioral spec —
SURVEY.md §3.5 seam rule) to fp tolerance; the int8-input stages are exact
integer arithmetic, so any disagreement localizes to the (measure-zero)
threshold boundary or the final affine's f32 expression order.
"""

import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu import infer, models

KEY = jax.random.PRNGKey(0)


def _trained_variables(model, x, steps=0):
    """Init + (optionally) perturb batch stats so BN affine is nontrivial."""
    v = model.init({"params": KEY}, x[:1], train=False)
    # nontrivial BN: random running stats and scale/bias (incl. negative γ)
    # Deterministic digest (NOT hash(): that is per-process randomized via
    # PYTHONHASHSEED, which made the jittered stats — and hence whether any
    # pre-round value lands on an f32 round-half boundary — vary run to run).
    def jitter(path, leaf):
        name = jax.tree_util.keystr(path)
        k = jax.random.fold_in(KEY, zlib.crc32(name.encode()) % (2**31))
        if "batch_stats" in name and "mean" in name:
            return jax.random.normal(k, leaf.shape) * 0.5
        if "batch_stats" in name and "var" in name:
            return jnp.abs(jax.random.normal(k, leaf.shape)) * 2 + 0.1
        if "/bn" in name and "scale" in name:
            return jax.random.normal(k, leaf.shape)  # some γ < 0
        if "/bn" in name and "bias" in name:
            return jax.random.normal(k, leaf.shape) * 0.3
        return leaf

    return jax.tree_util.tree_map_with_path(jitter, v)


def _assert_logits_match(got, ref, rtol=2e-4, atol=2e-4):
    """Parity gate, tolerant to isolated round-half boundary flips.

    The int8-code stages are exact integer arithmetic; the only legitimate
    deviation channel is a pre-round value sitting within f32-accumulation
    noise of a round-half boundary (the fused path evaluates the affine in a
    different f32 expression order than the fake-quant model). Such a flip
    moves ONE code by ONE level and shifts a few logits ~1e-2. So: strict
    allclose first; on failure accept iff ≥99% of logits are within
    tolerance AND every sample's argmax agrees — anything broader than an
    isolated boundary flip still fails.
    """
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref) - (atol + rtol * np.abs(ref))
    if (err <= 0).all():
        return
    frac_bad = float((err > 0).mean())
    assert frac_bad <= 0.01 and (got.argmax(-1) == ref.argmax(-1)).all(), (
        f"fused/fake-quant mismatch beyond boundary noise: {frac_bad:.1%} of "
        f"logits out of tolerance, max err {float(err.max()):.3e}"
    )


@pytest.mark.parametrize("fp32_first_last", [False, True])
def test_fused_chain_matches_fake_quant(fp32_first_last):
    model = models.XNORConvNet(
        widths=(16, 16, 32, 32),
        binarize_inputs=True,
        use_input_scale_map=False,
        fp32_first_last=fp32_first_last,
    )
    x = jax.random.normal(jax.random.PRNGKey(3), (4, 16, 16, 3))
    v = _trained_variables(model, x)
    ref = model.apply(v, x, train=False)
    chain = infer.export_fused_chain(model, v, first_dtype=jnp.float32)
    got = infer.fused_apply(chain, x)
    assert got.shape == ref.shape
    _assert_logits_match(got, ref)


def test_fused_chain_hidden_activations_are_int8():
    model = models.XNORConvNet(
        widths=(16, 16), binarize_inputs=True, use_input_scale_map=False
    )
    x = jax.random.normal(jax.random.PRNGKey(4), (2, 8, 8, 3))
    v = _trained_variables(model, x)
    chain = infer.export_fused_chain(model, v)
    # hidden stage weights are int8 code planes; first stage is fp compute
    assert chain.stages[0].w.dtype != jnp.int8 or not chain.stages[0].in_codes
    assert chain.stages[1].w.dtype == jnp.int8 and chain.stages[1].in_codes


def test_fused_chain_requires_k_map_off():
    model = models.XNORConvNet(widths=(8, 8), binarize_inputs=True)
    x = jax.random.normal(jax.random.PRNGKey(5), (1, 8, 8, 3))
    v = model.init({"params": KEY}, x, train=False)
    with pytest.raises(ValueError, match="use_input_scale_map"):
        infer.export_fused_chain(model, v)


def test_fused_chain_pool_commutes_with_negative_gamma():
    """pool(sign(BN(y))) == sign(pool(BN(y))) even when γ < 0 — the flip is
    inside the per-element code, so max over codes is still correct."""
    model = models.XNORConvNet(
        widths=(8, 8, 8), binarize_inputs=True, use_input_scale_map=False
    )
    x = jax.random.normal(jax.random.PRNGKey(6), (2, 8, 8, 1))
    v = _trained_variables(model, x)
    # force every γ in bn1 negative (stage 1 has pool=True)
    v = jax.tree_util.tree_map(lambda a: a, v)
    import flax

    v = flax.core.unfreeze(v) if hasattr(flax.core, "unfreeze") else dict(v)
    v["params"]["bn1"]["scale"] = -jnp.abs(v["params"]["bn1"]["scale"]) - 0.1
    ref = model.apply(v, x, train=False)
    chain = infer.export_fused_chain(model, v, first_dtype=jnp.float32)
    got = infer.fused_apply(chain, x)
    _assert_logits_match(got, ref)


def test_fused_resnet_matches_fake_quant():
    """DoReFa ResNet fused chain (r4): BN+relu+act-quant folded into an
    affine+round+clip on the int32 conv accumulator; codes cross layers as
    int8, real values materialize only at residual junctions. Logits must
    match the fake-quant model to fp tolerance."""
    model = models.DorefaResNet20(w_bits=4, a_bits=4, width=8)
    x = jax.random.normal(jax.random.PRNGKey(7), (4, 16, 16, 3))
    v = _trained_variables(model, x)
    ref = model.apply(v, x, train=False)
    net = infer.export_fused_resnet20(model, v, first_dtype=jnp.float32)
    got = infer.fused_resnet_apply(net, x)
    assert got.shape == ref.shape
    _assert_logits_match(got, ref)


def test_fused_resnet_w2a2_and_codes_dtype():
    model = models.DorefaResNet20(w_bits=2, a_bits=2, width=8)
    x = jax.random.normal(jax.random.PRNGKey(8), (2, 16, 16, 3))
    v = _trained_variables(model, x)
    ref = model.apply(v, x, train=False)
    net = infer.export_fused_resnet20(model, v, first_dtype=jnp.float32)
    got = infer.fused_resnet_apply(net, x)
    _assert_logits_match(got, ref)
    assert net.blocks[0].w1.dtype == jnp.int8


def test_fused_lenet_matches_fake_quant():
    """BNN LeNet fused chain (BASELINE config 2): VALID-pad convs + binary
    dense trunk, every hidden boundary folded to threshold codes; the
    conv->dense seam flattens int8 code maps."""
    model = models.BNNLeNet(width=8)
    x = jax.random.normal(jax.random.PRNGKey(9), (4, 28, 28, 1))
    v = _trained_variables(model, x)
    ref = model.apply(v, x, train=False)
    chain = infer.export_fused_lenet(model, v, first_dtype=jnp.float32)
    got = infer.fused_apply(chain, x)
    assert got.shape == ref.shape
    _assert_logits_match(got, ref)
    assert chain.stages[1].w.dtype == jnp.int8  # conv2 runs as an int8 conv
    assert chain.stages[2].dense and chain.stages[2].w.dtype == jnp.int8
