"""Packed-kernel parity tests (SURVEY.md §4 implication 2a): packed GEMMs
must match the fake-quant XLA path bit-exactly (int paths) / to bf16 ulp
(log path). On the CPU the wrappers run their plain XLA forms; the Triton
kernels themselves are checked in the Pallas interpreter
(tests/test_gpu_kernels.py)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pytorch_quantize_impls_tpu.kernels  # noqa: F401  (package init)

bg = sys.modules["pytorch_quantize_impls_tpu.kernels.xnor_gemm"]
pm = sys.modules["pytorch_quantize_impls_tpu.kernels.packed_matmul"]
sm = sys.modules["pytorch_quantize_impls_tpu.kernels.shift_matmul"]
from pytorch_quantize_impls_tpu import ops
from pytorch_quantize_impls_tpu.kernels.conv import pack_conv_weights, packed_conv2d
from pytorch_quantize_impls_tpu.ops import pack as packlib

RNG = np.random.default_rng(0)


def _rand(*shape):
    return RNG.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(64, 128, 128), (33, 300, 130), (128, 2100, 256)])
def test_binary_gemm_parity(m, k, n):
    x = jnp.asarray(_rand(m, k))
    w = jnp.asarray(_rand(k, n))
    xi = bg.binarize_to_int8(x)
    wp = bg.pack_binary_weights(w)
    alpha = jnp.abs(w).mean(0)
    got = bg.binary_gemm(xi, wp, alpha)
    ref = bg.binary_gemm_reference(xi, wp, alpha)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6)
    # and against the direct sign matmul (the fake-quant path)
    direct = ops.safe_sign(x) @ ops.safe_sign(w) * alpha[None, :]
    np.testing.assert_allclose(np.asarray(got), np.asarray(direct), rtol=1e-5)


def test_binary_gemm_row_scale():
    x, w = jnp.asarray(_rand(32, 256)), jnp.asarray(_rand(256, 128))
    xi, wp = bg.binarize_to_int8(x), bg.pack_binary_weights(w)
    alpha = jnp.abs(w).mean(0)
    row = jnp.abs(x).mean(1)
    got = bg.binary_gemm(xi, wp, alpha, row)
    ref = bg.binary_gemm_reference(xi, wp, alpha, row)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6)


def test_decode_and_decoded_gemm():
    x, w = jnp.asarray(_rand(16, 2048)), jnp.asarray(_rand(2048, 256))
    wp = bg.pack_binary_weights(w)
    w8 = bg.decode_binary_weights(wp)
    np.testing.assert_array_equal(
        np.asarray(w8[:2048]), np.asarray(ops.safe_sign(w)).astype(np.int8)
    )
    xi = bg.binarize_to_int8(x)
    out = bg.binary_gemm_decoded(xi, w8, out_dtype=jnp.float32)
    direct = ops.safe_sign(x) @ ops.safe_sign(w)
    np.testing.assert_allclose(np.asarray(out[:, :256]), np.asarray(direct), rtol=1e-5)


@pytest.mark.parametrize("m,k,n", [(64, 128, 128), (33, 300, 130), (130, 2100, 257)])
def test_int8_gemm_parity(m, k, n):
    from pytorch_quantize_impls_tpu.kernels import int8_matmul as im

    x = jnp.asarray(RNG.integers(-127, 127, size=(m, k)).astype(np.int8))
    w = jnp.asarray(RNG.integers(-127, 127, size=(k, n)).astype(np.int8))
    alpha = jnp.asarray(_rand(n))
    row = jnp.asarray(_rand(m))
    got = im.int8_gemm(x, w, alpha, row)
    ref = im.int8_gemm_reference(x, w, alpha, row)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6)
    # no-scale variant is integer-exact
    got2 = im.int8_gemm(x, w)
    ref2 = im.int8_gemm_reference(x, w)
    np.testing.assert_array_equal(np.asarray(got2), np.asarray(ref2))


@pytest.mark.parametrize("w_bits,a_bits", [(2, 2), (4, 4), (4, 7)])
def test_dorefa_gemm_parity(w_bits, a_bits):
    m, k, n = 48, 600, 128
    w = jnp.asarray(_rand(k, n))
    x = jnp.asarray(np.abs(_rand(m, k)))  # post-ReLU style
    wq = ops.dorefa_weight(w, w_bits)
    aq = ops.dorefa_activation(x, a_bits)
    wp = pm.pack_dorefa_weights(wq, w_bits)
    codes = pm.dorefa_act_to_int8(aq, a_bits)
    got = pm.dorefa_gemm(codes, wp, w_bits=w_bits, a_bits=a_bits)
    fake = aq @ wq  # the fake-quant path
    np.testing.assert_allclose(np.asarray(got), np.asarray(fake), rtol=1e-4, atol=1e-4)
    ref = pm.dorefa_gemm_reference(codes, wp, w_bits=w_bits, a_bits=a_bits)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_dorefa_decode_and_decoded_gemm():
    w_bits, a_bits = 4, 4
    k, n = 2048, 256
    w = jnp.asarray(_rand(k, n))
    x = jnp.asarray(np.abs(_rand(16, k)))
    wq = ops.dorefa_weight(w, w_bits)
    wp = pm.pack_dorefa_weights(wq, w_bits)
    d = pm.decode_dorefa_weights(wp, w_bits=w_bits)
    # centered codes reconstruct the fake-quant grid exactly
    n_w = 2**w_bits - 1
    np.testing.assert_allclose(
        np.asarray(d[:k].astype(jnp.float32) / n_w), np.asarray(wq), atol=1e-6
    )
    aq = ops.dorefa_activation(x, a_bits)
    codes = pm.dorefa_act_to_int8(aq, a_bits)
    out = pm.dorefa_gemm_decoded(codes, d, w_bits=w_bits, a_bits=a_bits)
    fake = aq @ wq
    np.testing.assert_allclose(
        np.asarray(out[:, :n]), np.asarray(fake), rtol=1e-4, atol=1e-4
    )


def test_dorefa_w8_rejected():
    with pytest.raises(ValueError, match="w_bits=8"):
        pm.pack_dorefa_weights(jnp.ones((32, 8)), 8)


@pytest.mark.parametrize("fsr,bits", [(1.0, 4), (0.0, 3)])
def test_shift_gemm_parity(fsr, bits):
    m, k, n = 32, 384, 128
    w = jnp.asarray(_rand(k, n))
    x = jnp.asarray(_rand(m, k))
    wp = sm.pack_log_weights(w, fsr, bits)
    got = sm.shift_gemm(x, wp, fsr=fsr, bits=bits)
    ref = sm.shift_gemm_reference(x, wp, fsr=fsr, bits=bits)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # vs fake-quant in bf16 arithmetic
    fake = jnp.dot(
        x.astype(jnp.bfloat16),
        ops.log_quant(w, fsr, bits).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(fake), rtol=2e-2, atol=2e-2)


def test_log_decode_and_decoded_gemm():
    fsr, bits = 1.0, 4
    k, n = 1024, 256
    w = jnp.asarray(_rand(k, n))
    x = jnp.asarray(_rand(16, k))
    wp = sm.pack_log_weights(w, fsr, bits)
    wb = sm.decode_log_weights(wp, fsr=fsr, bits=bits)
    # decode assembles exact ±2^e bit patterns; ops.log_quant computes
    # 2.0**e in f32 which rounds 1 ulp off for deep-negative exponents —
    # the kernel is the *more* exact side, so compare with 1-ulp tolerance
    np.testing.assert_allclose(
        np.asarray(wb[:k].astype(jnp.float32)),
        np.asarray(ops.log_quant(w, fsr, bits)),
        rtol=1e-6,
    )
    out = sm.shift_gemm_decoded(x, wb)
    ref = sm.shift_gemm_reference(x, wp, fsr=fsr, bits=bits)
    np.testing.assert_allclose(
        np.asarray(out[:, :n]), np.asarray(ref), rtol=1e-5, atol=1e-5
    )


def test_grouped_planar_roundtrip_tiled():
    """The layout bug regression: decode of a K-tile must not need global
    context (K spanning multiple tiles AND multiple groups)."""
    for bits in (1, 2, 4, 8):
        gk = packlib.planar_group_k(bits)
        k, n = 3 * gk + 7, 16
        codes = RNG.integers(0, 2**bits, size=(k, n))
        p = packlib.pack_bitplanes(jnp.asarray(codes), bits)
        got = packlib.unpack_bitplanes(p, bits, k)
        np.testing.assert_array_equal(np.asarray(got), codes)


def test_packed_conv_binary_parity():
    x = jnp.asarray(_rand(2, 10, 10, 8))
    w = jnp.asarray(_rand(3, 3, 8, 16))
    pw = pack_conv_weights(w, "xnor")
    got = packed_conv2d(x, pw, padding="SAME")
    # reference: conv of sign(x) with alpha*sign(w)
    ref = jax.lax.conv_general_dilated(
        ops.safe_sign(x),
        ops.safe_sign(w),
        (1, 1),
        "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST,
    ) * jnp.mean(jnp.abs(w), axis=(0, 1, 2))[None, None, None, :]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_packed_conv_dorefa_parity():
    x = jnp.asarray(np.abs(_rand(2, 8, 8, 8)))
    w = jnp.asarray(_rand(3, 3, 8, 16))
    wq = ops.dorefa_weight(w, 4)
    aq = ops.dorefa_activation(x, 4)
    pw = pack_conv_weights(wq, "dorefa", w_bits=4, a_bits=4)
    got = packed_conv2d(aq, pw, padding="SAME")
    ref = jax.lax.conv_general_dilated(
        aq, wq, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST,
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-3, atol=1e-3)


def test_packed_conv_strides():
    """Strided VALID conv against the fake-quant conv of sign(x), sign(w)."""
    x = jnp.asarray(_rand(1, 12, 12, 4))
    w = jnp.asarray(_rand(3, 3, 4, 8))
    pw = pack_conv_weights(w, "binary")
    got = packed_conv2d(x, pw, strides=(2, 2), padding="VALID")
    assert got.shape == (1, 5, 5, 8)
    ref = jax.lax.conv_general_dilated(
        ops.safe_sign(x), ops.safe_sign(w), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_decode_binary_weights_partial_k_tile():
    """Regression: K that is not a multiple of 2048 (K=2304) must decode
    every row (an earlier tiled decode dropped the last partial tile)."""
    from pytorch_quantize_impls_tpu.kernels.xnor_gemm import (
        decode_binary_weights, pack_binary_weights,
    )

    w = jnp.asarray(_rand(2304, 256))
    dec = decode_binary_weights(pack_binary_weights(w))[:2304]
    ref = jnp.where(w >= 0, 1, -1).astype(jnp.int8)
    np.testing.assert_array_equal(np.asarray(dec), np.asarray(ref))


def test_packed_conv_log_parity_direct():
    """Log-scheme conv through the direct (decoded bf16 XLA conv) mode."""
    from pytorch_quantize_impls_tpu.ops.log_lin import log_quant

    x = jnp.asarray(_rand(2, 8, 8, 8))
    w = jnp.asarray(_rand(3, 3, 8, 16))
    pw = pack_conv_weights(w, "log", w_bits=4, fsr=1.0)
    got = packed_conv2d(x, pw, padding="SAME")
    ref = jax.lax.conv_general_dilated(
        x.astype(jnp.bfloat16),
        log_quant(w, fsr=1.0, bits=4).astype(jnp.bfloat16),
        (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), rtol=2e-2, atol=2e-2
    )


def test_decode_attention_matches_dequant_reference():
    """One-pass int8-cache attention (kernels/decode_attention.py): folding
    the per-(position, head) dequant scales into the score/attention
    vectors must match the materialize-then-einsum reference, including the
    per-slot cursor mask."""
    from pytorch_quantize_impls_tpu.kernels.decode_attention import (
        decode_attention,
    )

    b, h, cl, hd = 3, 4, 64, 32
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(b, h, hd)), jnp.float32)
    kc = jnp.asarray(rng.integers(-127, 128, (b, h, cl, hd)), jnp.int8)
    vc = jnp.asarray(rng.integers(-127, 128, (b, h, cl, hd)), jnp.int8)
    ks = jnp.asarray(rng.uniform(0.01, 0.1, (b, h, cl)), jnp.float32)
    vs = jnp.asarray(rng.uniform(0.01, 0.1, (b, h, cl)), jnp.float32)
    lens = jnp.asarray([5, 30, 64])
    bias = jnp.where(
        jnp.arange(cl)[None, :] < lens[:, None], 0.0, -1e30
    ).astype(jnp.float32)
    got = decode_attention(q, kc, ks, vc, vs, bias)

    kf = kc.astype(jnp.float32) * ks[..., None]
    vf = vc.astype(jnp.float32) * vs[..., None]
    hi = jax.lax.Precision.HIGHEST
    s = jnp.einsum("bhd,bhkd->bhk", q, kf, precision=hi) / np.sqrt(hd)
    a = jax.nn.softmax(s + bias[:, None, :], -1)
    ref = jnp.einsum("bhk,bhkd->bhd", a, vf, precision=hi)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-5
    )
