"""The Triton-route kernels and the choice between kernel and plain form.

The kernels run here in the Pallas interpreter against the plain
references; the same kernels compiled for the card run in the tests marked
``gpu`` (``python -m pytest -m gpu tests/`` on a machine with one).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_quantize_impls_tpu.kernels import common

bg = importlib.import_module("pytorch_quantize_impls_tpu.kernels.xnor_gemm")
da = importlib.import_module("pytorch_quantize_impls_tpu.kernels.decode_attention")

RNG = np.random.default_rng(7)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, never
    at import, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: compiled Triton kernels have no CPU lowering")


def _binary_case(m, k, n):
    x = jnp.asarray(RNG.choice(np.array([-1, 1], np.int8), (m, k)))
    w = bg.pack_binary_weights(jnp.asarray(RNG.normal(size=(k, n)), jnp.float32))
    alpha = jnp.asarray(RNG.uniform(0.5, 1.5, n), jnp.float32)
    row = jnp.asarray(RNG.uniform(0.5, 1.5, m), jnp.float32)
    return x, w, alpha, row


def _kernel_gemm(x, w, alpha=None, row=None):
    """The Triton kernel in the interpreter, with the wrapper's epilogue."""
    acc = bg._binary_gemm_triton(x, w, interpret=True)
    return common.scale_epilogue(acc, alpha, row)


def _attention_case(b, h, cl, hd, lens):
    q = jnp.asarray(RNG.normal(size=(b, h, hd)), jnp.float32)
    kc = jnp.asarray(RNG.integers(-127, 128, (b, h, cl, hd)), jnp.int8)
    vc = jnp.asarray(RNG.integers(-127, 128, (b, h, cl, hd)), jnp.int8)
    ks = jnp.asarray(RNG.uniform(0.01, 0.1, (b, h, cl)), jnp.float32)
    vs = jnp.asarray(RNG.uniform(0.01, 0.1, (b, h, cl)), jnp.float32)
    bias = jnp.where(
        jnp.arange(cl)[None, :] < jnp.asarray(lens)[:, None], 0.0, -1e30
    ).astype(jnp.float32)
    return q, kc, ks, vc, vs, bias


@pytest.mark.parametrize("n", [64, 200])
@pytest.mark.parametrize("k", [1024, 2048])
@pytest.mark.parametrize("m", [1, 5, 16, 33])
def test_binary_decode_gemm_interpret(m, k, n):
    """Bit-exact against the f32 reference, with and without alpha and the
    row scale (integer sums, identical epilogue order)."""
    x, w, alpha, row = _binary_case(m, k, n)
    for a, r in ((None, None), (alpha, row)):
        got = _kernel_gemm(x, w, a, r)
        ref = bg.binary_gemm_reference(x, w, a, r)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_binary_decode_gemm_pads_k_m_n():
    """Unpadded K (1000 of a 1024-row group), M below the Triton floor of
    16 and N off the 32-column strip are all padded inside the wrapper."""
    m, k, n = 3, 1000, 70
    x, w, alpha, _ = _binary_case(m, k, n)
    assert w.shape == (32, n)  # K packed up to one 1024-row group
    got = _kernel_gemm(x, w, alpha)
    assert got.shape == (m, n)
    ref = bg.binary_gemm_reference(x, w, alpha)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_binary_decode_gemm_k_split():
    """Several 1024-row groups split over programs sum to the same result:
    K=4096, N=64 gives 2 column strips, so the K groups are split."""
    assert bg._n_splits(4, 2) == 4
    assert bg._n_splits(4, 200) == 1  # strips alone fill the card
    assert bg._n_splits(3, 100) == 1  # only divisors of the group count
    x, w, _, row = _binary_case(8, 4096, 64)
    got = _kernel_gemm(x, w, None, row)
    ref = bg.binary_gemm_reference(x, w, None, row)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize(
    "b,h,cl,hd,splits,lens",
    [
        (3, 4, 64, 32, 1, [5, 30, 64]),
        (3, 4, 64, 32, 4, [1, 17, 63]),  # splits with no valid row
        (2, 2, 256, 16, 2, [200, 256]),
        (2, 2, 256, 16, 8, [1, 129]),
        (1, 8, 96, 64, 2, [96]),  # cl not a power of two
    ],
)
def test_split_attention_interpret(b, h, cl, hd, splits, lens):
    args = _attention_case(b, h, cl, hd, lens)
    got = da._decode_attention_triton(*args, splits=splits, interpret=True)
    ref = da.decode_attention_plain(*args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_attention_splits_fill_the_card():
    assert da.n_splits(1, 8, 1024) == 16  # 128 programs would idle SMs
    assert da.n_splits(8, 8, 1024) == 8
    assert da.n_splits(32, 8, 1024) == 2
    assert da.n_splits(64, 8, 1024) == 1
    assert da.n_splits(1, 1, 64) == 1  # never below one 64-row block


@pytest.mark.parametrize(
    "backend,expect",
    [("gpu", (True, False, True, False, False)),
     ("cpu", (False, False, False, False, False))],
)
def test_dispatch_follows_platform_and_shape(monkeypatch, backend, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    got = (
        bg.use_kernel(bg.TRITON_MAX_M),
        bg.use_kernel(bg.TRITON_MAX_M + 1),  # past the crossover: plain
        da.use_kernel(1024, 128),
        da.use_kernel(1000, 128),  # cl not a multiple of 16
        da.use_kernel(1024, 96),  # head dim not a power of two
    )
    assert got == expect


def test_dispatch_rejects_other_platforms(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(NotImplementedError, match="not supported"):
        common.platform()
    with pytest.raises(NotImplementedError):
        bg.use_kernel(8)


def test_cpu_runs_the_plain_form(monkeypatch):
    """On the CPU, binary_gemm traces no Pallas call at all; on the GPU the
    same wrapper traces the kernel (a new shape, so a fresh trace)."""
    x, w, alpha, _ = _binary_case(4, 1024, 64)
    jaxpr = str(jax.make_jaxpr(lambda a, b: bg.binary_gemm(a, b, alpha))(x, w))
    assert "pallas_call" not in jaxpr
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    jaxpr_k = str(jax.make_jaxpr(
        lambda a, b: bg.binary_gemm(a, b, alpha))(x[:3], w))
    assert "pallas_call" in jaxpr_k


@pytest.mark.gpu
def test_binary_decode_gemm_compiled(gpu):
    for m, k, n in [(1, 1024, 3072), (bg.TRITON_MAX_M, 4096, 1024)]:
        x, w, alpha, row = _binary_case(m, k, n)
        assert bg.use_kernel(m)
        got = bg.binary_gemm(x, w, alpha, row)
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(bg.binary_gemm_reference(x, w, alpha, row))
        )


@pytest.mark.gpu
def test_split_attention_compiled(gpu):
    args = _attention_case(8, 8, 1024, 128, list(RNG.integers(1, 1025, 8)))
    assert da.use_kernel(1024, 128)
    got = da.decode_attention(*args)
    ref = da.decode_attention_plain(*args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-4)
