"""chip_smoke.py's phases at tiny sizes, its plain references against the
flax models they stand in for, its refusal to run off the GPU, and the
device and compile-cache plumbing it relies on."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).parent.parent


def _load(name, filename):
    spec = importlib.util.spec_from_file_location(name, ROOT / filename)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke", "chip_smoke.py")

TINY_LM = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=64)


def _same_tree_shapes(a, b):
    sa = jax.tree_util.tree_map(lambda x: tuple(x.shape), a)
    sb = jax.tree_util.tree_map(lambda x: tuple(x.shape), b)
    assert sa == sb


def test_plain_lm_matches_flax_model():
    """The script's flax-free reference is the fake-quant LM: same logits
    as ``QuantTransformerLM`` on the script's seeded parameters."""
    from pytorch_quantize_impls_tpu.models import QuantTransformerLM

    cfg = cs.lm_config(**TINY_LM)
    lm = QuantTransformerLM(**{k: getattr(cfg, k) for k in (
        "vocab", "d_model", "n_heads", "n_layers", "d_ff", "max_len", "scheme",
        "w_bits", "a_bits", "kv_bits")})
    params = cs.make_lm_params(cfg, 0)
    toks = jnp.asarray(np.random.default_rng(0).integers(0, 64, (2, 24)), jnp.int32)
    flax_params = lm.init(jax.random.PRNGKey(0), toks[:, :1], train=False)["params"]
    _same_tree_shapes(params, flax_params)
    # the flax forward without a cache keeps K/V in f32: compare the decode
    # twin, whose cache holds the same int8 codes the reference rebuilds
    md = lm.clone(decode=True)
    with jax.default_matmul_precision("highest"):
        want, _ = md.apply({"params": params}, toks, train=False, mutable=["cache"])
        got = cs.plain_lm_logits(params, toks, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-3)


def test_plain_resnet_matches_flax_model():
    from pytorch_quantize_impls_tpu.models import DorefaResNet20

    cfg = cs.resnet_config(width=4)
    model = DorefaResNet20(w_bits=4, a_bits=4, width=4)
    variables = cs.make_resnet_variables(cfg, 0)
    x = jnp.asarray(np.random.default_rng(1).normal(size=(3, 32, 32, 3)), jnp.float32)
    _same_tree_shapes(variables, model.init(jax.random.PRNGKey(0), x[:1], train=False))
    with jax.default_matmul_precision("highest"):
        want = model.apply(variables, x, train=False)
        got, margin = cs.plain_resnet_logits(variables, x, cfg)
    assert margin.shape == (3,) and np.all((margin >= 0) & (margin <= 0.5))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_phase_kernels_tiny(capsys):
    lm = cs.lm_config(**TINY_LM)
    rates = cs.phase_kernels(
        m_list=(1, 20), gemm_shapes=((1024, 64),), attn_batches=(2,), heads=2,
        cache_len=64, head_dim=16, conv_batch=2, conv_width=4, int8_square=64,
        lm=lm, e2e_batches=(2,), e2e_steps=2, timing_sets=2, interpret=True,
    )
    out = capsys.readouterr().out
    assert out.count("op=binary_gemm") == 2 and "op=decode_attention" in out
    assert out.count("op=conv3x3") == 3 and "exact=True" in out
    assert set(rates[2]) == {"kernels", "plain_gemm", "plain_attention"}
    assert rates[2]["kernels"]["busy_tok_s"] == "not measured"  # no device


def test_phase_decode_tiny(capsys):
    res = cs.phase_decode(cs.lm_config(**TINY_LM), prompt_lens=(3, 9, 17, 30),
                          max_new=5, n_slots=2)
    # 4 requests through 2 slots; every prompt position (prefill) and the 4
    # batch steps per request, all from the engine's own programs
    assert [len(r) for r in res["rel"]] == [3 + 4, 9 + 4, 17 + 4, 30 + 4]
    assert sum(a.size for a in res["agree"]) == 4 * 5
    assert res["parted"] == [] and res["flips"] == []
    assert "requests=4 tokens=20" in capsys.readouterr().out


def test_phase_decode_rejects_a_broken_slot(monkeypatch):
    """Attention that reads nothing for one slot is caught: the engine's
    context signs for that slot overrule the reference far from zero."""
    from pytorch_quantize_impls_tpu.infer import fused_decode as fd

    attend = fd.decode_attention

    def broken(q, *args):
        out = attend(q, *args)
        return out.at[1].set(0.0) if q.shape[0] > 1 else out

    monkeypatch.setattr(fd, "decode_attention", broken)
    with pytest.raises(AssertionError, match="overruled far from zero"):
        cs.phase_decode(cs.lm_config(**TINY_LM), prompt_lens=(3, 9), max_new=5,
                        n_slots=2)


def test_served_rows_checks_the_slot_cursor():
    """A batch step whose slot cursor is not the request's next position
    (a broken slot) is refused."""
    fut = object()
    sites = [("sign", np.ones((1, 16, 4), bool))] * 3
    prefill = np.zeros((1, 16, 8), np.float32)
    step_sites = [("sign", np.ones((2, 1, 4), bool))] * 3
    step = np.zeros((2, 1, 8), np.float32)
    events = [("admit", 1, fut), *sites, ("logits", prefill, np.array([0])),
              *step_sites, ("logits", step, np.array([0, 3]))]  # prompt of 3
    rows, codes = cs.served_rows(events, [fut], [np.arange(3)], max_new=2)
    assert rows[0].shape == (4, 8) and codes[0].shape == (4, 3, 4)
    events[-1] = ("logits", step, np.array([0, 4]))
    with pytest.raises(AssertionError, match="cache cursor 4"):
        cs.served_rows(events, [fut], [np.arange(3)], max_new=2)


def test_reference_with_forced_sign_codes():
    """The reference run with the fused program's own sign decisions gives
    the fused program's logits and overrules nothing; one decision set the
    other way is reported at its position and site, with its margin."""
    from pytorch_quantize_impls_tpu import infer

    cfg = cs.lm_config(**TINY_LM)
    params = cs.make_lm_params(cfg, 0)
    fm = infer.export_fused_decode(cfg, {"params": params})
    toks = jnp.asarray(np.random.default_rng(3).integers(0, 64, (1, 20)), jnp.int32)
    events = []
    with cs.engine_logits(events):
        got, _ = infer.fused_decode.fused_decode_apply(fm, None, toks)
    codes = np.stack([e[1] for e in events if e[0] == "sign"], -2)  # (1, 20, 6, 32)
    assert codes.shape == (1, 20, 3 * cfg.n_layers, cfg.d_model)
    logits, overruled, margin = cs.plain_lm_logits(params, toks, cfg,
                                                   codes=jnp.asarray(codes))
    np.testing.assert_allclose(np.asarray(logits), np.asarray(got), rtol=1e-5, atol=1e-4)
    assert int(np.sum(overruled)) == 0
    # the last layer's ln2 sign of feature 7 at position 11: it feeds no
    # later site and no K/V, so only that position's logits move
    codes[0, 11, 5, 7] ^= True
    logits2, overruled, margin = cs.plain_lm_logits(params, toks, cfg,
                                                    codes=jnp.asarray(codes))
    assert np.argwhere(np.asarray(overruled)).tolist() == [[0, 11, 5]]
    assert 0 < float(margin[0, 11, 5]) <= 1
    moved = np.any(np.asarray(logits2) != np.asarray(logits), -1)[0]
    assert np.nonzero(moved)[0].tolist() == [11]


def test_image_check_spares_only_marked_images():
    ref = np.ones((3, 10))
    got = ref.copy()
    got[1] *= 1.02  # one code step moved image 1
    rel, marked = cs._check_image_logits(got, ref, np.array([0.3, 1e-6, 0.2]))
    assert marked.tolist() == [False, True, False] and rel[1] > cs.IMAGE_TOL
    with pytest.raises(AssertionError, match="unmarked max"):
        cs._check_image_logits(got, ref, np.array([0.3, 0.3, 0.2]))


def test_phase_images_tiny(capsys):
    res = cs.phase_images(cs.resnet_config(width=4), n_requests=6, batch_sizes=(2, 4))
    assert res["logits"].shape == (6, 10)
    assert "requests=6" in capsys.readouterr().out


def test_phase_multi_on_virtual_devices(capsys):
    res = cs.phase_multi(jax.devices()[:4], cfg=cs.resnet_config(width=4),
                         n_requests=8, grad_elems=1000)
    assert res["diff"] <= 1e-3
    assert "devices=4 elems=1000" in capsys.readouterr().out


def test_main_refuses_cpu(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""  # no result line
    assert "needs a GPU" in out.err


def test_bench_refuses_cpu(capsys):
    bench = _load("bench", "bench.py")
    assert bench.main([]) != 0
    assert not any(
        line.startswith("{") for line in capsys.readouterr().out.splitlines()
    )


def test_compile_cache_env_set(monkeypatch, tmp_path):
    from pytorch_quantize_impls_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set here


def test_compile_cache_env_unset(monkeypatch):
    from pytorch_quantize_impls_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        assert got == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_ensure_devices_refuses_too_few_accelerators(monkeypatch):
    graft = _load("graft_entry", "__graft_entry__.py")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [object()])
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        graft._ensure_devices(4)


def test_fused_decode_engine_without_a_model():
    """DecodeEngine serves an exported program with no flax model."""
    from pytorch_quantize_impls_tpu import infer, serve

    cfg = cs.lm_config(**TINY_LM)
    fm = infer.export_fused_decode(cfg, {"params": cs.make_lm_params(cfg, 0)})
    eng = serve.DecodeEngine(None, None, fused=fm, n_slots=2)
    try:
        out = eng.submit(np.arange(5, dtype=np.int32), max_new=3).result(timeout=300)
    finally:
        eng.shutdown()
    assert out.shape == (3,)
    with pytest.raises(ValueError, match="model is required"):
        serve.DecodeEngine(None, None, n_slots=2)
