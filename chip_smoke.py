#!/usr/bin/env python
"""Smoke run of the system's main paths on one GPU (or four, with --chips 4).

    python chip_smoke.py             # one card: phases 1-5 below
    python chip_smoke.py --chips 4   # four cards: the multi-card paths only

Phases, all in this one process (a JAX process holds most of a card's
memory, so a second one could not share it):

1. device and environment: the card, its power limit, the packages the
   program may use, and the compile-cache directory;
2. kernels at real widths: every hand-written kernel on the decode path
   against its plain reference, and its time against the plain XLA form it
   replaces (device time from a profiler trace, so host dispatch is not
   counted); then the decode step's tokens/s with each kernel swapped for
   its plain form, which is what decides whether a kernel stays;
3. the decode server: the 1-bit serving LM (8 layers, d 1024, 8 heads,
   d_ff 4096, vocab 8192, max_len 1024, int8 KV cache) exported with
   ``infer.export_fused_decode(..., weights="packed")`` and served by
   ``serve.DecodeEngine`` answering 8 concurrent requests; the logits and
   sign decisions of the engine's own programs, at every position, are
   compared with a plain float32 forward of the same model;
4. training is not run: the model layer (flax) is not installed on the
   card's machine, and a flax-free model layer is ROADMAP's first design
   item;
5. image serving: DoReFa ResNet-20 (W4A4, width 16) exported with
   ``infer.export_fused_resnet20`` and served by
   ``serve.InferenceEngine.from_fused_resnet`` answering 64 requests,
   compared with a plain float32 fake-quant forward; images whose
   reference met a 4-bit rounding boundary are counted apart.

Weights are random, made from ``--seed``. The plain references are written
here with ``jax.numpy`` at ``Precision.HIGHEST`` and share no code with the
paths they check. Each phase prints one line; any failure raises and the
run exits non-zero. The last line of a successful run is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
The script refuses to run on anything but a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import importlib.metadata
import json
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pytorch_quantize_impls_tpu import infer, parallel, serve  # noqa: E402
from pytorch_quantize_impls_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)
from pytorch_quantize_impls_tpu.utils.profiling import (  # noqa: E402
    PEAKS,
    device_kernels,
    device_time,
)

bg = importlib.import_module("pytorch_quantize_impls_tpu.kernels.xnor_gemm")
da = importlib.import_module("pytorch_quantize_impls_tpu.kernels.decode_attention")
i8 = importlib.import_module("pytorch_quantize_impls_tpu.kernels.int8_matmul")
kconv = importlib.import_module("pytorch_quantize_impls_tpu.kernels.conv")

HI = jax.lax.Precision.HIGHEST
PACKAGES = ("flax", "msgpack", "rich", "pyyaml", "attrs", "orbax-checkpoint",
            "scikit-learn")


# -- shared helpers ----------------------------------------------------------


class CompileStats:
    """Backend compile seconds and persistent-cache hits/misses, as JAX's
    monitoring events report them; ``delta()`` gives the change since the
    last call."""

    def __init__(self):
        self.compile_s = 0.0
        self.hits = 0
        self.misses = 0
        self._last = (0.0, 0, 0)
        jax.monitoring.register_event_duration_secs_listener(self._on_duration)
        jax.monitoring.register_event_listener(self._on_event)

    def _on_duration(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += duration

    def _on_event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def delta(self) -> str:
        now = (self.compile_s, self.hits, self.misses)
        d = [a - b for a, b in zip(now, self._last)]
        self._last = now
        return f"compile_s={d[0]:.2f} cache_hits={d[1]} cache_misses={d[2]}"


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One result line, stamped with the seconds since the script started."""
    print(f"[{phase}] t={time.perf_counter() - _T0:.1f} "
          + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def hlo_kernels(fn, *args) -> str:
    """Custom-call targets and fusion kinds of the compiled program."""
    txt = jax.jit(fn).lower(*args).compile().as_text()
    found = set()
    for line in txt.splitlines():
        if 'custom_call_target="' in line:
            found.add(line.split('custom_call_target="')[1].split('"')[0])
        if "kind=kCustom" in line and "fusion" in line:
            name = line.split("=")[0].strip().lstrip("%").split(".")[0]
            if "gemm" in name or "triton" in name:
                found.add(name)
    return ",".join(sorted(found)) or "none"


# -- the serving LM: configuration, seeded parameters, plain reference --------


def lm_config(**overrides):
    """The repo's serving LM (``scripts/perf_bench.py`` decode section)."""
    cfg = dict(vocab=8192, d_model=1024, n_heads=8, n_layers=8, d_ff=4096,
               max_len=1024, scheme="binary", w_bits=1, a_bits=1, n_experts=0,
               kv_bits=8)
    cfg.update(overrides)
    return types.SimpleNamespace(**cfg)


def make_lm_params(cfg, seed: int):
    """Random f32 parameters in ``QuantTransformerLM``'s layout."""
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff

    def normal(*shape, scale=1.0):
        return jnp.asarray(rng.normal(0.0, scale, shape), jnp.float32)

    def ln():
        return {"scale": jnp.asarray(rng.uniform(0.5, 1.5, d), jnp.float32),
                "bias": normal(d, scale=0.1)}

    params = {
        "embed": {"embedding": normal(cfg.vocab, d)},
        "pos_embed": normal(cfg.max_len, d, scale=0.02),
        "ln_f": ln(),
    }
    for i in range(cfg.n_layers):
        params[f"block{i}"] = {
            "ln1": ln(),
            "attn": {n: {"kernel": normal(d, d)} for n in ("q", "k", "v", "out")},
            "ln2": ln(),
            "ffn_in": {"kernel": normal(d, f), "bias": normal(f, scale=4.0)},
            "ffn_out": {"kernel": normal(f, d), "bias": normal(d, scale=4.0)},
        }
    return params


def _sign(x):
    return jnp.where(x >= 0, 1.0, -1.0)


def _layer_norm(x, p, eps=1e-6):
    mu = jnp.mean(x, -1, keepdims=True)
    var = jnp.mean(jnp.square(x - mu), -1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * p["scale"] + p["bias"]


def _kv_quantize(x, bits=8):
    """Per-(position, head) symmetric int8 K/V codes and scales: codes
    round(x * qmax / amax), values codes * amax / qmax."""
    qmax = 2.0 ** (bits - 1) - 1
    amax = jnp.max(jnp.abs(x), -1)
    codes = jnp.round(x * jnp.where(amax > 0, qmax / amax, 1.0)[..., None])
    return jnp.clip(codes, -qmax, qmax), jnp.where(amax > 0, amax / qmax, 1.0)


SIGN_SITES = ("ln1", "ctx", "ln2")  # the real-valued inputs of a sign, per layer


def plain_lm_logits(params, toks, cfg, *, codes=None):
    """Float32 forward of the 1-bit LM over whole sequences, full causal
    attention, no cache: sign-binarized projection inputs and weights,
    int8 K/V codes, float32 layer norms, softmax and tied head.

    The K/V scales multiply the integer score and context sums, as the
    served program folds them, rather than the dequantized K/V: with
    binary projections the scores reach ~1e3, where dequantizing first
    moves them by ~1e-3 and splits near ties between keys differently.
    Both orders are the same model; only this one lets two float32
    implementations agree position by position.

    ``codes``: (b, s, n_layers * 3, d) bool sign decisions (True is +1), in
    ``SIGN_SITES`` order per layer, to use in place of the forward's own.
    Then the forward also returns, per (b, s, site), how many decisions
    differ from the sign of its own input, and the largest such input's
    |v| over its row's max |v|: how close to zero the overruled inputs
    were. The hidden FFN boundary is not a site: its input is an exact
    integer sum plus a bias, whose sign rounding cannot change."""
    b, s = toks.shape
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    overruled = []

    def mm(a, w):
        return jnp.dot(a, _sign(w), precision=HI)

    def sign(v):
        if codes is None:
            return _sign(v)
        c = codes[:, :, len(overruled)]
        a = jnp.abs(v)
        miss = (v >= 0) != c
        overruled.append((jnp.sum(miss, -1), jnp.max(jnp.where(miss, a, 0.0), -1)
                          / jnp.maximum(jnp.max(a, -1), 1e-30)))
        return jnp.where(c, 1.0, -1.0)

    x = params["embed"]["embedding"][toks] + params["pos_embed"][:s]
    causal = jnp.tril(jnp.ones((s, s), bool))
    for i in range(cfg.n_layers):
        p = params[f"block{i}"]
        a = sign(_layer_norm(x, p["ln1"]))
        q, k, v = (mm(a, p["attn"][n]["kernel"]).reshape(b, s, h, hd)
                   for n in ("q", "k", "v"))
        (kc, ks), (vc, vs) = _kv_quantize(k), _kv_quantize(v)  # (b, s, h, .)
        sc = jnp.einsum("bqhd,bkhd->bhqk", q, kc, precision=HI)
        sc = sc * ks.transpose(0, 2, 1)[:, :, None, :] * hd**-0.5
        att = jax.nn.softmax(jnp.where(causal, sc, -1e30), -1)
        att = att * vs.transpose(0, 2, 1)[:, :, None, :]
        ctx = jnp.einsum("bhqk,bkhd->bqhd", att, vc, precision=HI).reshape(b, s, d)
        x = x + mm(sign(ctx), p["attn"]["out"]["kernel"])
        c = sign(_layer_norm(x, p["ln2"]))
        y1 = mm(c, p["ffn_in"]["kernel"]) + p["ffn_in"]["bias"]
        x = x + mm(_sign(y1), p["ffn_out"]["kernel"]) + p["ffn_out"]["bias"]
    x = _layer_norm(x, params["ln_f"])
    logits = jnp.einsum("bsd,vd->bsv", x, params["embed"]["embedding"], precision=HI)
    if codes is None:
        return logits
    return (logits, jnp.stack([n for n, _ in overruled], -1),
            jnp.stack([m for _, m in overruled], -1))


# -- DoReFa ResNet-20: configuration, seeded variables, plain reference -------


def resnet_config(width=16):
    return types.SimpleNamespace(quantized=True, w_bits=4, a_bits=4, width=width)


def _resnet_plan(width):
    """(block name, features, stride) in ``DorefaResNet20``'s order."""
    return [(f"stage{st}_block{bi}", f, s if bi == 0 else 1)
            for st, (f, s) in enumerate([(width, 1), (2 * width, 2), (4 * width, 2)])
            for bi in range(3)]


def make_resnet_variables(cfg, seed: int, classes: int = 10):
    """Random eval-mode variables in ``DorefaResNet20``'s layout."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return jnp.asarray(rng.normal(0.0, scale, shape), jnp.float32)

    def bn(n):
        return ({"scale": jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32),
                 "bias": normal(n, scale=0.5)},
                {"mean": normal(n, scale=0.5),
                 "var": jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)})

    w = cfg.width
    params, stats = {}, {}
    params["stem"] = {"kernel": normal(3, 3, 3, w, scale=0.3)}
    params["bn_stem"], stats["bn_stem"] = bn(w)
    cin = w
    for name, f, s in _resnet_plan(w):
        bp, bs = {}, {}
        bp["conv1"] = {"conv": {"kernel": normal(3, 3, cin, f)}}
        bp["conv2"] = {"conv": {"kernel": normal(3, 3, f, f)}}
        bp["bn1"], bs["bn1"] = bn(f)
        bp["bn2"], bs["bn2"] = bn(f)
        if s != 1 or cin != f:
            bp["proj"] = {"kernel": normal(1, 1, cin, f, scale=0.3)}
            bp["bn_proj"], bs["bn_proj"] = bn(f)
        params[name], stats[name] = bp, bs
        cin = f
    params["head"] = {"kernel": normal(4 * w, classes, scale=0.3),
                      "bias": normal(classes, scale=0.1)}
    return {"params": params, "batch_stats": stats}


def plain_resnet_logits(variables, x, cfg):
    """Float32 eval-mode fake-quant forward of DoReFa ResNet-20: DoReFa
    k-bit weights and clip[0,1] k-bit conv inputs, BatchNorm on running
    statistics, full-precision stem, projections and head.

    Returns the logits and, per image, the smallest distance of any
    quantized activation from a rounding boundary, in code steps (the
    pre-round value ``clip(a, 0, 1) * n_a`` against ``k + 1/2``)."""
    p, st = variables["params"], variables["batch_stats"]
    n_w, n_a = 2.0 ** cfg.w_bits - 1, 2.0 ** cfg.a_bits - 1
    taps = []

    def conv(a, k, stride):
        return jax.lax.conv_general_dilated(
            a, k, (stride, stride), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=HI)

    def bn(y, name_p, name_s):
        return ((y - name_s["mean"]) / jnp.sqrt(name_s["var"] + 1e-5)
                * name_p["scale"] + name_p["bias"])

    def wq(k):  # DoReFa weight codes 2c - n_w: the weight is code / n_w
        t = jnp.tanh(k)
        t = t / (2.0 * jnp.max(jnp.abs(t))) + 0.5
        return 2.0 * jnp.round(t * n_w) - n_w

    def aq(a):  # DoReFa activation codes c: the activation is c / n_a
        t = jnp.clip(a, 0.0, 1.0) * n_a
        taps.append(jnp.min(jnp.abs(t - jnp.floor(t) - 0.5), axis=(1, 2, 3)))
        return jnp.round(t)

    def qconv(a, k, stride):  # sums of integer codes are exact in float32
        return conv(aq(a), wq(k), stride) / (n_a * n_w)

    r = jax.nn.relu(bn(conv(x, p["stem"]["kernel"], 1), p["bn_stem"], st["bn_stem"]))
    for name, _, s in _resnet_plan(cfg.width):
        bp, bs = p[name], st[name]
        y = qconv(r, bp["conv1"]["conv"]["kernel"], s)
        y = jax.nn.relu(bn(y, bp["bn1"], bs["bn1"]))
        y = bn(qconv(y, bp["conv2"]["conv"]["kernel"], 1), bp["bn2"], bs["bn2"])
        res = r
        if "proj" in bp:
            res = bn(conv(r, bp["proj"]["kernel"], s), bp["bn_proj"], bs["bn_proj"])
        r = jax.nn.relu(y + res)
    pooled = jnp.mean(r, axis=(1, 2))
    logits = jnp.dot(pooled, p["head"]["kernel"], precision=HI) + p["head"]["bias"]
    return logits, jnp.min(jnp.stack(taps), 0)


# Images whose reference met a rounding boundary this close (in code steps)
# may take the neighbouring 4-bit code in another float32 summation order;
# the pre-round values differ by a few ulps (~1e-6 code steps at 15).
BOUNDARY_STEPS = 1e-5
IMAGE_TOL = 1e-3


def _check_image_logits(got, ref, margin):
    """Per-image relative logit errors, and which images are marked: their
    reference has an activation within ``BOUNDARY_STEPS`` of a rounding
    boundary (``margin`` from ``plain_resnet_logits``).

    The integer convolutions are exact and the float32 paths differ by
    summation order, so every unmarked image must agree within
    ``IMAGE_TOL``. A marked image may differ by one code step at one conv
    input, which moves its logits by up to a few percent."""
    rel = _rel_errors(got, ref)
    marked = np.asarray(margin) <= BOUNDARY_STEPS
    if (np.shape(got) != np.shape(ref) or not np.all(np.isfinite(got))
            or np.any(rel[~marked] > IMAGE_TOL)):
        raise AssertionError(
            f"image logits outside tolerance: unmarked max "
            f"{rel[~marked].max(initial=0.0)}, marked {marked.sum()}")
    return rel, marked


def _rel_errors(got, ref):
    """Per-row max |got - ref| over max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref), -1) / np.maximum(np.max(np.abs(ref), -1), 1e-30)


# -- phases ------------------------------------------------------------------


def phase_env(cache_dir: str) -> str:
    """Phase 1: the card, its power limit, packages, compile cache."""
    devs = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    for line in smi.splitlines():
        print(line, flush=True)
    versions = {}
    for pkg in PACKAGES:
        try:
            versions[pkg] = importlib.metadata.version(pkg)
        except importlib.metadata.PackageNotFoundError:
            versions[pkg] = "absent"
    kind = devs[0].device_kind
    if kind not in PEAKS:
        raise RuntimeError(f"no published peaks for device kind {kind!r}")
    emit("env", platform=devs[0].platform, kind=repr(kind), count=len(devs),
         card=repr(smi.splitlines()[0]), jax=jax.__version__,
         packages=json.dumps(versions, separators=(",", ":")),
         compile_cache=cache_dir)
    return kind


def _binary_operands(rng, m, k, n, count):
    sets = []
    for _ in range(count):
        x = jnp.asarray(rng.choice(np.array([-1, 1], np.int8), (m, k)))
        w = bg.pack_binary_weights(jnp.asarray(rng.normal(size=(k, n)), jnp.float32))
        sets.append((x, w))
    return sets


def _attention_operands(rng, b, h, cl, hd, count):
    sets = []
    for _ in range(count):
        lens = rng.integers(1, cl + 1, b)
        bias = np.where(np.arange(cl)[None] < lens[:, None], 0.0, -1e30)
        sets.append((
            jnp.asarray(rng.normal(size=(b, h, hd)), jnp.float32),
            jnp.asarray(rng.integers(-127, 128, (b, h, cl, hd)), jnp.int8),
            jnp.asarray(rng.uniform(0.01, 0.1, (b, h, cl)), jnp.float32),
            jnp.asarray(rng.integers(-127, 128, (b, h, cl, hd)), jnp.int8),
            jnp.asarray(rng.uniform(0.01, 0.1, (b, h, cl)), jnp.float32),
            jnp.asarray(bias, jnp.float32),
        ))
    return sets


def prefill_cache(fm, b: int, *, prompt_len: int, seed: int):
    """A decode cache after a random ``prompt_len`` prefill at batch b, and
    each row's last token."""
    rng = np.random.default_rng(seed)
    toks = jnp.asarray(rng.integers(0, fm.embed.shape[0], (b, prompt_len)), jnp.int32)
    _, st = jax.jit(infer.fused_decode_apply)(fm, None, toks)
    return st["cache"], toks[:, -1]


def decode_rates(fm, cache, tok, *, steps: int):
    """The fused step's steady decode rate: ``steps`` greedy steps chained
    on the device. ``tok_s`` from the host clock (median of three runs after
    a warm-up), ``busy_tok_s`` from the device's busy time in a trace of one
    more run; their ratio is the device's busy share. Also returns the
    trace's kernels per step: name -> (launches, µs)."""

    @jax.jit
    def chain(fm, cache, tok):
        def body(_, carry):
            cache, tok = carry
            logits, st = infer.fused_decode_apply(fm, cache, tok[:, None])
            return st["cache"], jnp.argmax(logits[:, 0], -1).astype(jnp.int32)

        return jax.lax.fori_loop(0, steps, body, (cache, tok))[1]

    jax.block_until_ready(chain(fm, cache, tok))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(fm, cache, tok))
        ts.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as logdir:
        with jax.profiler.trace(logdir):
            jax.block_until_ready(chain(fm, cache, tok))
        kernels = {name: (n / steps, ns / steps / 1e3)
                   for name, (n, ns) in device_kernels(logdir).items()}
    busy = sum(us for _, us in kernels.values()) * steps / 1e6
    b = tok.shape[0]
    return {"tok_s": b * steps / float(np.median(ts)),
            "busy_tok_s": b * steps / busy if busy else "not measured"}, kernels


def _kernel_table(kernels: dict, top: int = 16) -> str:
    """The ``top`` kernels by device time per step, as name:launches:µs."""
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return ",".join(f"{name}:{n:g}:{us:.2f}" for name, (n, us) in rows)


def _us(t: float):
    """Seconds as microseconds, or "not measured" (no device in the trace)."""
    return "not measured" if np.isnan(t) else t * 1e6


def phase_kernels(*, m_list=(1, 8, 32), gemm_shapes=((1024, 3072),
                  (4096, 1024)), attn_batches=(1, 8, 32),
                  heads=8, cache_len=1024, head_dim=128, conv_batch=128,
                  conv_width=16, int8_square=4096, lm=None, e2e_batches=(1, 8, 32),
                  e2e_steps=32, timing_sets=2, seed=0, interpret=False) -> dict:
    """Phase 2: parity of every kernel at real widths, kernel-vs-plain
    device times, int8 GEMM and conv placement, and the decode step's
    tokens/s with each kernel replaced by its plain form. ``interpret``
    runs the kernels in the Pallas interpreter (a CPU rehearsal)."""
    rng = np.random.default_rng(seed)
    out = {}
    # binary GEMM: Triton kernel (M <= TRITON_MAX_M) vs plain int8 dot
    for k, n in gemm_shapes:
        for m in m_list:
            sets = _binary_operands(rng, m, k, n, timing_sets)
            x, w = sets[0]
            alpha = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
            row = jnp.asarray(rng.uniform(0.5, 1.5, m), jnp.float32)
            ref = np.asarray(bg.binary_gemm_reference(x, w, alpha, row))
            kern = functools.partial(bg._binary_gemm_triton, interpret=interpret)
            forms = {"dispatched": bg.binary_gemm(x, w, alpha, row),
                     "kernel": bg.common.scale_epilogue(kern(x, w), alpha, row),
                     "plain": bg.common.scale_epilogue(
                         bg._binary_gemm_plain(x, w), alpha, row)}
            for name, got in forms.items():
                if not np.array_equal(np.asarray(got), ref):
                    raise AssertionError(f"binary_gemm {name} not bit-exact at {(m, k, n)}")
            t_plain = device_time(bg._binary_gemm_plain, sets)
            t_kern = device_time(kern, sets)
            emit("kernel", op="binary_gemm", shape=f"{m}x{k}x{n}", exact=True,
                 kernel_us=_us(t_kern), plain_us=_us(t_plain),
                 dispatch="kernel" if bg.use_kernel(m) else "plain")
    # int8 GEMM (plain XLA): exactness, placement, share of the int8 peak
    peak = PEAKS.get(jax.devices()[0].device_kind, {}).get("int8_ops")
    for m, k, n in [(int8_square,) * 3] + [(mm, k, n) for mm in (8, 32)
                                           for k, n in gemm_shapes[:1]]:
        sets = [(jnp.asarray(rng.integers(-127, 128, (m, k)), jnp.int8),
                 jnp.asarray(rng.integers(-127, 128, (k, n)), jnp.int8))
                for _ in range(2 if m == int8_square else timing_sets)]
        got = np.asarray(i8.int8_gemm(*sets[0]))[:8]  # host check: 8 rows
        ref = np.asarray(sets[0][0][:8], np.int64) @ np.asarray(sets[0][1], np.int64)
        if not np.array_equal(got, ref.astype(np.float32)):
            raise AssertionError(f"int8_gemm not exact at {(m, k, n)}")
        t = device_time(i8.int8_gemm, sets)
        tops = 2 * m * k * n / t
        emit("kernel", op="int8_gemm", shape=f"{m}x{k}x{n}", exact=True,
             us=_us(t), tops=_us(t) if np.isnan(t) else tops / 1e12,
             peak_share=(tops / peak) if peak and not np.isnan(t) else "not measured",
             lowered_to=hlo_kernels(i8.int8_gemm, *sets[0]))
    # decode attention: split-cache Triton kernel vs plain einsum
    for b in attn_batches:
        sets = _attention_operands(rng, b, heads, cache_len, head_dim, timing_sets)
        kern = functools.partial(da._decode_attention_triton, interpret=interpret,
                                 splits=da.n_splits(b, heads, cache_len))
        ref = np.asarray(da.decode_attention_plain(*sets[0])).reshape(-1, head_dim)
        # f32 on both sides, summed in different orders over cl terms
        err = 0.0
        for name, got in (("kernel", kern(*sets[0])),
                          ("dispatched", da.decode_attention(*sets[0]))):
            e = float(np.max(_rel_errors(np.asarray(got).reshape(-1, head_dim), ref)))
            if not e <= 1e-4:
                raise AssertionError(f"decode_attention {name} rel err {e} at b{b}")
            err = max(err, e)
        t_kern = device_time(kern, sets)
        t_plain = device_time(da.decode_attention_plain, sets)
        emit("kernel", op="decode_attention", shape=f"b{b}h{heads}cl{cache_len}hd{head_dim}",
             max_rel_err=err, tol=1e-4, precision="f32 FMA (kernel) / HIGHEST (plain)",
             splits=da.n_splits(b, heads, cache_len), kernel_us=_us(t_kern),
             plain_us=_us(t_plain),
             dispatch="kernel" if da.use_kernel(cache_len, head_dim) else "plain")
    # int8 conv (float32 sums) vs bf16 conv at the ResNet-20 stage shapes
    hw = 32
    for stage, c in enumerate((conv_width, 2 * conv_width, 4 * conv_width)):
        size = hw >> stage
        xi = jnp.asarray(rng.integers(0, 16, (conv_batch, size, size, c)), jnp.int8)
        wi = jnp.asarray(rng.integers(-15, 16, (3, 3, c, c)), jnp.int8)
        conv8 = functools.partial(kconv.int8_conv, strides=(1, 1), padding="SAME")

        def conv_f(a, k, precision=None):
            return jax.lax.conv_general_dilated(
                a, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                preferred_element_type=jnp.float32, precision=precision)

        got = np.asarray(conv8(xi, wi))
        # integer sums below 2^24 are exact in a float32 conv at HIGHEST
        ref = np.asarray(conv_f(xi.astype(jnp.float32), wi.astype(jnp.float32), HI))
        exact = bool(np.array_equal(got, ref))
        txt = jax.jit(conv8).lower(xi, wi).compile().as_text()
        # element types the cuDNN convolution call receives and returns
        cudnn_types = sorted({t for ln in txt.splitlines() if "cudnn$conv" in ln
                              for t in re.findall(r"\b(s8|s32|u8|f32|bf16|f16)\[", ln)})
        t8 = device_time(conv8, [(xi, wi)])
        t16 = device_time(conv_f, [(xi.astype(jnp.bfloat16), wi.astype(jnp.bfloat16))])
        emit("kernel", op="conv3x3", shape=f"{conv_batch}x{size}x{size}x{c}->{c}",
             exact=exact, cudnn_types=",".join(cudnn_types) or "no cudnn call",
             int8_us=_us(t8), bf16_us=_us(t16))
    # end to end: the decode step with each kernel replaced by its plain form
    if lm is not None:
        fm = infer.export_fused_decode(
            lm, {"params": make_lm_params(lm, seed)}, weights="packed")
        plain_gemm = mock.patch.object(bg, "use_kernel", lambda m: False)
        plain_attn = mock.patch.object(da, "use_kernel", lambda cl, hd: False)
        variants = {"kernels": (), "plain_gemm": (plain_gemm,),
                    "plain_attention": (plain_attn,)}
        for b in e2e_batches:
            cache, tok = prefill_cache(fm, b, prompt_len=128, seed=seed)
            rates, kernels = {}, {}
            for name, patches in variants.items():
                jax.clear_caches()  # the wrappers pick a form at trace time
                with contextlib.ExitStack() as stack:
                    for p in patches:
                        stack.enter_context(p)
                    rates[name], kernels[name] = decode_rates(fm, cache, tok,
                                                              steps=e2e_steps)
            emit("decode_step", batch=b, steps=e2e_steps,
                 **{f"{k}_{m}": v for k, r in rates.items() for m, v in r.items()})
            ks = kernels["kernels"]
            emit("decode_step_kernels", batch=b, distinct=len(ks),
                 launches_per_step=sum(n for n, _ in ks.values()),
                 busy_us_per_step=sum(us for _, us in ks.values()),
                 top=_kernel_table(ks))
            out[b] = rates
        jax.clear_caches()
    return out


@contextlib.contextmanager
def engine_logits(events: list):
    """Record what ``serve.DecodeEngine`` computes, in the order it ran:
    ``("admit", slot, future)`` for each admission; for every fused program
    it runs (a request's batch-1 prefill, then each batch step over all
    slots) one ``("sign", decisions)`` per sign site in ``SIGN_SITES``
    order, then ``("logits", logits, cursors)``. The values reach the host
    through ordered debug callbacks inside the engine's own jitted
    programs, so they are the engine's numbers, not a re-run."""
    fd = importlib.import_module("pytorch_quantize_impls_tpu.infer.fused_decode")
    apply, sign, admit = fd.fused_decode_apply, fd._sign_i8, serve.DecodeEngine._admit

    def record(kind):
        return lambda *a: events.append((kind,) + tuple(np.array(x) for x in a))

    def tapped_sign(x):
        jax.debug.callback(record("sign"), x >= 0, ordered=True)
        return sign(x)

    def tapped_apply(fm, cache, toks):
        logits, st = apply(fm, cache, toks)
        cur = (jnp.zeros(toks.shape[:1], jnp.int32) if cache is None
               else cache["pos_index"])
        jax.debug.callback(record("logits"), logits, cur, ordered=True)
        return logits, st

    def tapped_admit(self, req, slot):
        events.append(("admit", slot, req.future))
        return admit(self, req, slot)

    with mock.patch.object(fd, "fused_decode_apply", tapped_apply), \
            mock.patch.object(fd, "_sign_i8", tapped_sign), \
            mock.patch.object(serve.DecodeEngine, "_admit", tapped_admit):
        yield


def served_rows(events, futures, prompts, max_new):
    """Per request, the engine's logits (n, vocab) and sign decisions
    (n, sites, d) at every position it computed: the prompt's positions
    from its prefill, then one row per batch step (the step that consumed
    generated token j gives position L + j). Each step row is checked
    against the slot's cache cursor."""
    req_of = {id(f): i for i, f in enumerate(futures)}
    rows = [[] for _ in prompts]
    codes = [[] for _ in prompts]
    holder, pending, signs = {}, None, []  # slot -> request; admitted, not prefilled
    for ev in events:
        if ev[0] == "admit":
            pending = (ev[1], req_of[id(ev[2])])
        elif ev[0] == "sign":
            signs.append(ev[1])
            continue
        elif pending is not None:  # the admitted request's prefill
            slot, r = pending
            n = len(prompts[r])
            rows[r] = list(ev[1][0, :n])
            codes[r] = list(np.stack(signs, -2)[0, :n])
            holder[slot], pending = r, None
        else:  # one batch step over every slot
            step_codes = np.stack(signs, -2)
            for slot, r in holder.items():
                pos = len(rows[r])
                if pos < len(prompts[r]) + max_new - 1:
                    if ev[2][slot] != pos:
                        raise AssertionError(
                            f"request {r} in slot {slot}: cache cursor "
                            f"{ev[2][slot]}, expected position {pos}")
                    rows[r].append(ev[1][slot, 0])
                    codes[r].append(step_codes[slot, 0])
        signs = []
    return [np.stack(r) for r in rows], [np.stack(c) for c in codes]


DECODE_TOL = 1e-3
FLIP_MARGIN = 1e-5  # float32 rounding of a sign input, relative to its row


def phase_decode(cfg, *, prompt_lens=(17, 40, 64, 90, 130, 200, 300, 511),
                 max_new=32, n_slots=8, seed=0, timeout_s=900.0) -> dict:
    """Phase 3: the decode server answers concurrent requests; the logits
    and sign decisions its own programs computed (prefill and batch steps,
    every position) are compared, request by request, with the plain
    float32 forward.

    Tolerance: the integer GEMMs are exact and the float32 paths differ by
    summation order, ~1e-6 relative. But a sign input within float32
    rounding of zero can take the other ±1 code, and each later position
    reads that one, so the request parts ways with the plain forward from
    there on. So the check runs the reference with the engine's own sign
    decisions: its logits must agree with the engine's within
    ``DECODE_TOL`` at every position, and every decision that overrules
    the reference's own sign must be at an input within ``FLIP_MARGIN`` of
    zero. A wrong kernel, cache row or cursor changes values far from any
    sign boundary. Against the plain forward, the report gives the share of
    equal tokens and, for each request that parts ways, where and why."""
    t0 = time.perf_counter()
    params = make_lm_params(cfg, seed)
    fm = infer.export_fused_decode(cfg, {"params": params}, weights="packed")
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    events: list = []
    with engine_logits(events):
        eng = serve.DecodeEngine(None, None, fused=fm, n_slots=n_slots)
        try:
            futures = [eng.submit(p, max_new=max_new) for p in prompts]
            gens = [np.asarray(f.result(timeout=timeout_s)) for f in futures]
            stats = eng.stats
        finally:
            eng.shutdown()
    t_serve = time.perf_counter() - t0
    if any(g.shape != (max_new,) for g in gens):
        raise AssertionError(f"short generation: {[g.shape for g in gens]}")
    served, served_codes = served_rows(events, futures, prompts, max_new)

    # references: one forward over prompt + generated tokens, padded to one
    # length (padding after a position cannot change it: causal), once on
    # its own and once with the engine's sign decisions
    total = max(len(p) for p in prompts) + max_new
    seqs = np.zeros((len(prompts), total), np.int32)
    codes = np.zeros((len(prompts), total) + served_codes[0].shape[1:], bool)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        seqs[i, :len(p) + max_new - 1] = np.concatenate([p, g[:-1]])
        codes[i, :len(served_codes[i])] = served_codes[i]
    ref = jax.jit(functools.partial(plain_lm_logits, cfg=cfg))
    plain = np.asarray(ref(params, jnp.asarray(seqs)))
    forced, overruled, margin = (np.asarray(a) for a in ref(
        params, jnp.asarray(seqs), codes=jnp.asarray(codes)))

    rel, agree, parted, flips = [], [], [], []
    for i, (p, g) in enumerate(zip(prompts, gens)):
        n, first_tok = len(p) + max_new - 1, len(p) - 1
        got = served[i]
        if got.shape != (n, cfg.vocab) or not np.all(np.isfinite(got)):
            raise AssertionError(f"request {i}: logits {got.shape}, expected {(n, cfg.vocab)}")
        if not np.array_equal(np.argmax(got[first_tok:], -1), g):
            raise AssertionError(f"request {i}: tokens are not its logits' argmax")
        rel.append(_rel_errors(got, forced[i, :n]))
        for pos, site in zip(*np.nonzero(overruled[i, :n])):
            layer, kind = divmod(int(site), len(SIGN_SITES))
            flips.append({"request": i, "position": int(pos),
                          "site": f"layer{layer}.{SIGN_SITES[kind]}",
                          "signs": int(overruled[i, pos, site]),
                          "margin": float(margin[i, pos, site])})
        r = _rel_errors(got, plain[i, :n])
        agree.append(np.argmax(plain[i, first_tok:n], -1) == g)
        bad = r > DECODE_TOL
        bad[first_tok:] |= ~agree[-1]
        if bad.any():
            pos = int(np.argmax(bad))
            parted.append({"request": i, "prompt_len": len(p), "position": pos,
                           "max_rel_err_before": float(r[:pos].max(initial=0.0)),
                           "flips_there": [f for f in flips if f["request"] == i
                                           and f["position"] == pos]})
    allr = np.concatenate(rel)
    worst = max((f["margin"] for f in flips), default=0.0)
    emit("decode", requests=len(gens), tokens=int(sum(len(g) for g in gens)),
         engine_steps=stats.steps, positions=len(allr), tol=DECODE_TOL,
         precision="HIGHEST", max_rel_err_vs_forced_ref=float(allr.max()),
         median_rel_err_vs_forced_ref=float(np.median(allr)),
         overruled_signs=sum(f["signs"] for f in flips),
         max_overruled_margin=worst, flip_margin=FLIP_MARGIN,
         token_agreement_vs_plain_ref=float(np.concatenate(agree).mean()),
         parted=json.dumps(parted, separators=(",", ":")), serve_wall_s=t_serve)
    if not (np.all(np.isfinite(plain)) and allr.max() <= DECODE_TOL):
        raise AssertionError(f"decode logits outside tolerance: {allr.max()}")
    if worst > FLIP_MARGIN:
        raise AssertionError(f"sign decisions overruled far from zero: "
                             f"{[f for f in flips if f['margin'] > FLIP_MARGIN][:8]}")
    return {"rel": rel, "agree": agree, "parted": parted, "flips": flips}


def phase_images(cfg, *, n_requests=64, batch_sizes=(4, 16, 64), seed=0,
                 mesh=None, timeout_s=600.0) -> dict:
    """Phase 5: the image server answers requests; logits are compared with
    the plain float32 fake-quant forward."""
    t0 = time.perf_counter()
    variables = make_resnet_variables(cfg, seed)
    net = infer.export_fused_resnet20(cfg, variables, first_dtype=jnp.float32)
    x = np.random.default_rng(seed + 2).normal(size=(n_requests, 32, 32, 3)).astype(np.float32)
    eng = serve.InferenceEngine.from_fused_resnet(
        net, (32, 32, 3), batch_sizes=batch_sizes, mesh=mesh)
    try:
        eng.warmup()
        futures = [eng.submit(xi) for xi in x]
        got = np.stack([f.result(timeout=timeout_s) for f in futures])
        stats = eng.stats
    finally:
        eng.shutdown()
    ref, margin = jax.jit(functools.partial(plain_resnet_logits, cfg=cfg))(
        variables, jnp.asarray(x))
    rel = _rel_errors(got, ref)
    marked = np.asarray(margin) <= BOUNDARY_STEPS
    emit("images", requests=stats.requests, batches=stats.batches,
         devices=1 if mesh is None else mesh.size, tol=IMAGE_TOL,
         boundary_steps=BOUNDARY_STEPS, marked=int(marked.sum()),
         unmarked_max_rel_err=float(rel[~marked].max(initial=0.0)),
         marked_max_rel_err=float(rel[marked].max(initial=0.0)),
         outside_tol=int(np.sum(rel > IMAGE_TOL)),
         median_rel_err=float(np.median(rel)), precision="HIGHEST",
         wall_s=time.perf_counter() - t0)
    _check_image_logits(got, ref, margin)
    return {"logits": got, "rel": rel, "margin": np.asarray(margin)}


def phase_multi(devices, *, cfg=None, n_requests=64, grad_elems=(1 << 22),
                seed=0) -> dict:
    """Four-card paths: DP image serving over a data mesh against one card,
    and the int8 ring all-reduce against ``psum`` (values and time)."""
    n = len(devices)
    cfg = cfg or resnet_config()
    mesh = parallel.make_mesh((n, 1), devices=devices)
    one = phase_images(cfg, n_requests=n_requests, batch_sizes=(n, 16 * n),
                       seed=seed)
    many = phase_images(cfg, n_requests=n_requests, batch_sizes=(n, 16 * n),
                        seed=seed, mesh=mesh)
    diff, marked = _check_image_logits(many["logits"], one["logits"], one["margin"])
    emit("multi_images", devices=n, max_rel_diff_vs_one_card=float(diff.max()),
         unmarked_max_rel_diff=float(diff[~marked].max(initial=0.0)),
         marked=int(marked.sum()), tol=IMAGE_TOL)

    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(seed + 3)
    g = jnp.asarray(rng.normal(size=(n, grad_elems)), jnp.float32)
    g = jax.device_put(g, NamedSharding(mesh, P(parallel.DATA_AXIS)))
    spec = P(parallel.DATA_AXIS)

    def mapped(f):
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec,
                                     check_vma=False))

    exact = mapped(lambda v: jax.lax.psum(v, parallel.DATA_AXIS))
    ring = mapped(lambda v: parallel.ring_allreduce_quantized(
        v, parallel.DATA_AXIS, bits=8))
    e, r = np.asarray(exact(g)), np.asarray(ring(g))
    # each of the n-1 reduce hops and the gather re-quantizes once: at most
    # half an int8 step of the running sum per quantization
    bound = n * float(np.max(np.abs(e))) / 127.0
    err = float(np.max(np.abs(r - e)))
    t_e = device_time(exact, [(g,)])
    t_r = device_time(ring, [(g,)])
    emit("multi_allreduce", devices=n, elems=grad_elems, max_abs_err=err,
         bound=bound, psum_us=_us(t_e), int8_ring_us=_us(t_r))
    if not err <= bound:
        raise AssertionError(f"int8 ring all-reduce error {err} above {bound}")
    return {"diff": float(diff.max()), "err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card paths, on four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    platform = jax.default_backend()
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {platform!r}", file=sys.stderr)
        return 2
    devs = jax.devices()
    if len(devs) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} cards, "
              f"found {len(devs)}", file=sys.stderr)
        return 2
    cache_dir = enable_compile_cache()  # before the first compilation
    stats = CompileStats()
    t_start = time.perf_counter()
    kind = phase_env(cache_dir)
    if args.chips == 4:
        phase_multi(devs[:4], seed=args.seed)
        emit("multi", wall_s=time.perf_counter() - t_start, compile=stats.delta())
    else:
        lm = lm_config()
        phase_kernels(lm=lm, seed=args.seed)
        emit("kernels_done", compile=stats.delta())
        phase_decode(lm, seed=args.seed)
        emit("decode_done", compile=stats.delta())
        emit("training", run=False, reason=repr(
            "the model layer needs flax, which this machine does not have"))
        phase_images(resnet_config(), seed=args.seed)
        emit("images_done", compile=stats.delta())
    emit("total", wall_s=time.perf_counter() - t_start,
         compile_s=stats.compile_s, cache_hits=stats.hits,
         cache_misses=stats.misses)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
