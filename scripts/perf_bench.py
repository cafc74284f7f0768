#!/usr/bin/env python
"""Model-level performance benchmarks on one GPU (VERDICT r2 #2/#4).

bench.py measures square GEMMs; the BASELINE configs are conv models and the
serving story is autoregressive decode, so this script measures:

1. packed_conv2d vs fp32 XLA conv at the models' hot shapes,
2. full-model packed inference (XNOR ConvNet / DoReFa ResNet-20 images/s,
   packed vs fake-quant vs fp32 twin),
3. decode serving (prefill latency + steady-state tokens/s, packed vs
   fake-quant, batch 1/8/32) on a serving-sized quantized transformer.

Needs the model layer (flax). Writes a markdown report (--out FILE). Times
are device times from the host clock around ``block_until_ready`` after a
warm-up (``utils.profiling.device_time``); decode steps run as an on-device
chain of greedy steps. Every report line names the device it ran on.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np

import jax
import jax.numpy as jnp

from pytorch_quantize_impls_tpu.utils.compile_cache import enable_compile_cache
from pytorch_quantize_impls_tpu.utils.profiling import device_time


def make_timer(repeats: int):
    """``timer(fn, x, *rest) -> (seconds, rel_spread)``: the median device
    time of ``fn(x, *rest)`` and the (max - min) / median of its repeats."""

    def timer(fn, x, *rest):
        ts = sorted(device_time(fn, [(x, *rest)], repeats=1) for _ in range(repeats))
        med = ts[len(ts) // 2]
        return med, (ts[-1] - ts[0]) / med

    return timer


def bench_conv(rows, quick=False, repeats=5):
    """Packed conv vs fp32 conv at the CIFAR models' hot shapes."""
    from pytorch_quantize_impls_tpu.kernels.conv import (
        pack_conv_weights, packed_conv2d,
    )
    from pytorch_quantize_impls_tpu.ops.dorefa import (
        dorefa_activation, dorefa_weight,
    )

    cbench = make_timer(repeats)
    shapes = [(64, 16, 16, 256, 256)] if quick else [
        (256, 32, 32, 128, 128),   # XNORConvNet stage-1 hot conv
        (256, 16, 16, 256, 256),   # stage-2
        (256, 8, 8, 512, 512),     # stage-3
    ]
    rng = np.random.default_rng(0)
    for b, h, w_, cin, cout in shapes:
        x = jnp.asarray(rng.normal(size=(b, h, w_, cin)).astype(np.float32))
        k = jnp.asarray(
            rng.normal(size=(3, 3, cin, cout)).astype(np.float32)
        )
        flops = 2 * b * h * w_ * 9 * cin * cout  # SAME padding, stride 1

        def f32(a, kk):
            return jax.lax.conv_general_dilated(
                a, kk, (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                precision=jax.lax.Precision.HIGHEST,
            )

        t0, s0 = cbench(f32, x, k)

        # PackedConv holds static str/int fields -> not a valid jit arg;
        # keep it a closure constant (KB-scale)
        pb = pack_conv_weights(k, "xnor", a_bits=1)
        t1, s1 = cbench(lambda a, pw=pb: packed_conv2d(a, pw), x)

        pd = pack_conv_weights(dorefa_weight(k, 4), "dorefa", w_bits=4, a_bits=4)
        xd = dorefa_activation(jnp.abs(x), 4)
        t2, s2 = cbench(lambda a, pw=pd: packed_conv2d(a, pw), xd)

        shape = f"{b}x{h}x{w_}x{cin}->{cout}"
        rows.append(
            ("conv", f"fp32 HIGHEST {shape}", flops / t0 / 1e12, 1.0, s0)
        )
        rows.append(
            ("conv", f"xnor packed {shape}", flops / t1 / 1e12, t0 / t1, s1)
        )
        rows.append(
            ("conv", f"dorefa4 packed {shape}", flops / t2 / 1e12, t0 / t2, s2)
        )
        print(f"# conv {shape}: fp32 {flops/t0/1e12:.1f} T/s | "
              f"xnor {flops/t1/1e12:.1f} T/s ({t0/t1:.1f}x) | "
              f"dorefa4 {flops/t2/1e12:.1f} T/s ({t0/t2:.1f}x)",
              file=sys.stderr)


def bench_models(rows, quick=False, repeats=5):
    """Full-model inference images/s: packed vs fake-quant vs fp32 twin."""
    from pytorch_quantize_impls_tpu import infer, models

    cbench = make_timer(repeats)
    batch = 64 if quick else 256
    # xnor_convnet runs with the K input-scale map off for all variants so
    # the fused int8 chain (which requires K off — infer/fused_chain.py) is
    # an apples-to-apples fourth row; the fp32 twin never had K anyway.
    zoo = [
        ("xnor_convnet",
         models.XNORConvNet(use_input_scale_map=False),
         models.XNORConvNet(quantized=False)),
        ("dorefa_resnet20",
         models.DorefaResNet20(w_bits=4, a_bits=4),
         models.DorefaResNet20(quantized=False)),
        # Production-width variant (ResNet20-4x, channels 64/128/256): the
        # BASELINE config's width-16 convs are too narrow to fill the
        # tensor-core tiles; the int8 paths' advantage should appear at the
        # channel counts real deployments use (ROADMAP S7 asks whether).
        ("dorefa_resnet20_w64",
         models.DorefaResNet20(w_bits=4, a_bits=4, width=64),
         models.DorefaResNet20(quantized=False, width=64)),
    ]
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(batch, 32, 32, 3)).astype(np.float32))
    for name, qm, fm in zoo:
        vq = qm.init({"params": jax.random.PRNGKey(0)}, x[:1], train=False)
        vf = fm.init({"params": jax.random.PRNGKey(0)}, x[:1], train=False)
        packed = infer.prepare(infer.pack_model(qm, vq, x[:1]))

        # variables/packed buffers ride as jit args (not closure constants)
        fq = lambda a, v, m=qm: m.apply(v, a, train=False)  # noqa: E731
        ff = lambda a, v, m=fm: m.apply(v, a, train=False)  # noqa: E731
        fp = (
            lambda a, v, p, m=qm: infer.packed_apply(m, v, p, a)
        )  # noqa: E731
        tq, sq = cbench(fq, x, vq)
        tf, sf = cbench(ff, x, vf)
        tp, sp = cbench(fp, x, vq, packed)
        rows.append((name, "fp32 twin", batch / tf, 1.0, sf))
        rows.append((name, "fake-quant", batch / tq, tf / tq, sq))
        rows.append((name, "packed", batch / tp, tf / tp, sp))
        print(f"# {name} b{batch}: fp32 {batch/tf:,.0f} img/s | "
              f"fake-quant {batch/tq:,.0f} | packed {batch/tp:,.0f} "
              f"({tf/tp:.2f}x fp32)", file=sys.stderr)
        if name == "xnor_convnet":
            # fused int8 chain: BN+binarize folded into the conv epilogue,
            # activations cross stages as ±1 int8 (VERDICT r3 #3)
            chain = infer.export_fused_chain(qm, vq)
            fz = lambda a, c: infer.fused_apply(c, a)  # noqa: E731
            tz, sz = cbench(fz, x, chain)
            rows.append((name, "fused int8 chain", batch / tz, tf / tz, sz))
            print(f"# {name} fused: {batch/tz:,.0f} img/s "
                  f"({tf/tz:.2f}x fp32)", file=sys.stderr)
        if name.startswith("dorefa_resnet20"):
            # fused k-bit chain: BN+relu+act-quant folded into an affine+
            # round+clip on the int32 accumulator; codes cross layers as
            # int8, real values only at residual junctions (r4)
            net = infer.export_fused_resnet20(qm, vq)
            fr = lambda a, c: infer.fused_resnet_apply(c, a)  # noqa: E731
            tr, sr = cbench(fr, x, net)
            rows.append((name, "fused int8 chain", batch / tr, tf / tr, sr))
            print(f"# {name} fused: {batch/tr:,.0f} img/s "
                  f"({tf/tr:.2f}x fp32)", file=sys.stderr)


def bench_decode(rows, quick=False, repeats=5):
    """Serving-size transformer: prefill latency + steady decode tokens/s."""
    from pytorch_quantize_impls_tpu import infer
    from pytorch_quantize_impls_tpu.models.transformer import QuantTransformerLM
    from pytorch_quantize_impls_tpu.serve.generate import _MUT
    from pytorch_quantize_impls_tpu.infer.packed import packed_apply

    if quick:
        lm = QuantTransformerLM(
            vocab=256, d_model=128, n_heads=4, n_layers=2, d_ff=256,
            max_len=128, scheme="binary", w_bits=1, a_bits=1,
        )
        prompt_len, batches = 32, (1, 4)
    else:
        lm = QuantTransformerLM(
            vocab=8192, d_model=1024, n_heads=8, n_layers=8, d_ff=4096,
            max_len=1024, scheme="binary", w_bits=1, a_bits=1,
        )
        prompt_len, batches = 128, (1, 8, 32)
    rng = np.random.default_rng(2)
    toks1 = jnp.asarray(
        rng.integers(0, lm.vocab, (1, prompt_len)), jnp.int32
    )
    v = lm.init({"params": jax.random.PRNGKey(0)}, toks1, train=False)
    packed = infer.pack_model(lm, v, toks1)
    prepared = infer.prepare(packed)
    fm = infer.export_fused_decode(lm, v)
    fmp = infer.export_fused_decode(lm, v, weights="packed")
    md = lm.clone(decode=True)

    def apply_fake(variables, t):
        return md.apply(variables, t, train=False, mutable=_MUT)

    def apply_packed(variables, t):
        return packed_apply(md, variables, packed, t, mutable=_MUT)

    def apply_prepared(variables, t):
        return packed_apply(md, variables, prepared, t, mutable=_MUT)

    def apply_fused(variables, t):
        # the fused program rides as variables["params"] (a jit argument)
        return infer.fused_decode_apply(
            variables["params"], variables.get("cache"), t
        )

    # the on-device decode chain must fit the cache after the prompt
    n_steps = min(64, lm.max_len - prompt_len - 1)

    for label, ap, pp in (
        ("fake-quant", apply_fake, v["params"]),
        ("packed", apply_packed, v["params"]),  # 1-bit planes resident
        ("prepared", apply_prepared, v["params"]),  # int8 resident (engine)
        ("fused", apply_fused, fm),  # r5 fused step (VERDICT r4 #4)
        ("fused-packed", apply_fused, fmp),  # 1-bit-resident weights
    ):
        cb = make_timer(repeats)
        tpre, spre = cb(
            lambda t, p, ap=ap: ap({"params": p}, t), toks1, pp
        )
        rows.append(
            ("decode", f"{label} prefill {prompt_len} tok (ms)",
             tpre * 1e3, 0.0, spre)
        )
        print(f"# decode {label}: prefill({prompt_len}) {tpre*1e3:.2f} ms "
              f"(±{spre*100:.0f}%)", file=sys.stderr)
        for b in batches:
            tb = jnp.asarray(
                rng.integers(0, lm.vocab, (b, prompt_len)), jnp.int32
            )
            _, st = jax.jit(lambda p, t, ap=ap: ap({"params": p}, t))(
                pp, tb
            )
            cache = st["cache"]
            cur = jnp.zeros((b,), jnp.int32)

            # n dependent greedy steps inside ONE device computation: token
            # i+1 is the argmax of step i's logits, the cache advances
            @jax.jit
            def chain(p, c, t, ap=ap):
                def body(_, carry):
                    c, t = carry
                    logits, st2 = ap({"params": p, "cache": c}, t[:, None])
                    nxt = jnp.argmax(
                        logits[:, 0].astype(jnp.float32), -1
                    ).astype(jnp.int32)
                    return (st2["cache"], nxt)

                return jax.lax.fori_loop(0, n_steps, body, (c, t))[1]

            jax.block_until_ready(chain(pp, cache, cur))
            ests = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                jax.block_until_ready(chain(pp, cache, cur))
                ests.append((time.perf_counter() - t0) / n_steps)
            ests.sort()
            tstep = ests[len(ests) // 2]
            sstep = (ests[-1] - ests[0]) / tstep
            rows.append(
                ("decode", f"{label} decode b{b} (tok/s)",
                 b / tstep, 0.0, sstep)
            )
            print(f"# decode {label} b{b}: {tstep*1e3:.3f} ms/step = "
                  f"{b/tstep:,.1f} tok/s (±{sstep*100:.0f}%, chain {n_steps})",
                  file=sys.stderr)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=None, help="write markdown report here")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--quick", action="store_true", help="small shapes (CPU smoke)")
    p.add_argument("--sections", nargs="*",
                   default=["conv", "models", "decode"])
    a = p.parse_args()
    enable_compile_cache()

    dev = jax.devices()[0]
    where = f"{dev.platform}: {dev.device_kind} x{len(jax.devices())}"
    print(f"# perf_bench on {where} (repeats={a.repeats})", file=sys.stderr)
    rows = []  # (section, case, value, vs_fp32, spread)
    if "conv" in a.sections:
        bench_conv(rows, a.quick, repeats=a.repeats)
    if "models" in a.sections:
        bench_models(rows, a.quick, repeats=a.repeats)
    if "decode" in a.sections:
        bench_decode(rows, a.quick, repeats=a.repeats)

    lines = [
        f"# Model-level benchmarks ({where})",
        "",
        "Device time from the host clock around block_until_ready; median "
        f"over {a.repeats} repeats, spread = (max-min)/median.",
        "",
        "| section | case | value | vs fp32 | spread |",
        "|---|---|---|---|---|",
    ]
    for sec, case, val, ratio, spread in rows:
        unit = ("T/s" if sec == "conv"
                else "ms" if "(ms)" in case
                else "tok/s" if sec == "decode"
                else "img/s")
        ratio_s = f"{ratio:.2f}x" if ratio else "—"
        lines.append(
            f"| {sec} | {case} | {val:,.1f} {unit} | {ratio_s} "
            f"| ±{spread*100:.0f}% |"
        )
    report = "\n".join(lines) + "\n"
    print(report)
    if a.out:
        Path(a.out).write_text(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
