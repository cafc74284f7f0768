"""GEMM benchmark on one GPU: the packed low-bit GEMMs against XLA's plain
dense products at one square shape.

    python bench.py [--size 4096]

Rows (stderr): float32 at HIGHEST, bf16 with float32 accumulation, the int8
dot (the speed of light of every integer-code GEMM), and the packed binary,
4-bit DoReFa and log-quant GEMMs, each with its share of the card's
published peak. Every row carries the card's name and power limit. Times
are the device's busy time per call in a profiler trace, after a warm-up
(``utils.profiling.device_time``). The last stdout line is one JSON object.
The benchmark refuses to run on anything but a GPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pytorch_quantize_impls_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)
from pytorch_quantize_impls_tpu.utils.profiling import (  # noqa: E402
    PEAKS,
    device_time,
)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=4096)
    a = ap.parse_args(argv)
    if jax.default_backend() != "gpu":
        print(f"bench: needs a GPU, JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        print(f"bench: no published peaks for {kind!r}", file=sys.stderr)
        return 2
    enable_compile_cache()
    bgm = importlib.import_module("pytorch_quantize_impls_tpu.kernels.xnor_gemm")
    pmm = importlib.import_module("pytorch_quantize_impls_tpu.kernels.packed_matmul")
    smm = importlib.import_module("pytorch_quantize_impls_tpu.kernels.shift_matmul")
    from pytorch_quantize_impls_tpu import ops

    m = n = k = a.size
    flops = 2 * m * n * k
    where = card()
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(m, k)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(k, n)), jnp.float32)
    rows = {}

    def row(name, fn, args, peak):
        t = device_time(fn, [args])
        rate = flops / t
        rows[name] = rate / 1e12
        print(f"# {name}: {t * 1e3:.4f} ms  {rate / 1e12:.2f} T/s  "
              f"{rate / PEAKS[kind][peak]:.3f} of the {peak} peak  [{where}]",
              file=sys.stderr)

    row("fp32_highest", lambda p, q: jnp.dot(p, q, precision=jax.lax.Precision.HIGHEST),
        (x, w), "fp32_flops")
    row("bf16", lambda p, q: jnp.dot(p, q, preferred_element_type=jnp.float32),
        (x.astype(jnp.bfloat16), w.astype(jnp.bfloat16)), "bf16_flops")
    xi8 = jnp.asarray(rng.integers(-127, 128, (m, k)), jnp.int8)
    wi8 = jnp.asarray(rng.integers(-127, 128, (k, n)), jnp.int8)
    row("int8", lambda p, q: jax.lax.dot_general(
        p, q, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32),
        (xi8, wi8), "int8_ops")
    xi = bgm.binarize_to_int8(x)
    alpha = jnp.abs(w).mean(0)
    row("binary_packed", bgm.binary_gemm, (xi, bgm.pack_binary_weights(w), alpha),
        "int8_ops")
    codes = pmm.dorefa_act_to_int8(ops.dorefa_activation(jnp.abs(x), 4), 4)
    wp4 = pmm.pack_dorefa_weights(ops.dorefa_weight(w, 4), 4)
    row("dorefa4_packed", lambda p, q: pmm.dorefa_gemm(p, q, w_bits=4, a_bits=4),
        (codes, wp4), "int8_ops")
    row("log_shift_packed", lambda p, q: smm.shift_gemm(p, q, fsr=1.0, bits=4),
        (x, smm.pack_log_weights(w, 1.0, 4)), "bf16_flops")

    print(json.dumps({
        "metric": f"binary_packed_gemm_tops_{a.size}",
        "value": rows["binary_packed"],
        "unit": "TOP/s",
        "vs_fp32_highest": rows["binary_packed"] / rows["fp32_highest"],
        "int8_peak_share": rows["binary_packed"] * 1e12 / PEAKS[kind]["int8_ops"],
        "rows_tops": rows,
        "card": where,
        "device": {"platform": jax.devices()[0].platform, "kind": kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
