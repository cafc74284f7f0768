#!/usr/bin/env python
"""Scaling-efficiency benchmark (BASELINE.json:5: >= 85% throughput retention
going 1 chip -> 1 host -> 2+ hosts).

Measures images/s of the sharded train step at growing DP mesh sizes over
the devices that exist (real GPUs; virtual CPU devices in CI via
--virtual N), holding the per-device batch fixed (weak scaling). Efficiency
at n devices = images_per_s(n) / (n * images_per_s(1)).

Prints one JSON line per mesh size plus a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--virtual", type=int, default=0,
                   help="force N virtual CPU devices (CI mode)")
    p.add_argument("--config", default="binaryconnect_mlp")
    p.add_argument("--per-device-batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    a = p.parse_args()

    import os
    if a.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={a.virtual}"
        ).strip()
    import jax
    if a.virtual:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import optax

    from pytorch_quantize_impls_tpu import data, parallel, train
    from pytorch_quantize_impls_tpu.utils import RunConfig, SCHEME_CONFIGS
    from pytorch_quantize_impls_tpu.utils.config import build_model

    if a.virtual:
        print(
            "# note: virtual CPU devices share one host's cores — efficiency "
            "numbers here validate the machinery, not the hardware claim",
            file=sys.stderr,
        )
    n_dev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    cfg = RunConfig(**SCHEME_CONFIGS[a.config])
    model, input_shape, dataset = build_model(cfg)

    results = []
    for n in sizes:
        mesh = parallel.make_mesh((n, 1), devices=jax.devices()[:n])
        batch = n * a.per_device_batch
        rng = np.random.default_rng(0)
        x = rng.normal(size=(batch, *input_shape)).astype(np.float32)
        y = (np.arange(batch) % 10).astype(np.int32)

        variables = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:1]))
        tx = optax.chain(optax.adam(1e-3), train.clip_quantized_weights())
        state = train.QuantTrainState.create_for(model, variables, tx)
        state, step = parallel.make_sharded_train_step(state, mesh)
        xb, yb = parallel.shard_batch((x, y), mesh)

        for _ in range(a.warmup):
            state, m = step(state, (xb, yb))
        jax.block_until_ready(m["loss"])
        t0 = time.perf_counter()
        for _ in range(a.steps):
            state, m = step(state, (xb, yb))
        jax.block_until_ready(m["loss"])
        dt = (time.perf_counter() - t0) / a.steps
        ips = batch / dt
        results.append({"devices": n, "images_per_s": round(ips, 1),
                        "step_ms": round(dt * 1e3, 2)})
        print(json.dumps(results[-1]))

    base = results[0]["images_per_s"]
    for r in results:
        r["efficiency"] = round(r["images_per_s"] / (r["devices"] * base), 3)
    summary = {
        "metric": f"scaling_efficiency_{a.config}",
        "value": results[-1]["efficiency"],
        "unit": "fraction of linear",
        "detail": results,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
