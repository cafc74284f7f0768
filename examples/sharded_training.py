#!/usr/bin/env python
"""Example 3 — SPMD sharded training on a (data, model) mesh.

What the reference (single-device torch) could never do: the same train step
jitted over a device mesh — params sharded over the "model" axis, batch over
"data", XLA inserting all-gathers/psums between devices. Runs anywhere: on one host
this uses 8 virtual CPU devices; on a multi-host cluster, call
``parallel.multihost_initialize()`` first and the identical code scales.

    python examples/sharded_training.py        # 8 virtual CPU devices
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

# Request 8 virtual devices BEFORE importing jax (no-op on a real slice).
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# Demo runs on virtual CPU devices; set QTPU_EXAMPLE_REAL_DEVICES=1 on a
# machine with several GPUs to use the actual cards instead.
if not os.environ.get("QTPU_EXAMPLE_REAL_DEVICES"):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import optax

from pytorch_quantize_impls_tpu import data, models, parallel, train


def main() -> int:
    n = len(jax.devices())
    mesh = parallel.make_mesh((n // 2, 2))  # DP x TP=2
    print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} on "
          f"{jax.devices()[0].platform}")

    (xtr, ytr), (xte, yte) = data.mnist(flatten=True)
    model = models.BinaryConnectMLP(hidden=256)
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.asarray(xtr[:1]), train=True)
    tx = optax.chain(optax.adam(3e-3), train.clip_quantized_weights())
    state = train.QuantTrainState.create_for(model, variables, tx)

    with mesh:
        state, step = parallel.make_sharded_train_step(state, mesh)
        for i, batch in enumerate(data.iterate_batches((xtr, ytr), 256)):
            if i >= 200:
                break
            xb, yb = parallel.shard_batch(batch, mesh)
            state, m = step(state, (xb, yb))
            if i % 50 == 0:
                print(f"step {i:4d}  loss {float(m['loss']):.4f}")

        eval_step = train.make_eval_step()
        ev = eval_step(state, (jnp.asarray(xte[:1024]), jnp.asarray(yte[:1024])))
        print(f"test accuracy: {float(ev['accuracy']):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
