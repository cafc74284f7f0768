#!/usr/bin/env python
"""Example 1 — BinaryConnect MLP on MNIST (BASELINE config 1).

The reference ships this workflow as a notebook (SURVEY.md §2-L2: construct
model -> CE loss -> backward -> optimizer.step() -> per-layer clamp()); here
the whole loop is one jitted XLA program and the clamp is an optax transform.

Runs on the CPU or a GPU. With real MNIST under $QTPU_DATA_DIR it trains on that;
otherwise a deterministic synthetic stand-in. Try also ``--scheme
binary_stoch|ternary|dorefa|log|lin`` to swap the quantizer.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import optax

from pytorch_quantize_impls_tpu import data, models, train


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scheme", default="bin",
                   choices=["bin", "bin_stoch", "ternary", "dorefa", "log", "lin"])
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--lr", type=float, default=3e-3)
    a = p.parse_args()

    (xtr, ytr), (xte, yte) = data.mnist(flatten=True)
    model = models.MLP(features=(a.hidden, a.hidden, 10), layer=a.scheme)

    rngs = {"params": jax.random.PRNGKey(0)}
    if a.scheme.endswith("stoch"):
        rngs["quant"] = jax.random.PRNGKey(1)  # stochastic rounding key
    variables = model.init(rngs, jnp.asarray(xtr[:1]), train=True)

    # Adam + clamp-after-step (the reference's `layer.clamp()` loop, fused).
    tx = optax.chain(optax.adam(a.lr), train.clip_quantized_weights())
    state = train.QuantTrainState.create_for(model, variables, tx)
    step = train.make_train_step(has_quant_rng=a.scheme.endswith("stoch"))

    for i, (bx, by) in enumerate(data.iterate_batches((xtr, ytr), 128)):
        if i >= a.steps:
            break
        state, m = step(state, (jnp.asarray(bx), jnp.asarray(by)))
        if i % 100 == 0:
            print(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                  f"acc {float(m['accuracy']):.3f}")

    ev = train.make_eval_step()(state, (jnp.asarray(xte[:2048]), jnp.asarray(yte[:2048])))
    print(f"test accuracy: {float(ev['accuracy']):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
