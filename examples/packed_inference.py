#!/usr/bin/env python
"""Example 2 — train DoReFa W4A4, export packed, serve with the engine.

The part the reference never had (SURVEY.md §2 "Native-kernel components —
reference has NONE"): after training with fake-quant STE, weights are frozen,
bit-packed, and eval runs through the packed low-bit GEMMs. The export
file holds packed ints + scales only — 8x smaller than the f32 checkpoint at
4 bits, 32x at 1 bit.
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from pytorch_quantize_impls_tpu import data, infer, models, serve, train


def main() -> int:
    (xtr, ytr), (xte, yte) = data.mnist(flatten=True)
    model = models.MLP(features=(256, 256, 10), layer="dorefa", bits=4)
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.asarray(xtr[:1]), train=True)
    tx = optax.chain(optax.adam(3e-3), train.clip_quantized_weights())
    state = train.QuantTrainState.create_for(model, variables, tx)
    step = train.make_train_step()
    for i, (bx, by) in enumerate(data.iterate_batches((xtr, ytr), 128)):
        if i >= 300:
            break
        state, m = step(state, (jnp.asarray(bx), jnp.asarray(by)))
    print(f"trained: loss {float(m['loss']):.4f}")

    # --- export: freeze + bit-pack (the eval seam, SURVEY.md §3.5) ---
    vars_eval = {"params": state.params}
    if state.batch_stats is not None:
        vars_eval["batch_stats"] = state.batch_stats
    x_example = jnp.asarray(xte[:1])
    packed = infer.pack_model(model, vars_eval, x_example)
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "model.npz")
        infer.save_packed(path, packed)
        print(f"packed export: {Path(path).stat().st_size/1024:.0f} KiB")
        loaded = infer.prepare(infer.load_packed(path))

    # --- parity: packed kernels == fake-quant forward ---
    xb = jnp.asarray(xte[:256])
    fake = model.apply(vars_eval, xb, train=False)
    true = infer.packed_apply(model, vars_eval, loaded, xb)
    err = float(jnp.max(jnp.abs(fake - true)))
    print(f"fake-quant vs packed max |err|: {err:.2e}")

    # --- continuous-batching serving ---
    engine = serve.InferenceEngine(
        lambda x: infer.packed_apply(model, vars_eval, loaded, x),
        example_shape=xb.shape[1:], batch_sizes=(1, 16, 64),
    )
    engine.warmup()
    futs = [engine.submit(np.asarray(xte[i])) for i in range(32)]
    preds = [int(jnp.argmax(f.result())) for f in futs]
    acc = float(np.mean(np.asarray(preds) == np.asarray(yte[:32])))
    print(f"served 32 requests, acc {acc:.2f}, "
          f"mean batch {engine.stats.mean_batch_size:.1f}")
    engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
