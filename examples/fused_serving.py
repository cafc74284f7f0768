#!/usr/bin/env python
"""Example 6 — fused int8-chained serving (the fastest conv inference path).

Trains a full-XNOR (W1A1) convnet, then exports the FUSED chain
(``infer/fused_chain.py``): eval BatchNorm + the next layer's activation
binarization collapse into a per-channel threshold on each conv's raw int32
accumulator, so activations cross stage boundaries as ±1 int8 — 1 byte,
never materialized in f32 — and every hidden conv runs int8×int8 with exact
integer sums, at 32× smaller weights than the fp32 twin (PERF.md has the
measured rates).

The same fold works for k-bit DoReFa (affine + round + clip on the
accumulator): see ``infer.export_fused_resnet20`` for the residual-network
variant where real values materialize only at skip junctions.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from pytorch_quantize_impls_tpu import data, infer, models, train


def main() -> int:
    (xtr, ytr), (xte, yte) = data.digits()
    # Full-XNOR: binarized weights AND activations. The fused chain needs
    # the K input-scale map off (it depends on real input magnitudes the
    # int8 chain never materializes; the XNOR paper drops K at inference).
    model = models.XNORConvNet(
        widths=(64, 64), binarize_inputs=True, use_input_scale_map=False,
        fp32_first_last=True,
    )
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.asarray(xtr[:1]), train=True)
    tx = optax.chain(optax.adam(optax.cosine_decay_schedule(3e-3, 800)),
                     train.clip_quantized_weights())
    state = train.QuantTrainState.create_for(model, variables, tx)
    step = train.make_train_step()
    for i, (bx, by) in enumerate(data.iterate_batches((xtr, ytr), 64)):
        if i >= 800:
            break
        state, m = step(state, (jnp.asarray(bx), jnp.asarray(by)))
    print(f"trained: loss {float(m['loss']):.4f}")

    # --- export the fused chain (frozen BN stats + packed sign weights) ---
    vars_eval = {"params": state.params, "batch_stats": state.batch_stats}
    chain = infer.export_fused_chain(model, vars_eval)
    n_int8 = sum(1 for s in chain.stages if s.w.dtype == jnp.int8)
    print(f"fused chain: {len(chain.stages)} stages, {n_int8} int8-weight")

    # --- serve: logits match the fake-quant model, activations stay int8 ---
    fused_fwd = jax.jit(lambda c, x: infer.fused_apply(c, x))
    xb = jnp.asarray(xte[:256])
    logits = fused_fwd(chain, xb)
    ref = model.apply(vars_eval, xb, train=False)
    agree = float(jnp.mean(jnp.argmax(logits, -1) == jnp.argmax(ref, -1)))
    acc = float(jnp.mean(jnp.argmax(logits, -1) == jnp.asarray(yte[:256])))
    print(f"fused vs fake-quant argmax agreement: {agree:.4f}")
    print(f"fused eval accuracy: {acc:.4f}")
    assert agree > 0.99
    return 0


if __name__ == "__main__":
    sys.exit(main())
