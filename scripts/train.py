#!/usr/bin/env python
"""Train any of the five BASELINE configs end-to-end.

Example:
    python scripts/train.py --config binaryconnect_mlp --steps 2000 \
        --checkpoint-dir /tmp/ckpt --metrics metrics.jsonl --export model.npz

Uses real MNIST/CIFAR-10 from --data-dir (or $QTPU_DATA_DIR) when present,
else the deterministic synthetic stand-ins. Resumes from the checkpoint dir
automatically. The accuracy gate (--expect-acc) makes this double as the
Δ-accuracy harness: run once quantized, once with --fp32 twin, compare.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np

import jax
import jax.numpy as jnp
import optax

from pytorch_quantize_impls_tpu import data, infer, models, parallel, train
from pytorch_quantize_impls_tpu.utils import (
    MetricsWriter,
    RunConfig,
    SCHEME_CONFIGS,
    StepTimer,
    enable_compile_cache,
)
from pytorch_quantize_impls_tpu.utils.config import build_model
from pytorch_quantize_impls_tpu.utils.metrics import setup_logging, log


def parse_args() -> RunConfig:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="binaryconnect_mlp",
                   choices=sorted(SCHEME_CONFIGS))
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--stochastic", action="store_true")
    p.add_argument("--fp32", action="store_true", help="train the fp32 twin")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", type=str, default=None,
                   help="data,model e.g. 4,2; default: all devices on data")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--metrics", default=None)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--export", default=None, help="write packed npz artifact")
    p.add_argument("--expect-acc", type=float, default=None,
                   help="exit 1 if final eval accuracy is below this")
    a = p.parse_args()
    cfg = RunConfig(
        config=a.config,
        deterministic=not a.stochastic,
        steps=a.steps,
        batch_size=a.batch_size,
        lr=a.lr,
        seed=a.seed,
        mesh_shape=tuple(int(v) for v in a.mesh.split(",")) if a.mesh else None,
        checkpoint_dir=a.checkpoint_dir,
        metrics_path=a.metrics,
        data_dir=a.data_dir,
    )
    cfg._fp32 = a.fp32  # twin-run flag (not a scheme knob)
    cfg._ckpt_every = a.ckpt_every
    cfg._export = a.export
    cfg._expect_acc = a.expect_acc
    return cfg


def main() -> int:
    setup_logging()
    cfg = parse_args()
    enable_compile_cache()
    if cfg.data_dir:
        os.environ[data.datasets.DATA_DIR_ENV] = cfg.data_dir

    model, input_shape, dataset = build_model(cfg, fp32=getattr(cfg, "_fp32", False))
    log.info("config=%s model=%s dataset=%s", cfg.config, type(model).__name__, dataset)

    if dataset == "mnist":
        train_data, test_data = data.mnist(flatten=(len(input_shape) == 1))
    elif dataset == "digits":
        train_data, test_data = data.digits(flatten=(len(input_shape) == 1))
    else:
        train_data, test_data = data.cifar10()
    log.info("train=%s test=%s", train_data[0].shape, test_data[0].shape)

    x0 = jnp.asarray(train_data[0][:1])
    rngs = {"params": jax.random.PRNGKey(cfg.seed)}
    if not cfg.deterministic:
        rngs["quant"] = jax.random.PRNGKey(cfg.seed + 1)
    variables = model.init(rngs, x0, train=True)
    tx = optax.chain(
        optax.adam(cfg.lr),
        train.clip_quantized_weights(),
    )
    state = train.QuantTrainState.create_for(model, variables, tx, seed=cfg.seed)

    mgr = None
    if cfg.checkpoint_dir:
        # orbax is needed only when checkpointing is asked for
        from pytorch_quantize_impls_tpu.utils.checkpoint import CheckpointManager

        mgr = CheckpointManager(cfg.checkpoint_dir)
        restored = mgr.restore(state)
        if restored is not None:
            state = restored
            log.info("resumed from step %d", int(state.step))

    mesh = parallel.make_mesh(cfg.mesh_shape)
    state, step_fn = parallel.make_sharded_train_step(
        state, mesh, has_quant_rng=not cfg.deterministic
    )
    log.info("mesh=%s", dict(zip(mesh.axis_names, mesh.devices.shape)))

    timer = StepTimer()
    with MetricsWriter(cfg.metrics_path) as mw:
        for batch in data.iterate_batches(
            train_data, cfg.batch_size, seed=cfg.seed,
            start_step=int(state.step),  # align data stream after resume
        ):
            if int(state.step) >= cfg.steps:
                break
            xb, yb = parallel.shard_batch(batch, mesh)
            with timer:
                state, metrics = step_fn(state, (xb, yb))
            s = int(state.step)
            if s % 100 == 0 or s == cfg.steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["images_per_s"] = timer.throughput(cfg.batch_size)
                mw.write(s, m)
                log.info("step %d %s", s, m)
            if mgr and s % cfg._ckpt_every == 0:
                mgr.save(state)

    # final eval (batched to bound memory)
    eval_step = train.make_eval_step()
    accs, ns = [], []
    xt, yt = test_data
    for i in range(0, len(xt) - len(xt) % 256, 256):
        m = eval_step(state, (jnp.asarray(xt[i : i + 256]), jnp.asarray(yt[i : i + 256])))
        accs.append(float(m["accuracy"]) * 256)
        ns.append(256)
    acc = sum(accs) / sum(ns)
    log.info("final eval accuracy: %.4f", acc)

    if mgr:
        mgr.save(state, force=True)
        mgr.wait()
        mgr.close()

    if getattr(cfg, "_export", None):
        variables = {"params": state.params}
        if state.batch_stats is not None:
            variables["batch_stats"] = state.batch_stats
        packed = infer.pack_model(model, variables, x0)
        infer.save_packed(cfg._export, packed)
        log.info("packed artifact -> %s", cfg._export)

    if getattr(cfg, "_expect_acc", None) is not None and acc < cfg._expect_acc:
        log.error("accuracy %.4f below gate %.4f", acc, cfg._expect_acc)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
