"""Fault injection (SURVEY.md §5): SIGKILL a training run mid-flight, then
restart and verify it resumes from the last checkpoint and completes.

The failure story is fail-fast + frequent async checkpoints; this is the
kill-a-host integration test, scaled to one process. Runs the real
CLI (``scripts/train.py``) in subprocesses on CPU.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).parent.parent
TRAIN = REPO / "scripts" / "train.py"


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _cmd(ckpt_dir, steps):
    return [
        sys.executable, str(TRAIN),
        "--config", "binaryconnect_mlp",
        "--steps", str(steps),
        "--batch-size", "64",
        "--checkpoint-dir", str(ckpt_dir),
        "--ckpt-every", "20",
    ]


def test_kill_and_resume(tmp_path):
    ckpt = tmp_path / "ckpt"

    # Run 1: start a long training run, SIGKILL it once a checkpoint lands
    # (steps=100000 guarantees the kill precedes completion).
    p = subprocess.Popen(
        _cmd(ckpt, steps=100000), env=_cpu_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    def finalized_steps():
        if not ckpt.exists():
            return []
        # finalized = renamed to a bare step-number dir (orbax writes into
        # "<step>.orbax-checkpoint-tmp" first) with its metadata present
        return [
            d for d in ckpt.iterdir()
            if d.name.isdigit() and (d / "_CHECKPOINT_METADATA").exists()
        ]

    deadline = time.time() + 300
    try:
        while time.time() < deadline:
            if finalized_steps():
                break
            if p.poll() is not None:
                out = p.stdout.read()
                pytest.fail(f"run 1 exited before checkpointing:\n{out[-2000:]}")
            time.sleep(1)
        else:
            pytest.fail("no checkpoint appeared within 300s")
        p.send_signal(signal.SIGKILL)
    finally:
        p.wait(timeout=30)

    # Run 2: finite horizon — must resume (not restart) and finish.
    r = subprocess.run(
        _cmd(ckpt, steps=500), env=_cpu_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600,
    )
    assert r.returncode == 0, r.stdout[-2000:]
    assert "resumed from step" in r.stdout
    resumed = int(r.stdout.split("resumed from step")[1].split()[0])
    assert resumed >= 20
    assert "final eval accuracy" in r.stdout


def _final_state(ckpt_dir):
    """Restore the newest checkpoint of a finished run as a raw pytree."""
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(str(ckpt_dir))
    step = mgr.latest_step()
    tree = mgr.restore(step)
    mgr.close()
    return step, tree


def test_resume_determinism(tmp_path):
    """A killed-and-resumed run must end BIT-IDENTICAL to an unkilled run:
    the checkpointed train state carries the RNG, and iterate_batches
    fast-forwards the data stream to the resumed step (VERDICT r2 #8)."""
    import numpy as np

    ck_a, ck_b = tmp_path / "a", tmp_path / "b"
    steps = 120

    # Run A: uninterrupted.
    r = subprocess.run(
        _cmd(ck_a, steps=steps), env=_cpu_env(), timeout=600,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    assert r.returncode == 0, r.stdout[-2000:]

    # Run B: killed after the first checkpoint lands, then resumed.
    p = subprocess.Popen(
        _cmd(ck_b, steps=steps), env=_cpu_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    deadline = time.time() + 300
    try:
        while time.time() < deadline:
            done = [
                d for d in (ck_b.iterdir() if ck_b.exists() else [])
                if d.name.isdigit() and (d / "_CHECKPOINT_METADATA").exists()
            ]
            # kill strictly before completion (final save is at step 120)
            if done and all(int(d.name) < steps for d in done):
                break
            if p.poll() is not None:
                pytest.fail("run B finished before it could be killed")
            time.sleep(0.5)
        else:
            pytest.fail("no checkpoint appeared within 300s")
        p.send_signal(signal.SIGKILL)
    finally:
        p.wait(timeout=30)
    r2 = subprocess.run(
        _cmd(ck_b, steps=steps), env=_cpu_env(), timeout=600,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    assert r2.returncode == 0, r2.stdout[-2000:]
    assert "resumed from step" in r2.stdout

    step_a, tree_a = _final_state(ck_a)
    step_b, tree_b = _final_state(ck_b)
    assert step_a == step_b == steps
    import jax

    la = jax.tree_util.tree_leaves_with_path(tree_a)
    lb = jax.tree_util.tree_leaves(tree_b)
    assert len(la) == len(lb)
    for (path, a), b in zip(la, lb):
        if hasattr(a, "dtype") and a.dtype.kind == "f":
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg=f"mismatch at {jax.tree_util.keystr(path)}",
            )


def test_torn_checkpoint_falls_back(tmp_path):
    """Restoring with the newest checkpoint torn (metadata missing — the
    killed-mid-finalize signature) must fall back to the previous good step,
    not crash and not return garbage."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from pytorch_quantize_impls_tpu import models, train
    from pytorch_quantize_impls_tpu.utils import CheckpointManager

    model = models.BinaryConnectMLP(hidden=8)
    v = model.init({"params": jax.random.PRNGKey(0)},
                   jnp.zeros((1, 784)), train=True)
    tx = optax.adam(1e-3)
    state = train.QuantTrainState.create_for(model, v, tx)
    step = train.make_train_step(donate=False)
    batch = (jnp.zeros((4, 784)), jnp.zeros((4,), jnp.int32))

    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    state, _ = step(state, batch)
    mgr.save(state)            # good checkpoint at step 1
    good_params = jax.tree.map(lambda x: np.asarray(x), state.params)
    state, _ = step(state, batch)
    mgr.save(state)            # checkpoint at step 2, to be torn
    mgr.wait()

    # Tear the newest step: remove its tensorstore manifest — the signature
    # of a writer killed mid-finalize (array data unreadable).
    manifest = tmp_path / "ck" / "2" / "default" / "manifest.ocdbt"
    assert manifest.exists()
    manifest.unlink()

    mgr2 = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    restored = mgr2.restore(state)
    assert restored is not None, "fallback to step 1 failed"
    assert int(restored.step) == 1
    for a, b in zip(jax.tree.leaves(good_params),
                    jax.tree.leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    mgr.close()
    mgr2.close()
