"""Pipeline parallelism: GPipe-style microbatch pipeline over a "pipe" mesh
axis — NEW scope, no reference counterpart (SURVEY.md §2 "Parallelism &
communication components — reference has NONE").

Realization (scaling-book pipelining recipe): each pipe-axis
device holds ONE stage's parameters (stage-stacked pytrees sharded on their
leading axis), a ``lax.scan`` steps the pipeline ``n_micro + n_stages - 1``
ticks, and ``jax.lax.ppermute`` shifts activations to the next stage over
the interconnect each tick. The whole schedule is a pure, differentiable function —
``jax.grad`` transposes the scan + ppermute into the reverse (1F1B-shaped)
backward automatically, so quantized STE training works through the
pipeline unchanged.

Composition with the quantizer zoo: the stage function is arbitrary — the
provided :func:`binary_stage_fn` runs BinaryConnect fake-quant dense blocks,
so PP composes with 1-bit STE training out of the box. DP composes on the
"data" mesh axis (batch split outside, grads pmean'd inside).

Bubble accounting: utilization = n_micro / (n_micro + n_stages - 1); pick
``n_micro >= 4 * n_stages`` for >80%.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pytorch_quantize_impls_tpu import ops
from pytorch_quantize_impls_tpu.parallel.mesh import DATA_AXIS

PIPE_AXIS = "pipe"

StageFn = Callable[[Any, jax.Array], jax.Array]


def make_pipe_mesh(
    n_data: int, n_pipe: int, *, devices=None
) -> Mesh:
    """(data, pipe) mesh for DP x PP runs."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_data * n_pipe != len(devs):
        raise ValueError(f"mesh {n_data}x{n_pipe} != {len(devs)} devices")
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh(
        (n_data, n_pipe), (DATA_AXIS, PIPE_AXIS), axis_types=auto, devices=devs
    )


def stack_stage_params(params_list):
    """[stage0_params, stage1_params, ...] -> stage-stacked pytree with a
    leading ``n_stages`` axis on every leaf (shard it over PIPE_AXIS)."""
    return jax.tree.map(lambda *ls: jnp.stack(ls), *params_list)


def stage_param_shardings(stacked, mesh: Mesh):
    """Leading (stage) axis over the pipe axis, rest unsharded."""
    def shard(leaf):
        return NamedSharding(mesh, P(PIPE_AXIS, *([None] * (leaf.ndim - 1))))
    return jax.tree.map(shard, stacked)


def binary_stage_fn(params, h: jax.Array) -> jax.Array:
    """One BinaryConnect fake-quant dense block (hidden -> hidden): the
    default stage body — sign(W) with STE, fp32 master weights (SURVEY.md
    §3.1 hot loop), relu."""
    wb = ops.binary_connect_det(params["kernel"])
    return jax.nn.relu(h @ wb + params["bias"])


def init_binary_stage(key, hidden: int):
    kw, _ = jax.random.split(key)
    w = jax.random.normal(kw, (hidden, hidden), jnp.float32) * (
        1.0 / jnp.sqrt(hidden)
    )
    return {"kernel": w, "bias": jnp.zeros((hidden,), jnp.float32)}


def init_pipeline_mlp(
    key,
    *,
    n_stages: int,
    in_dim: int,
    hidden: int,
    classes: int,
):
    """Params for embed -> [n_stages x binary stage] -> head.

    Embed/head are full-precision (BinaryConnect keeps first/last layers
    fp32 — paper practice) and replicated; stages are 1-bit-quantized and
    pipe-sharded.
    """
    ks = jax.random.split(key, n_stages + 2)
    stages = stack_stage_params(
        [init_binary_stage(ks[i], hidden) for i in range(n_stages)]
    )
    embed = {
        "kernel": jax.random.normal(ks[-2], (in_dim, hidden), jnp.float32)
        * (1.0 / jnp.sqrt(in_dim)),
        "bias": jnp.zeros((hidden,), jnp.float32),
    }
    head = {
        "kernel": jax.random.normal(ks[-1], (hidden, classes), jnp.float32)
        * (1.0 / jnp.sqrt(hidden)),
        "bias": jnp.zeros((classes,), jnp.float32),
    }
    return {"embed": embed, "stages": stages, "head": head}


def pipeline_stages(
    stage_fn: StageFn,
    stacked_local,
    x_micro: jax.Array,
    *,
    n_stages: int,
    axis: str = PIPE_AXIS,
) -> jax.Array:
    """Run the microbatch pipeline. MUST be called inside shard_map with
    ``stacked_local`` carrying this device's stage (leading axis length 1).

    ``x_micro``: (n_micro, mb, hidden) — stage-0 inputs, replicated on the
    pipe axis. Returns (n_micro, mb, hidden), meaningful ONLY on the last
    stage (zeros elsewhere); reduce with a gated psum or feed a gated loss.
    """
    stage_id = jax.lax.axis_index(axis)
    params = jax.tree.map(lambda p: p[0], stacked_local)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def tick(carry, t):
        state, out_buf = carry
        inp = x_micro[jnp.minimum(t, n_micro - 1)]
        cur = jnp.where(stage_id == 0, inp, state)
        out = stage_fn(params, cur)
        oidx = t - (n_stages - 1)
        upd = jax.lax.dynamic_update_slice_in_dim(
            out_buf, out[None], jnp.clip(oidx, 0, n_micro - 1), axis=0
        )
        out_buf = jnp.where((oidx >= 0) & (oidx < n_micro), upd, out_buf)
        state = jax.lax.ppermute(out, axis, perm)
        return (state, out_buf), None

    # Initial carries must already be marked device-varying over the pipe
    # axis (the loop body makes them so; scan demands a fixed carry type).
    state0 = jax.lax.pcast(jnp.zeros_like(x_micro[0]), axis, to="varying")
    buf0 = jax.lax.pcast(jnp.zeros_like(x_micro), axis, to="varying")
    (_, out_buf), _ = jax.lax.scan(tick, (state0, buf0), jnp.arange(ticks))
    return out_buf


def _dense(p, h):
    return h @ p["kernel"] + p["bias"]


def pipelined_loss(
    params,
    x: jax.Array,
    y: jax.Array,
    *,
    stage_fn: StageFn,
    n_stages: int,
    n_micro: int,
) -> jax.Array:
    """Local (per-shard) pipelined CE loss; call under shard_map over a
    (data, pipe) mesh. Loss is psum-gated to the last stage and pmean'd
    over data shards -> identical replicated scalar on every device."""
    b = x.shape[0]
    assert b % n_micro == 0, (b, n_micro)
    stage_id = jax.lax.axis_index(PIPE_AXIS)
    h = jax.nn.relu(_dense(params["embed"], x))
    h = h.reshape(n_micro, b // n_micro, -1)
    out = pipeline_stages(
        stage_fn, params["stages"], h, n_stages=n_stages
    )
    logits = _dense(params["head"], out.reshape(b, -1)).astype(jnp.float32)
    logp = jax.nn.log_softmax(logits)
    ce = -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))
    # Only the last stage saw real activations; zero the others' contribution
    # and share the scalar around the ring.
    loss = jax.lax.psum(
        jnp.where(stage_id == n_stages - 1, ce, 0.0), PIPE_AXIS
    )
    return jax.lax.pmean(loss, DATA_AXIS)


PARAM_SPECS = {"embed": P(), "stages": P(PIPE_AXIS), "head": P()}


def make_pipeline_value_and_grad(
    mesh: Mesh,
    *,
    n_stages: int,
    n_micro: int,
    stage_fn: StageFn = binary_stage_fn,
):
    """shard_map'd (params, x, y) -> (loss, grads) over a (data, pipe) mesh.

    Replication (vma) tracking stays ON, which makes plain
    ``jax.value_and_grad`` inside shard_map produce the *globally correct*
    grads with no manual reductions: params entering replicated (embed/head
    via P(); stages replicated over "data") are implicitly pvary'd where
    they meet device-varying values, and the transpose of pvary is a psum
    over exactly the right axes — pipe+data for embed/head, data for the
    pipe-sharded stages. (Do NOT add explicit psums on top; that
    double-counts — measured 8x on a 2x4 mesh.)
    """
    from jax import shard_map

    loss_local = functools.partial(
        pipelined_loss, stage_fn=stage_fn, n_stages=n_stages, n_micro=n_micro
    )

    return shard_map(
        jax.value_and_grad(loss_local),
        mesh=mesh,
        in_specs=(PARAM_SPECS, P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), PARAM_SPECS),
    )


# --- flax-module stages (VERDICT r2 #7: PP must compose with the model zoo)


def flax_stage_fn(module, **apply_kwargs) -> StageFn:
    """Adapt a flax module into a pipeline stage body.

    All stages run the SAME module (SPMD: one traced program per tick), so
    ``module`` is one block config — e.g. a ``QuantTransformerBlock`` — and
    per-stage weights live in the stage-stacked params. Modules with mutable
    collections (MoE aux losses, batch stats) are not supported as stages.
    """

    def fn(params, h):
        return module.apply({"params": params}, h, **apply_kwargs)

    return fn


def init_flax_stages(key, module, sample_h, n_stages: int, **apply_kwargs):
    """Init ``n_stages`` independent weight sets of ``module`` and stack them
    into the pipeline's stage-stacked pytree (leading axis = stage)."""
    keys = jax.random.split(key, n_stages)
    ps = [
        module.init({"params": k}, sample_h, **apply_kwargs)["params"]
        for k in keys
    ]
    return stack_stage_params(ps)


def make_flax_pipeline_lm(
    mesh: Mesh,
    *,
    block,
    embed,
    head,
    n_stages: int,
    n_micro: int,
    optimizer=None,
):
    """GPipe schedule over flax transformer blocks: a full causal-LM train
    step with ``embed -> [n_stages x block] -> head`` where the blocks are
    pipe-sharded flax modules (e.g. ``models.QuantTransformerBlock``) and
    embed/head are replicated flax modules.

    Returns ``(step_fn, place, init_params, init_opt, value_and_grad)``:

    * ``init_params(key, sample_toks)`` -> params pytree
      ``{"embed", "stages", "head"}`` (stages stage-stacked);
    * ``place(params)`` device_puts it with stages over the pipe axis;
    * ``step_fn(params, opt_state, (toks, targets))`` -> updated triple;
    * ``value_and_grad(params, toks, targets)`` -> (loss, grads), the
      shard_map'd pipelined program (for parity tests vs the sequential
      composition of the same blocks).
    """
    import optax

    from pytorch_quantize_impls_tpu.train.clipping import clip_quantized_weights
    from jax import shard_map

    if optimizer is None:
        optimizer = optax.chain(optax.adam(1e-3), clip_quantized_weights())

    stage_fn = flax_stage_fn(block, train=True)

    def init_params(key, sample_toks):
        ke, ks, kh = jax.random.split(key, 3)
        ep = embed.init({"params": ke}, sample_toks)["params"]
        h = embed.apply({"params": ep}, sample_toks)
        stages = init_flax_stages(ks, block, h[:1], n_stages, train=False)
        hp = head.init({"params": kh}, h)["params"]
        return {"embed": ep, "stages": stages, "head": hp}

    def loss_local(params, toks, targets):
        h = embed.apply({"params": params["embed"]}, toks)
        b, s, d = h.shape
        assert b % n_micro == 0, (b, n_micro)
        hm = h.reshape(n_micro, b // n_micro, s, d)
        out = pipeline_stages(
            stage_fn, params["stages"], hm, n_stages=n_stages
        )
        logits = head.apply(
            {"params": params["head"]}, out.reshape(b, s, d)
        ).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits)
        ce = -jnp.mean(jnp.take_along_axis(logp, targets[..., None], axis=-1))
        stage_id = jax.lax.axis_index(PIPE_AXIS)
        loss = jax.lax.psum(
            jnp.where(stage_id == n_stages - 1, ce, 0.0), PIPE_AXIS
        )
        return jax.lax.pmean(loss, DATA_AXIS)

    vag = shard_map(
        jax.value_and_grad(loss_local),
        mesh=mesh,
        in_specs=(PARAM_SPECS, P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), PARAM_SPECS),
    )

    def place(params):
        shardings = {
            "embed": jax.tree.map(
                lambda _: NamedSharding(mesh, P()), params["embed"]
            ),
            "stages": stage_param_shardings(params["stages"], mesh),
            "head": jax.tree.map(
                lambda _: NamedSharding(mesh, P()), params["head"]
            ),
        }
        return jax.device_put(params, shardings)

    @jax.jit
    def step(params, opt_state, batch):
        toks, targets = batch
        loss, grads = vag(params, toks, targets)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init_opt(params):
        return optimizer.init(params)

    return step, place, init_params, init_opt, vag


def make_pipeline_train_step(
    mesh: Mesh,
    *,
    n_stages: int,
    n_micro: int,
    stage_fn: StageFn = binary_stage_fn,
    optimizer=None,
):
    """(params, opt_state, batch) -> (params, opt_state, loss) over a
    (data, pipe) mesh: DP on batch, PP on stages, BinaryConnect STE + the
    clamp-after-step transform inside the same jit.

    Returns ``(step_fn, place, init_opt)`` where ``place(params)``
    device_puts the param pytree with stage leaves sharded over the pipe
    axis.
    """
    import optax

    from pytorch_quantize_impls_tpu.train.clipping import clip_quantized_weights

    if optimizer is None:
        optimizer = optax.chain(optax.adam(1e-3), clip_quantized_weights())

    smapped = make_pipeline_value_and_grad(
        mesh, n_stages=n_stages, n_micro=n_micro, stage_fn=stage_fn
    )

    def place(params):
        shardings = {
            "embed": jax.tree.map(
                lambda _: NamedSharding(mesh, P()), params["embed"]
            ),
            "stages": stage_param_shardings(params["stages"], mesh),
            "head": jax.tree.map(
                lambda _: NamedSharding(mesh, P()), params["head"]
            ),
        }
        return jax.device_put(params, shardings)

    @jax.jit
    def step(params, opt_state, batch):
        x, y = batch
        loss, grads = smapped(params, x, y)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init_opt(params):
        return optimizer.init(params)

    return step, place, init_opt
