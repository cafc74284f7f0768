"""Autoregressive generation over the quantized-KV decode path — NEW scope
(the reference trains MLP/CNN classifiers only; SURVEY.md §5 records serving
as absent there). This is the LLM half of the serving story: ``engine.py``
does continuous batching for stateless classifiers; here we run stateful
decode with the int8-quantized KV cache (``models.transformer`` +
``ops.quantize_kv``).

Shape discipline: prefill is ONE full-prompt forward (big matmuls on the
tensor cores, cache filled in one ``dynamic_update_slice``); the decode loop is a
``lax.scan`` over single-token steps — traced once, static shapes, no
per-token Python dispatch. Greedy when ``temperature == 0``; otherwise
categorical sampling with an explicit PRNG key (JAX RNG threading, never
global state).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array
_MUT = ["cache", "losses"]  # MoE layers sow aux losses even at eval


def _sample(logits: Array, temperature: float, key: Array) -> Array:
    if temperature == 0.0:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return jax.random.categorical(
        key, logits.astype(jnp.float32) / temperature, axis=-1
    ).astype(jnp.int32)


def prefill(model, params, prompt: Array) -> Tuple[Array, dict]:
    """Run the whole prompt through the decode model in one forward.

    Returns ``(last_logits, cache)`` — the cache collection is created and
    filled for positions ``[0, prompt_len)``. ``model`` must already have
    ``decode=True`` (see :func:`decode_model`).
    """
    if prompt.shape[1] > model.max_len:
        raise ValueError(
            f"prompt length {prompt.shape[1]} exceeds cache capacity "
            f"max_len ({model.max_len})"
        )
    logits, st = model.apply(
        {"params": params}, prompt, train=False, mutable=_MUT
    )
    return logits[:, -1], st["cache"]


def decode_model(model):
    """Clone a ``QuantTransformerLM`` into its decode-mode twin (same params
    pytree; only the cache collection is added)."""
    return model.clone(decode=True)


@partial(jax.jit, static_argnums=(0, 3), static_argnames=("temperature",))
def generate(
    model,
    params,
    prompt: Array,
    n_new: int,
    key: Optional[Array] = None,
    temperature: float = 0.0,
) -> Array:
    """Generate ``n_new`` tokens after ``prompt`` (greedy by default).

    One jitted program: prefill + ``lax.scan`` of single-token decode steps.
    ``model`` is the TRAIN-mode module; its decode twin is derived here.
    Returns ``(batch, n_new)`` int32 tokens.
    """
    # Shape guard (trace-time: prompt shape and n_new are static). Past
    # capacity the cache scatter would silently drop writes under jit and
    # return wrong tokens, so fail loudly instead.
    if prompt.shape[1] + n_new > model.max_len:
        raise ValueError(
            f"prompt ({prompt.shape[1]}) + n_new ({n_new}) exceeds the "
            f"model's cache capacity max_len ({model.max_len})"
        )
    md = decode_model(model)
    if key is None:
        key = jax.random.PRNGKey(0)
    last_logits, cache = prefill(md, params, prompt)
    key, k0 = jax.random.split(key)
    tok0 = _sample(last_logits, temperature, k0)

    def step(carry, _):
        tok, cache, key = carry
        logits, st = md.apply(
            {"params": params, "cache": cache},
            tok[:, None],
            train=False,
            mutable=_MUT,
        )
        key, sk = jax.random.split(key)
        nxt = _sample(logits[:, -1], temperature, sk)
        return (nxt, st["cache"], key), tok

    (last, _, _), toks = jax.lax.scan(
        step, (tok0, cache, key), None, length=n_new - 1
    )
    toks = jnp.concatenate([toks, last[None]], axis=0)  # (n_new, b)
    return jnp.swapaxes(toks, 0, 1)
