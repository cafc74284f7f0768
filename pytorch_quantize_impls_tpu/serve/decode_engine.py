"""Slot-based continuous batching for autoregressive decode — NEW scope
(SURVEY.md §2 parallelism table mandates a continuous-batching service; the
reference has no serving at all). ``engine.py`` batches stateless classifier
requests; this engine batches STATEFUL decode: each request owns a slot in
one batched int8-quantized KV cache (models/transformer.py decode mode), and
every engine tick runs ONE jitted single-token step over all slots — new
requests join mid-flight via a batch=1 prefill inserted into their slot, so
short requests never wait for long ones (continuous batching, vLLM-style
scheduling without paging: slots are fixed-capacity cache rows).

Shape discipline: prompts are padded to power-of-two buckets so prefill
compiles once per bucket; the decode step has one static shape. Per-slot
cache cursors make right-padded prefill safe (see ``_cached_attention``).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pytorch_quantize_impls_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from pytorch_quantize_impls_tpu.serve.generate import _MUT, _sample


def _next_bucket(n: int, buckets: Sequence[int], max_len: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    # Prompt longer than every configured bucket but within the cache: pad to
    # the next power of two (capped at max_len) so prefill still compiles a
    # bounded number of shapes instead of failing with a broadcast error.
    b = 1
    while b < n:
        b *= 2
    return min(b, max_len)


def _is_cursor(path) -> bool:
    last = path[-1]
    return isinstance(last, jax.tree_util.DictKey) and "index" in str(last.key)


@dataclass
class DecodeStats:
    requests: int = 0
    steps: int = 0
    tokens: int = 0
    slot_occupancy: float = 0.0  # summed active fraction over steps

    @property
    def mean_occupancy(self) -> float:
        return self.slot_occupancy / self.steps if self.steps else 0.0


@dataclass
class _Slot:
    request: "_GenRequest"
    generated: list = field(default_factory=list)
    last_token: int = 0


@dataclass
class _GenRequest:
    prompt: np.ndarray
    max_new: int
    eos: Optional[int]
    future: Future
    t_submit: float = field(default_factory=time.perf_counter)


class DecodeEngine:
    """Continuous-batching generation server over a quantized-KV cache.

    ``model`` is a train-mode ``QuantTransformerLM`` (its decode twin is
    derived here); ``params`` its trained/init params. ``n_slots`` bounds
    concurrent sequences; each slot's cache row holds ``model.max_len``
    int8-quantized KV entries per layer.

    ``packed`` (optional): a ``infer.pack_model(model, ...)`` record — every
    quantized projection then dispatches to its packed-weight execution path
    (weights stay 1-8 bit in HBM; SURVEY.md §3.5 seam applied to decode).
    Pack with the TRAIN-mode model: module paths are identical in the decode
    twin, so the records line up.

    ``fused`` (optional): a ``infer.export_fused_decode(model, variables)``
    program — the engine then executes the FUSED decode step
    (infer/fused_decode.py: single-GEMM QKV, one-pass int8-cache attention
    kernel, threshold-folded FFN boundary) instead of interception-based
    dispatch. Exclusive with ``packed``/``mesh``; the slot/admit machinery
    is unchanged (the fused cache mirrors the flax cache leaf names). With
    ``fused``, ``model`` and ``params`` may be ``None``: the program carries
    its weights and ``max_len``, and the engine needs no flax.

    ``mesh`` (optional): a ``(data, model)`` device mesh — the decode step
    then runs under ``shard_map`` with SLOTS SHARDED OVER THE DATA AXIS:
    each device group owns ``n_slots / mesh.shape['data']`` cache rows and
    steps them locally (params replicated; packed kernels run on
    per-shard local arrays, which is why this is shard_map and not GSPMD —
    pallas_call is opaque to the XLA partitioner). This is the multi-device
    form of continuous batching mandated by BASELINE.json:5 ("across
    hosts"): when the data axis spans hosts, every host serves its slice of
    the slot pool in the same SPMD program. ``n_slots`` must be
    divisible by the data-axis size. Prefill stays per-request (batch=1,
    replicated) — only the steady-state step, where the FLOPs are, shards.
    """

    def __init__(
        self,
        model,
        params,
        *,
        packed=None,
        fused=None,
        n_slots: int = 8,
        prompt_buckets: Sequence[int] = (16, 32, 64, 128),
        temperature: float = 0.0,
        seed: int = 0,
        mesh: Optional[Mesh] = None,
    ):
        if fused is not None and (packed is not None or mesh is not None):
            raise ValueError("fused backend is exclusive with packed/mesh")
        if model is None and fused is None:
            raise ValueError("a model is required unless fused= is given")
        self._md = model.clone(decode=True) if model is not None else None
        self._fused = fused
        if fused is not None:
            # the fused program IS the weights: it rides through the jit
            # boundary as the params argument (an argument, not a closure
            # constant baked into the compiled program)
            params = fused
        self._mesh = mesh
        if mesh is not None:
            dsz = mesh.shape[DATA_AXIS]
            if n_slots % dsz:
                raise ValueError(
                    f"n_slots ({n_slots}) must divide over the data axis ({dsz})"
                )
            params = jax.device_put(params, NamedSharding(mesh, P()))
        self._params = params
        self._n_slots = n_slots
        self._max_len = (fused if fused is not None else model).max_len
        self._buckets = sorted(b for b in prompt_buckets if b <= self._max_len)
        if not self._buckets:
            raise ValueError("no prompt bucket fits the model's max_len")
        self._temperature = temperature
        self._key = jax.random.PRNGKey(seed)
        self._packed = packed

        md = self._md

        def _apply(variables, toks):
            if fused is not None:
                from pytorch_quantize_impls_tpu.infer.fused_decode import (
                    fused_decode_apply,
                )

                return fused_decode_apply(
                    variables["params"], variables.get("cache"), toks
                )
            if packed is None:
                return md.apply(variables, toks, train=False, mutable=_MUT)
            from pytorch_quantize_impls_tpu.infer.packed import packed_apply

            return packed_apply(md, variables, packed, toks, mutable=_MUT)

        self._apply_any = _apply

        @jax.jit
        def _prefill(params, toks):
            logits, st = _apply({"params": params}, toks)
            return logits[0], st["cache"]

        def _step_body(params, cache, toks, active, key):
            logits, st = _apply({"params": params, "cache": cache}, toks[:, None])
            nxt = _sample(logits[:, 0], temperature, key)
            # Idle slots run the dummy token like everyone else (one static
            # shape), but their cursors are pinned to 0 so their state never
            # depends on OOB-scatter-drop semantics; admit fully rewrites
            # the row anyway (ADVICE r2).
            cache2 = jax.tree_util.tree_map_with_path(
                lambda p, leaf: (
                    jnp.where(active, leaf, 0) if _is_cursor(p) else leaf
                ),
                st["cache"],
            )
            return nxt, cache2

        if mesh is None:
            _step = jax.jit(_step_body)
            self._step_extra = ()
        else:
            # DP over slots: each data-shard steps its local cache rows.
            # With a model axis > 1 AND packed weights, the packed buffers
            # additionally ride as column-sharded arguments and every dense
            # GEMM runs tensor-parallel (local N-shard + tiled all-gather)
            # — packed low-bit weights tensor-sharded over the mesh.
            tp = packed is not None and mesh.shape.get(MODEL_AXIS, 1) > 1
            tp_axis = MODEL_AXIS if tp else None

            def _sharded_body(params, cache, toks, active, key, packed_arg):
                # decorrelate sampling across shards
                key = jax.random.fold_in(key, jax.lax.axis_index(DATA_AXIS))
                from pytorch_quantize_impls_tpu.infer.packed import (
                    packed_apply,
                )

                if packed_arg:
                    logits, st = packed_apply(
                        md, {"params": params, "cache": cache}, packed_arg,
                        toks[:, None], tp_axis=tp_axis, mutable=_MUT,
                    )
                else:
                    logits, st = md.apply(
                        {"params": params, "cache": cache}, toks[:, None],
                        train=False, mutable=_MUT,
                    )
                nxt = _sample(logits[:, 0], temperature, key)
                cache2 = jax.tree_util.tree_map_with_path(
                    lambda p, leaf: (
                        jnp.where(active, leaf, 0) if _is_cursor(p) else leaf
                    ),
                    st["cache"],
                )
                return nxt, cache2

            if packed is None:
                packed_specs = P()  # empty-pytree placeholder
                self._step_extra = ({},)
            elif tp:
                from pytorch_quantize_impls_tpu.infer.packed import (
                    packed_tp_specs,
                )

                packed_specs = packed_tp_specs(packed, MODEL_AXIS)
                self._step_extra = (packed,)
            else:
                packed_specs = jax.tree.map(lambda _: P(), packed)
                self._step_extra = (packed,)

            _step = jax.jit(
                jax.shard_map(
                    _sharded_body,
                    mesh=mesh,
                    in_specs=(
                        P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(),
                        packed_specs,
                    ),
                    out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
                    check_vma=False,
                )
            )

        self._prefill = _prefill
        self._step = _step
        self._cache = self._fresh_cache()
        self._stats_lock = threading.Lock()  # per-instance, not shared
        self._slots: list = [None] * n_slots
        self._queue: "queue.Queue[Optional[_GenRequest]]" = queue.Queue()
        self.stats = DecodeStats()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API ---------------------------------------------------------

    def submit(self, prompt, max_new: int, eos: Optional[int] = None) -> Future:
        """Enqueue a prompt (1-D int tokens); Future resolves to the 1-D
        int32 array of generated tokens (stops early at ``eos``, included)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if prompt.size + max_new > self._max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds the "
                f"cache capacity ({self._max_len})"
            )
        req = _GenRequest(prompt=prompt, max_new=max_new, eos=eos, future=Future())
        self._queue.put(req)
        return req.future

    def __call__(self, prompt, max_new: int, eos: Optional[int] = None):
        return self.submit(prompt, max_new, eos).result()

    def shutdown(self) -> None:
        self._running = False
        self._queue.put(None)
        self._thread.join(timeout=30)

    # -- internals ----------------------------------------------------------

    def _fresh_cache(self):
        """Batched (n_slots) cache pytree, all cursors at 0."""
        if self._fused is not None:
            from pytorch_quantize_impls_tpu.infer.fused_decode import (
                fused_init_cache,
            )

            return fused_init_cache(self._fused, self._n_slots)
        dummy = jnp.zeros((self._n_slots, 1), jnp.int32)
        _, st = self._md.apply(
            {"params": self._params}, dummy, train=False, mutable=_MUT
        )

        def reset(path, leaf):
            return jnp.zeros_like(leaf) if _is_cursor(path) else leaf

        return jax.tree_util.tree_map_with_path(reset, st["cache"])

    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def _admit(self, req: _GenRequest, slot_idx: int) -> None:
        """Batch=1 bucketed prefill, insert into the batched cache row."""
        L = int(req.prompt.size)
        bucket = _next_bucket(L, self._buckets, self._max_len)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :L] = req.prompt
        logits, cache1 = self._prefill(self._params, jnp.asarray(toks))
        first = int(
            _sample(logits[L - 1][None], self._temperature, self._next_key())[0]
        )

        i = slot_idx

        def insert(path, bleaf, sleaf):
            if _is_cursor(path):
                return bleaf.at[i].set(L)  # true length, not the bucket
            return bleaf.at[i].set(sleaf[0])

        self._cache = jax.tree_util.tree_map_with_path(
            insert, self._cache, cache1
        )
        slot = _Slot(request=req, last_token=first)
        self._slots[i] = slot
        self._emit(slot, first)

    def _emit(self, slot: _Slot, token: int) -> None:
        slot.generated.append(token)
        req = slot.request
        done = len(slot.generated) >= req.max_new or (
            req.eos is not None and token == req.eos
        )
        if done:
            req.future.set_result(np.asarray(slot.generated, np.int32))
            self._slots[self._slots.index(slot)] = None
            with self._lock_stats():
                self.stats.requests += 1
                self.stats.tokens += len(slot.generated)

    def _lock_stats(self):
        return self._stats_lock

    def _loop(self) -> None:
        while self._running:
            # admit whatever is waiting into free slots
            while None in self._slots:
                block = all(s is None for s in self._slots)
                try:
                    req = self._queue.get(block=block, timeout=0.1 if block else None)
                except queue.Empty:
                    break
                if req is None:
                    self._running = False
                    break
                try:
                    self._admit(req, self._slots.index(None))
                except Exception as e:  # deliver failures, keep serving
                    req.future.set_exception(e)
            active = [s for s in self._slots if s is not None]
            if not active or not self._running:
                continue
            toks = jnp.asarray(
                [s.last_token if s is not None else 0 for s in self._slots],
                jnp.int32,
            )
            mask = jnp.asarray(
                [s is not None for s in self._slots], jnp.bool_
            )
            nxt, self._cache = self._step(
                self._params, self._cache, toks, mask, self._next_key(),
                *self._step_extra,
            )
            nxt = np.asarray(nxt)
            with self._lock_stats():
                self.stats.steps += 1
                self.stats.slot_occupancy += len(active) / self._n_slots
            for i, s in enumerate(list(self._slots)):
                if s is not None:
                    s.last_token = int(nxt[i])
                    self._emit(s, int(nxt[i]))
        # drain: fail anything still queued or in flight
        for s in self._slots:
            if s is not None and not s.request.future.done():
                s.request.future.set_exception(RuntimeError("engine shutdown"))
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                req.future.set_exception(RuntimeError("engine shutdown"))
