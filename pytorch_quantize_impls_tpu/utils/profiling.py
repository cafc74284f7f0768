"""Profiling (SURVEY.md §5 tracing row): jax.profiler traces viewable in
TensorBoard/Perfetto, ``jax.named_scope`` for labeling quant ops, and a
throughput/step timer for the scaling-efficiency metric."""

from __future__ import annotations

import contextlib
import glob
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace: ``with trace('/tmp/prof'): run_steps()``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


named_scope = jax.named_scope  # re-export: label quant ops in traces

# Published dense peaks per device kind (NVIDIA's H100 SXM data sheet, no
# sparsity): the roofline denominators. A device missing here has no peak;
# callers report "not measured" or refuse, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int8_ops": 1979e12, "bf16_flops": 989e12, "tf32_flops": 495e12,
        "fp32_flops": 67e12, "hbm_bytes": 3.35e12,
    },
}


@dataclass
class StepTimer:
    """Wall-clock step timer with warmup skip; feeds images/s and the
    >=85% scaling-efficiency check (BASELINE.json:5)."""

    warmup: int = 3
    _times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None
    _seen: int = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(dt)

    @property
    def mean_s(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean_s if self._times else float("nan")


def device_kernels(logdir: str) -> Dict[str, Tuple[int, float]]:
    """Per kernel (or copy) name in a profiler trace's device planes: the
    number of launches and their summed duration in ns. Empty when the
    trace has no device plane (a CPU run)."""
    out: Dict[str, Tuple[int, float]] = {}
    for path in glob.glob(os.path.join(logdir, "**", "*.xplane.pb"), recursive=True):
        for plane in jax.profiler.ProfileData.from_file(path).planes:
            if plane.name.startswith("/device:"):
                for line in plane.lines:
                    for ev in line.events:
                        n, ns = out.get(ev.name, (0, 0))
                        out[ev.name] = (n + 1, ns + ev.duration_ns)
    return out


def device_busy_ns(logdir: str) -> float:
    """Summed durations of the device events in a profiler trace: the time
    the accelerator's streams were executing kernels or copies. 0 when the
    trace has no device plane (a CPU run)."""
    return sum(ns for _, ns in device_kernels(logdir).values())


def device_time(fn, arg_sets, *, repeats: int = 3) -> float:
    """Device seconds per call of ``fn``, from a profiler trace.

    Runs ``jax.jit(fn)`` on every argument set (distinct sets keep one
    call's operands out of the cache for the next) ``repeats`` times inside
    a trace, after a warm-up that compiles, and divides the device's busy
    time by the number of calls. Host dispatch, which on a busy host can
    exceed a small kernel's time many times over, is not counted. Returns
    NaN when the trace has no device plane (a CPU run).
    """
    jitted = jax.jit(fn)
    for a in arg_sets:
        jax.block_until_ready(jitted(*a))
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir):
            for _ in range(repeats):
                for a in arg_sets:
                    jax.block_until_ready(jitted(*a))
        busy = device_busy_ns(logdir)
    return busy / 1e9 / (repeats * len(arg_sets)) if busy else float("nan")
