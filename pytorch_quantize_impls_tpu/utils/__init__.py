"""Aux subsystems (SURVEY.md §5): checkpoint/resume (orbax), profiling,
metrics/logging, run configs and the compile cache. The reference has none
of these. ``CheckpointManager`` imports orbax on first use, so the rest of
the package runs where orbax is not installed."""

from pytorch_quantize_impls_tpu.utils.metrics import MetricsWriter  # noqa: F401
from pytorch_quantize_impls_tpu.utils.profiling import (  # noqa: F401
    StepTimer,
    trace,
)
from pytorch_quantize_impls_tpu.utils.config import (  # noqa: F401
    RunConfig,
    SCHEME_CONFIGS,
)
from pytorch_quantize_impls_tpu.utils import native  # noqa: F401
from pytorch_quantize_impls_tpu.utils.compile_cache import (  # noqa: F401
    enable_compile_cache,
)


def __getattr__(name):
    if name == "CheckpointManager":
        from pytorch_quantize_impls_tpu.utils.checkpoint import CheckpointManager

        return CheckpointManager
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
