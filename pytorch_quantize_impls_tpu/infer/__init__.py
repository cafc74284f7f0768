"""Inference engine: the train(fake-quant) -> infer(packed) seam.

The reference has only a vestigial eval seam (``model.eval()`` freezing —
SURVEY.md §3.5); here eval-mode models are *exported* to bit-packed buffers +
scales and executed by the low-bit kernels:

    packed = infer.pack_model(model, variables, sample_x)   # once
    ready  = infer.prepare(packed)                          # decode hot bufs
    y      = infer.packed_apply(model, variables, ready, x) # fast path

``pack_model``/``packed_apply`` use flax method interception, so ANY flax
model built from this library's quantized layers works — no per-model export
code. ``save_packed``/``load_packed`` give the inference-only artifact format
(packed ints + scales + metadata; SURVEY.md §5 checkpoint row).

The fused programs (``fused_decode``, ``fused_chain``) need no flax to run:
names are resolved on first use, so serving an exported program does not
import the model layer.
"""

import importlib

_EXPORTS = {
    "packed": (
        "PackedLayer", "load_packed", "pack_model", "packed_apply", "prepare",
        "save_packed",
    ),
    "fused_chain": (
        "FusedChain", "export_fused_chain", "export_fused_lenet",
        "export_fused_resnet20", "fused_apply", "fused_resnet_apply",
    ),
    "fused_decode": (
        "FusedDecodeModel", "export_fused_decode", "fused_decode_apply",
        "fused_init_cache",
    ),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE) + ["host_export"]


def __getattr__(name):
    if name == "host_export":
        return importlib.import_module(f"{__name__}.host_export")
    if name in _WHERE:
        mod = importlib.import_module(f"{__name__}.{_WHERE[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
