#!/usr/bin/env python
"""Merge per-platform accuracy_sweep JSON outputs into ACCURACY.md.

The sweep runs in two batches on this machine (CPU-runnable configs on host,
CIFAR-scale configs on the accelerator); this stitches the rows into the single
report the BASELINE Δacc <= 0.5% contract is judged on, with explicit data
provenance per row (SURVEY.md §0: no real MNIST/CIFAR on this image — the
`binaryconnect_digits` row is the real-data anchor).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ORDER = [
    "binaryconnect_mlp",
    "bnn_lenet",
    "xnor_cifar",
    "dorefa_resnet20",
    "dorefa_resnet20_w4",
    "logquant_vgg",
    "binaryconnect_digits",
    "xnor_digits",
    "xnor_digits_a1",
]

DATA = {
    "xnor_digits": "REAL (sklearn optdigits)",
    "xnor_digits_a1": "REAL (sklearn optdigits)",
    "binaryconnect_mlp": "synthetic MNIST stand-in",
    "bnn_lenet": "synthetic MNIST stand-in",
    "xnor_cifar": "synthetic CIFAR-10 stand-in",
    "dorefa_resnet20": "synthetic CIFAR-10 stand-in",
    "dorefa_resnet20_w4": "synthetic CIFAR-10 stand-in",
    "logquant_vgg": "synthetic CIFAR-10 stand-in",
    "binaryconnect_digits": "REAL (sklearn optdigits)",
}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("inputs", nargs="+",
                   help="json files as platform=path, e.g. cpu=/tmp/a.json")
    p.add_argument("--out", default="ACCURACY.md")
    p.add_argument("--gate", type=float, default=0.005)
    a = p.parse_args()

    rows = {}
    for spec in a.inputs:
        platform, path = spec.split("=", 1)
        for r in json.loads(Path(path).read_text()):
            r["platform"] = platform
            rows[r["config"]] = r

    ordered = [rows[c] for c in ORDER if c in rows] + [
        r for c, r in sorted(rows.items()) if c not in ORDER
    ]
    fails = [r for r in ordered if r["delta_acc"] < -a.gate]

    lines = [
        "# ACCURACY — Δ-accuracy report (BASELINE.json:5: Δacc ≤ 0.5% "
        "vs the fp32 twin at identical bit-widths)",
        "",
        "Each config trains to its full step budget twice — quantized and as "
        "an architecture-identical fp32 twin — with the same cosine-decay "
        "Adam + clamp-after-step schedule, then evaluates on the full test "
        "split (`scripts/accuracy_sweep.py`; merged by "
        "`scripts/merge_accuracy.py`).",
        "",
        "Data provenance: no real MNIST/CIFAR-10 exists on this machine and "
        "there is no network egress (SURVEY.md §0), so those configs train "
        "on the deterministic synthetic stand-ins "
        "(`data/datasets.py::synthetic_image_classification`). The r4 task is "
        "DISCRIMINATIVE (VERDICT r3 #1): shared-parts compositional class "
        "templates + per-sample circular shifts + calibrated noise, tuned "
        "so the fp32 twins land at ~0.80-0.95 instead of saturating at "
        "1.0000 — a Δacc gate both twins ace proves nothing. The digits "
        "rows are the real-data anchors (sklearn's bundled UCI optdigits, "
        "1797 real handwritten digit images), including the full-XNOR "
        "W1A1 row (`xnor_digits_a1`). Re-run with `$QTPU_DATA_DIR` "
        "pointing at real MNIST/CIFAR to reproduce on canonical data.",
        "",
        "| config | bits | platform | data | quant acc | fp32 acc | Δacc | "
        f"gate ±{a.gate:.3f} |",
        "|---|---|---|---|---|---|---|---|",
    ]
    bits = {
        "binaryconnect_mlp": "W1",
        "bnn_lenet": "W1A1",
        "xnor_cifar": "W1A1+α",
        "dorefa_resnet20": "W4A4",
        "dorefa_resnet20_w4": "W4 (weights only)",
        "logquant_vgg": "W4 log",
        "binaryconnect_digits": "W1",
        "xnor_digits": "W1+α (BWN)",
        "xnor_digits_a1": "W1A1+α (full XNOR)",
    }
    for r in ordered:
        ok = "PASS" if r["delta_acc"] >= -a.gate else "FAIL"
        lines.append(
            f"| {r['config']} | {bits.get(r['config'], '?')} "
            f"| {r['platform']} | {DATA.get(r['config'], '?')} "
            f"| {r['quant_acc']:.4f} | {r['fp32_acc']:.4f} "
            f"| {r['delta_acc']:+.4f} | {ok} |"
        )
    lines += [
        "",
        f"Result: {len(ordered) - len(fails)}/{len(ordered)} configs within "
        "the gate."
        + ("" if not fails else
           " FAILING: " + ", ".join(r["config"] for r in fails)),
        "",
    ]
    Path(a.out).write_text("\n".join(lines))
    print("\n".join(lines))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
