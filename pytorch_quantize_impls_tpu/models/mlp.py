"""MLPs for MNIST (BASELINE config 1; reference ``QuantTorch/nets/`` MLP,
SURVEY.md §2-L2: 784-512-512-10 style).

``BinaryConnectMLP`` binarizes weights only (BinaryConnect, arXiv:1511.00363);
all layers are binarized with BatchNorm between them, as in the paper. An
fp32 twin (``quantized=False``) serves the Δ-accuracy parity runs.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import flax.linen as fnn
import jax.numpy as jnp

from pytorch_quantize_impls_tpu import nn as qnn


class MLP(fnn.Module):
    """Generic quantized MLP: [Dense -> BatchNorm -> ReLU]* -> Dense."""

    features: Sequence[int] = (512, 512, 10)
    # bin | bin_stoch | ternary | ternary_stoch | dorefa | log | lin |
    # elastic | fp32
    layer: str = "bin"
    bits: int = 4
    # DoReFa-only knobs (paper notation W{bits}A{a_bits}G{g_bits}): input
    # activation quantization and train-time gradient quantization. g_bits
    # needs a 'quant' rng at apply time (fresh stochastic-rounding noise per
    # step — arXiv:1606.06160 eq. 12).
    a_bits: int = 0
    g_bits: int = 0
    a_quant: str = "fixed"  # dorefa input-quant flavor: fixed clip | pact
    fsr: float = 1.0
    # Elastic-only: grid for the sown penalty (nn/elastic.py).
    elastic_grid: str = "binary"
    use_batchnorm: bool = True
    # Mixed precision: compute dtype for matmuls/BN (e.g. jnp.bfloat16 for
    # the tensor cores' fast path); fp32 master weights are unaffected — quantizers
    # always read the fp32 masters, only the GEMM inputs are cast.
    dtype: Optional[Any] = None
    # Output layer scheme. None -> same as `layer`, EXCEPT stochastic
    # schemes default to their deterministic twin: a stochastically
    # re-drawn head emits noise logits of std ~sqrt(fan_in) that swamp the
    # CE loss signal and stall training (measured: digits eval 0.08 with a
    # stochastic head vs 0.73+ with a deterministic one).
    head_layer: Optional[str] = None

    def _dense(self, kind: str, f: int, name: str):
        dt = dict(dtype=self.dtype, name=name)
        if kind == "bin":
            return qnn.LinearBin(features=f, **dt)
        if kind == "bin_stoch":
            return qnn.LinearBin(features=f, deterministic=False, **dt)
        if kind == "ternary":
            return qnn.LinearTer(features=f, **dt)
        if kind == "ternary_stoch":
            return qnn.LinearTer(features=f, deterministic=False, **dt)
        if kind == "dorefa":
            return qnn.LinearDorefa(
                features=f, bits=self.bits, a_bits=self.a_bits or None,
                g_bits=self.g_bits or None, a_quant=self.a_quant, **dt
            )
        if kind == "elastic":
            return qnn.ElasticLinear(
                features=f, grid=self.elastic_grid, fsr=self.fsr,
                bits=self.bits, **dt
            )
        if kind == "log":
            return qnn.LinearQuantLog(features=f, fsr=self.fsr, bits=self.bits, **dt)
        if kind == "lin":
            return qnn.LinearQuantLin(features=f, fsr=self.fsr, bits=self.bits, **dt)
        if kind == "fp32":
            return fnn.Dense(features=f, **dt)
        raise ValueError(f"unknown layer kind {kind!r}")

    @fnn.compact
    def __call__(self, x, train: bool = True):
        x = x.reshape((x.shape[0], -1))
        for i, f in enumerate(self.features[:-1]):
            layer = self._dense(self.layer, f, f"layer{i}")
            x = layer(x, train=train) if self.layer != "fp32" else layer(x)
            if self.use_batchnorm:
                x = fnn.BatchNorm(
                    use_running_average=not train, dtype=self.dtype, name=f"bn{i}"
                )(x)
            x = fnn.relu(x)
        head_kind = self.head_layer
        if head_kind is None:
            head_kind = {"bin_stoch": "bin", "ternary_stoch": "ternary"}.get(
                self.layer, self.layer
            )
        layer = self._dense(head_kind, self.features[-1], "head")
        x = layer(x, train=train) if head_kind != "fp32" else layer(x)
        return x


def BinaryConnectMLP(
    hidden: int = 512, classes: int = 10, *, deterministic: bool = True,
    quantized: bool = True,
) -> MLP:
    """BASELINE config 1: BinaryConnect MLP 784-512-512-10 on MNIST."""
    kind = "fp32" if not quantized else ("bin" if deterministic else "bin_stoch")
    return MLP(features=(hidden, hidden, classes), layer=kind)
