"""Quantized training & inference engine in JAX.

A brand-new (JAX / XLA / Pallas / jit+sharding) framework with the
capabilities of the reference repo ``Enderdead/Pytorch_Quantize_impls``
(a.k.a. *QuantTorch* — see ``SURVEY.md``): the full low-bit scheme zoo

* BinaryConnect / BNN sign binarization (deterministic & stochastic),
* TernaryConnect,
* XNOR-Net per-channel scale factors,
* DoReFa k-bit weight / activation / gradient quantization,
* linear-FSR and log-domain (power-of-2) quantization,
* elastic (loss-based) quantization penalties,

implemented as straight-through-estimator ``jax.custom_vjp`` fake-quant
primitives for training (``ops``), bit-packing utilities (``ops.pack``),
packed low-bit kernels executing the *true* low-bit path (``kernels``), neural-net
layers (``nn``), model zoo (``models``), sharded training (``train`` +
``parallel``), and a continuous-batching inference engine (``serve``).

Reference parity map: reference layer L0 (``QuantTorch/functions/``) -> ``ops``;
L1 (``QuantTorch/layers/``) -> ``nn``; L2 (``QuantTorch/nets/``) -> ``models``.
The reference has no kernels / distribution / serving; those are new scope
mandated by ``BASELINE.json:5``.
"""

__version__ = "0.1.0"

from pytorch_quantize_impls_tpu import ops  # noqa: F401
