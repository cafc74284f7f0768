"""Low-bit execution kernels: the TRUE low-bit path.

NEW scope — the reference computes fake-quant on fp32 tensors through
cuBLAS/cuDNN (SURVEY.md §2 "Native-kernel components — reference has NONE");
BASELINE.json:5 mandates real packed execution. Weights are stored packed
(planar 1/2/4-bit codes, ``ops.pack.pack_bitplanes``) and multiplied as
int8 codes with int32 accumulation.

Every public wrapper dispatches from what it can observe
(``common.platform()`` and the shapes): on the GPU it runs a compiled Pallas
kernel (Triton route) where that kernel beat the plain XLA form end to end,
and the plain form elsewhere; on the CPU it runs the plain form. Two
hand-written kernels remain, both for the decode step:

* ``binary_gemm`` at decode-sized M — 1-bit weights cross HBM as bit planes;
* ``decode_attention`` — split-cache attention over the int8 KV cache.

PERF.md records each kernel's time on the card beside its plain rival.
The CPU tests run the kernels themselves (``_binary_gemm_triton``,
``_decode_attention_triton``) in the Pallas interpreter.
"""

from pytorch_quantize_impls_tpu.kernels.xnor_gemm import (  # noqa: F401
    binarize_to_int8,
    binary_gemm,
    binary_gemm_decoded,
    binary_gemm_reference,
    decode_binary_weights,
    pack_binary_weights,
)
from pytorch_quantize_impls_tpu.kernels.int8_matmul import (  # noqa: F401
    int8_gemm,
    int8_gemm_reference,
)
from pytorch_quantize_impls_tpu.kernels.packed_matmul import (  # noqa: F401
    decode_dorefa_weights,
    dorefa_act_to_int8,
    dorefa_gemm,
    dorefa_gemm_decoded,
    dorefa_gemm_reference,
    pack_dorefa_weights,
)
from pytorch_quantize_impls_tpu.kernels.shift_matmul import (  # noqa: F401
    decode_log_weights,
    pack_log_weights,
    shift_gemm,
    shift_gemm_decoded,
    shift_gemm_reference,
)
from pytorch_quantize_impls_tpu.kernels.conv import packed_conv2d  # noqa: F401
from pytorch_quantize_impls_tpu.kernels.decode_attention import (  # noqa: F401
    decode_attention,
)
