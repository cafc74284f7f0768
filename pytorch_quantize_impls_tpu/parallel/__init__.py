"""Distribution layer — NEW scope, no reference counterpart (SURVEY.md §2
"Parallelism & communication components — reference has NONE").

Realization: a named device ``Mesh`` ("data", "model"), parameter
and batch ``NamedSharding`` rules, and jit/GSPMD train steps where XLA inserts
the collectives (psum for DP grads, all-gather for TP'd weights; NCCL over
NVLink on one GPU host).
Multi-host init and explicit shard_map collective-matmul live here too.
"""

from pytorch_quantize_impls_tpu.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    assert_host_sync,
    make_mesh,
    multihost_initialize,
)
from pytorch_quantize_impls_tpu.parallel.pipeline import (  # noqa: F401
    PIPE_AXIS,
    flax_stage_fn,
    init_flax_stages,
    init_pipeline_mlp,
    make_flax_pipeline_lm,
    make_pipe_mesh,
    make_pipeline_train_step,
    make_pipeline_value_and_grad,
    pipeline_stages,
    stack_stage_params,
)
from pytorch_quantize_impls_tpu.parallel.ring_attention import (  # noqa: F401
    full_attention,
    make_ring_attention,
    ring_attention_shard,
)
from pytorch_quantize_impls_tpu.parallel.ulysses import (  # noqa: F401
    make_ulysses_attention,
    ulysses_attention_shard,
)
from pytorch_quantize_impls_tpu.parallel.collective_matmul import (  # noqa: F401
    allgather_matmul,
    allgather_matmul_b1,
    allgather_matmul_q8,
    matmul_reducescatter,
    shard_packed_rows,
    tp_binary_dense,
)
from pytorch_quantize_impls_tpu.parallel.quantized_collectives import (  # noqa: F401
    comm_bytes_saved,
    make_quantized_dp_train_step,
    pmean_quantized,
    quantize_symmetric,
    ring_allreduce_quantized,
)
from pytorch_quantize_impls_tpu.parallel.sharding import (  # noqa: F401
    batch_sharding,
    make_sharded_eval_step,
    make_sharded_train_step,
    param_shardings,
    replicate,
    shard_batch,
    shard_train_state,
)
