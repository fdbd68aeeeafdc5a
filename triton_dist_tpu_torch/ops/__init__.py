"""Attention ops and their kernels (counterpart of ``triton_dist_tpu/ops``).

Each op with a CUDA kernel keeps its plain PyTorch version beside it (the
``*_ref`` functions): the op launches the kernel on a CUDA tensor and runs
the plain version on a CPU tensor. The sequence-parallel ops, the
one-sided puts and broadcast, and ``AllReduceMethod`` are exported here
under JAX's names (``triton_dist_tpu/ops/__init__.py``); the other modules
are imported by path.
"""

from triton_dist_tpu_torch.ops.a2a_gemm import (  # noqa: F401
    A2AGemmContext, a2a_gemm, a2a_gemm_fused, a2a_gemm_ref,
    create_a2a_gemm_context)
from triton_dist_tpu_torch.ops.allreduce import AllReduceMethod  # noqa: F401
from triton_dist_tpu_torch.ops.broadcast import (  # noqa: F401
    broadcast, broadcast_host, broadcast_ref)
from triton_dist_tpu_torch.ops.p2p import (  # noqa: F401
    p2p_put, p2p_put_host, ppermute_ref)
from triton_dist_tpu_torch.ops.sp_ag_attention import (  # noqa: F401
    sp_ag_attention, sp_ag_attention_2d, sp_ag_attention_fused,
    sp_ag_attention_ref)
from triton_dist_tpu_torch.ops.ulysses import (  # noqa: F401
    post_attn_a2a, pre_attn_a2a, ulysses_attn)
from triton_dist_tpu_torch.ops.ulysses_fused import (  # noqa: F401
    UlyssesFusedContext, create_ulysses_fused_context, group_o_rows,
    group_qkv_columns, o_a2a_gemm, qkv_gemm_a2a, ulysses_attn_fused)
