"""Fused GEMM + all-reduce, the small-M (decode) row-linear forward
(counterpart of ``triton_dist_tpu/ops/gemm_ar.py``: ``GemmARContext``,
``create_gemm_ar_context``, ``gemm_ar`` and ``gemm_ar_ref``).

``a (n, M, K_loc)`` stacks every rank's K-shard and ``b (n, N, K_loc)``
every rank's row-parallel weight shard (a strided view,
:func:`~triton_dist_tpu_torch.ops.tp_gemm.row_shards`). Every rank ends
with the same sum over ranks, ``(n, M, N)``. On a CUDA tensor
:func:`gemm_ar` launches ``gemm_ar_kernel`` (``csrc/gemm_ar.cu``): each
rank pushes every output tile's fp32 partial into every rank's gather
slot and reduces the n slots, all ranks' thread blocks in one launch, in
the JAX variant's order (``"one_shot"``: every push, then every reduce;
``"ll"``: each column block's reduce one block behind the pushes). On a
CPU tensor it runs :func:`gemm_ar_ref`. Both add the partials in slot
order (rank 0's first) in fp32 and round once.

The context keeps JAX's block names and divisibility contract; tuple
axes (the hierarchical form over ``ops.allreduce``) raise, ROADMAP.md
queue B.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

VARIANTS = ("ll", "one_shot")
FAULTS = {"drop_partial": 1, "lost_signal": 2}

# ``KERNEL.launches`` counts launches of the CUDA kernel (both variants),
# ``VARIANT_LAUNCHES`` the same launches by variant.
VARIANT_LAUNCHES = {v: 0 for v in VARIANTS}
KERNEL = CudaKernel("gemm_ar.cu", "tdt_gemm_ar_bf16",
                    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                    + [ctypes.c_uint64] * 2 + [ctypes.c_int])


@dataclasses.dataclass(frozen=True)
class GemmARContext:
    mesh: MeshContext
    axis: str = "tp"
    block_n: int = 512
    block_k: int = 512
    out_dtype: Optional[torch.dtype] = None
    variant: str = "ll"


def _check_ported(ctx: GemmARContext) -> None:
    if ctx.variant not in VARIANTS:
        raise ValueError(f"unknown gemm_ar variant {ctx.variant!r} "
                         "(expected 'll' or 'one_shot')")
    if not isinstance(ctx.axis, str):
        raise ValueError("the hierarchical (outer, inner) gemm_ar is not "
                         "ported yet (ROADMAP.md queue B)")


def create_gemm_ar_context(mesh: MeshContext, axis: str = "tp",
                           block_n: int = 512, block_k: int = 512,
                           out_dtype=None,
                           variant: str = "ll") -> GemmARContext:
    ctx = GemmARContext(mesh=mesh, axis=axis, block_n=block_n,
                        block_k=block_k, out_dtype=out_dtype,
                        variant=variant)
    _check_ported(ctx)
    return ctx


def ar_blocks(block_n: int, block_k: int, n_dim: int, k_loc: int):
    """JAX's check (``gemm_ar`` :263-268): the clamped blocks must divide N
    and K_loc. Returns ``(tn, tk)``."""
    tn = min(block_n, n_dim)
    tk = min(block_k, k_loc)
    if n_dim % tn or k_loc % tk:
        raise ValueError(
            f"block sizes (block_n={tn}, block_k={tk}) must divide "
            f"(N={n_dim}, K_loc={k_loc})")
    return tn, tk


def gemm_ar_ref(a: torch.Tensor, b: torch.Tensor, *,
                out_dtype=None) -> torch.Tensor:
    """Plain version: each rank's fp32 partial, summed in slot order and
    rounded once to ``out_dtype``; every rank's copy of the result."""
    n = a.shape[0]
    acc = None
    for r in range(n):
        p = tp_gemm.mm_f32(a[r], b[r])
        acc = p if acc is None else acc + p
    return acc.to(out_dtype or a.dtype).expand(n, *acc.shape)


def gemm_ar(a: torch.Tensor, b: torch.Tensor, ctx: GemmARContext, *,
            fault: int = 0, timeout_s: float = shmem.TIMEOUT_S,
            check: bool = False) -> torch.Tensor:
    """Every rank's ``a[r] @ b[r].T`` all-reduced over the ranks: ``(n, M,
    N)`` in ``ctx.out_dtype`` (or a's). ``fault`` (a value of
    :data:`FAULTS`), ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    _check_ported(ctx)
    n = ctx.mesh.size(ctx.axis)
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != n or b.shape[0] != n
            or a.shape[2] != b.shape[2]):
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)}: expected "
                         f"(n={n}, M, K_loc) and (n, N, K_loc)")
    _, m, k_loc = a.shape
    n_dim = b.shape[1]
    ar_blocks(ctx.block_n, ctx.block_k, n_dim, k_loc)
    out_dtype = ctx.out_dtype or a.dtype
    if a.device.type == "cpu":
        return gemm_ar_ref(a, b, out_dtype=out_dtype)
    tp_gemm.check_operands("gemm_ar", a, b, out_dtype)
    dev = a.device
    tm, tn = tp_gemm.tile(KERNEL, m)
    n_rb, n_cb = -(-m // tm), -(-n_dim // tn)
    ws = shmem.workspace("gemm_ar", (m, n_dim), n=n,
                         n_flags=n * n * n_rb * n_cb, device=dev,
                         data_shape=(n, m, n_dim))
    out = torch.empty((n, m, n_dim), dtype=out_dtype, device=dev)

    def describe(rank, step, slot):
        src, t = divmod(slot % (n * n_rb * n_cb), n_rb * n_cb)
        return (f"gemm_ar ({ctx.variant}): rank {rank} waited for rank "
                f"{src}'s partial of tile {divmod(t, n_cb)} (gather slot "
                f"{src}, flag slot {slot}) past {timeout_s} s")

    tp_gemm.launch(KERNEL, ws, describe, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), ws.data.data_ptr(), b.stride(0),
                   b.stride(1), n, m, n_dim, k_loc,
                   int(ctx.variant == "ll"), device=dev,
                   timeout_s=timeout_s, fault=fault, check=check)
    VARIANT_LAUNCHES[ctx.variant] += 1
    return out
