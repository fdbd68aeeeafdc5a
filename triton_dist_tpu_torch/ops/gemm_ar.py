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

The operands carry every rank of the mesh; over one axis of a larger mesh
the reduction runs in each group of ranks that share their other
coordinates, every group in the one launch. An ``(outer, inner)`` tuple
axis is JAX's hierarchical form (:237-247): this op on the inner axis,
then :func:`~triton_dist_tpu_torch.ops.allreduce.all_reduce` of its
result on the outer axis (the one-shot kernel at decode sizes, the
reduce-scatter and all-gather kernels above 1 MiB); at ``n_o == 1`` the
inner result is returned. The context keeps JAX's block names and
divisibility contract.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext, axis_names
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

VARIANTS = ("ll", "one_shot")
FAULTS = {"drop_partial": 1, "lost_signal": 2}

# ``KERNEL.launches`` counts launches of the CUDA kernel (both variants),
# ``VARIANT_LAUNCHES`` the same launches by variant.
VARIANT_LAUNCHES = {v: 0 for v in VARIANTS}
KERNEL = CudaKernel("gemm_ar.cu", "tdt_gemm_ar_bf16",
                    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                    + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
                    + [ctypes.c_uint64] * 2 + [ctypes.c_int])


@dataclasses.dataclass(frozen=True)
class GemmARContext:
    mesh: MeshContext
    axis: object = "tp"      # one axis, or an (outer, inner) tuple
    block_n: int = 512
    block_k: int = 512
    out_dtype: Optional[torch.dtype] = None
    variant: str = "ll"


def _check_ported(ctx: GemmARContext) -> None:
    if ctx.variant not in VARIANTS:
        raise ValueError(f"unknown gemm_ar variant {ctx.variant!r} "
                         "(expected 'll' or 'one_shot')")
    tp_gemm.check_axis("gemm_ar", ctx.mesh, ctx.axis, groups=True)


def create_gemm_ar_context(mesh: MeshContext, axis="tp",
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


def gemm_ar_ref(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
                n: int = None, stride: int = 1) -> torch.Tensor:
    """Plain version: each rank's fp32 partial, summed in slot order over
    its group (``n`` ranks ``stride`` apart; default: every rank) and
    rounded once to ``out_dtype``; every rank's copy of its group's
    result."""
    parts = torch.stack([tp_gemm.mm_f32(a[r], b[r])
                         for r in range(a.shape[0])])
    v = tp_gemm.group_view(parts, n or a.shape[0], stride)
    acc = v[:, 0]
    for p in range(1, v.shape[1]):
        acc = acc + v[:, p]
    out = acc.to(out_dtype or a.dtype).unsqueeze(1).expand(v.shape)
    return out.reshape(parts.shape)


def gemm_ar(a: torch.Tensor, b: torch.Tensor, ctx: GemmARContext, *,
            fault: int = 0, timeout_s: float = shmem.TIMEOUT_S,
            check: bool = False) -> torch.Tensor:
    """Every rank's ``a[r] @ b[r].T`` all-reduced over ``ctx.axis``: ``(R,
    M, N)`` in ``ctx.out_dtype`` (or a's), R every rank of the mesh.
    ``fault`` (a value of :data:`FAULTS`; on a tuple axis it goes to the
    inner hop), ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    _check_ported(ctx)
    mesh = ctx.mesh
    if len(axis_names(ctx.axis)) == 2:
        from triton_dist_tpu_torch.ops.allreduce import all_reduce

        outer, inner = ctx.axis
        out = gemm_ar(a, b, dataclasses.replace(ctx, axis=inner),
                      fault=fault, timeout_s=timeout_s, check=check)
        if mesh.size(outer) == 1:
            return out
        return all_reduce(out, ctx=mesh, axis=outer, timeout_s=timeout_s,
                          check=check)
    nr, n, st = mesh.n_ranks, mesh.size(ctx.axis), mesh.stride(ctx.axis)
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != nr
            or b.shape[0] != nr or a.shape[2] != b.shape[2]):
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)}: expected "
                         f"(R={nr}, M, K_loc) and (R, N, K_loc)")
    _, m, k_loc = a.shape
    n_dim = b.shape[1]
    ar_blocks(ctx.block_n, ctx.block_k, n_dim, k_loc)
    out_dtype = ctx.out_dtype or a.dtype
    if a.device.type == "cpu":
        return gemm_ar_ref(a, b, out_dtype=out_dtype, n=n, stride=st)
    tp_gemm.check_operands("gemm_ar", a, b, out_dtype)
    dev = a.device
    tm, tn = tp_gemm.tile(KERNEL, m)
    n_rb, n_cb = -(-m // tm), -(-n_dim // tn)
    ws = shmem.workspace("gemm_ar", (m, n_dim, n, st), n=nr,
                         n_flags=nr * n * n_rb * n_cb, device=dev,
                         data_shape=(n, m, n_dim))
    out = torch.empty((nr, m, n_dim), dtype=out_dtype, device=dev)

    where = tp_gemm.hop_name(mesh, ctx.axis)

    def describe(rank, step, slot):
        src, t = divmod(slot % (n * n_rb * n_cb), n_rb * n_cb)
        return (f"gemm_ar ({ctx.variant}) over {where}: rank {rank} waited "
                f"for rank {mesh.device_id(ctx.axis, src, rank)}'s partial "
                f"of tile {divmod(t, n_cb)} (gather slot {src}, flag slot "
                f"{slot}) past {timeout_s} s")

    tp_gemm.launch(KERNEL, ws, describe, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), ws.data.data_ptr(), b.stride(0),
                   b.stride(1), nr, n, st, m, n_dim, k_loc,
                   int(ctx.variant == "ll"), device=dev,
                   timeout_s=timeout_s, fault=fault, check=check)
    VARIANT_LAUNCHES[ctx.variant] += 1
    return out
