"""All-reduce over simulated ranks (counterpart of
``triton_dist_tpu/ops/allreduce.py``: ``AllReduceMethod``,
``all_reduce_ref``, ``all_reduce`` and ``all_reduce_2d``).

``x`` (R, ...) stacks every rank's per-shard buffer, R being every rank of
the mesh; along ``axis`` every rank ends with its group's sum, (R, ...).
The method is JAX's choice (:func:`choose_method`): ``ONE_SHOT`` (row 5)
up to 1 MiB a rank, ``TWO_SHOT`` above it when dim 0 divides by the axis
size, which is :func:`~triton_dist_tpu_torch.ops.reduce_scatter.
reduce_scatter` (row 4) then :func:`~triton_dist_tpu_torch.ops.allgather.
all_gather` (row 1), as in JAX. At one rank along the axis it returns
``x``. On a CUDA tensor (bf16) ``ONE_SHOT`` is one cooperative launch of
``all_reduce_kernel`` (``csrc/collectives.cu``): every rank puts its
buffer into its slot of every peer's gather buffer and signals, then sums
the group's buffers in fp32 in position order and rounds once, so every
rank of a group holds the same bits; on a CPU tensor
:func:`all_reduce_ref`, the same sum. ``RECURSIVE`` (row 6, JAX's
precondition: n a power of two and dim 0 a multiple of n) is one
cooperative launch of ``rhd_kernel`` (bf16 or fp32): log2 n halving
steps, each rank putting half its region into its partner's receive
region and adding what arrives into the half it keeps, every sum rounded
to ``x.dtype`` as JAX's ``acc_v``/``tmp_v`` are, then log2 n doubling
steps putting the reduced chunks back; on a CPU tensor
:func:`all_reduce_rhd_ref`, the same tree of sums in the same order, so
every rank of a group ends with the same bits. JAX's ``tile_rows`` (a
VMEM budget) has no counterpart.

:func:`all_reduce_2d` is JAX's hierarchical composition of the three
(reduce-scatter on the inner axis, all-reduce across the outer one,
all-gather back) and has no kernel of its own.
"""

from __future__ import annotations

import ctypes
import enum

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.ops.allgather import all_gather
from triton_dist_tpu_torch.ops.reduce_scatter import reduce_scatter
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

FAULTS = {"drop_partial": 1, "lost_signal": 2}
TWO_SHOT_BYTES = 1 << 20      # JAX's threshold (:155)

# ``KERNEL.launches`` counts launches of the one-shot CUDA kernel,
# ``KERNEL_RHD.launches`` those of the recursive one; a ``TWO_SHOT`` call
# counts on the reduce-scatter and all-gather kernels.
KERNEL = CudaKernel("collectives.cu", "tdt_all_reduce_one_shot_bf16",
                    tp_gemm.COLLECTIVE_ARGTYPES)
KERNEL_RHD = CudaKernel("collectives.cu", "tdt_all_reduce_rhd",
                        tp_gemm.COLLECTIVE_ARGTYPES + [ctypes.c_int])


class AllReduceMethod(enum.Enum):
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"
    RECURSIVE = "recursive"


def choose_method(x: torch.Tensor, n: int) -> AllReduceMethod:
    """JAX's choice for a rank's buffer ``x[0]`` (:154-158): ``TWO_SHOT``
    above 1 MiB when dim 0 divides by ``n``, else ``ONE_SHOT``."""
    big = x[0].numel() * x.element_size() > TWO_SHOT_BYTES
    return (AllReduceMethod.TWO_SHOT if big and x.shape[1] % n == 0
            else AllReduceMethod.ONE_SHOT)


def all_reduce_ref(x: torch.Tensor, *, ctx: MeshContext,
                   axis: str = "tp") -> torch.Tensor:
    """Plain version: each group's sum in fp32 in position order, rounded
    once to ``x.dtype``, on every rank of the group."""
    n, st = tp_gemm.axis_groups(x, ctx, axis)
    v = tp_gemm.group_view(x, n, st)
    acc = v[:, 0].float()
    for p in range(1, n):
        acc = acc + v[:, p].float()
    return acc.to(x.dtype).unsqueeze(1).expand(v.shape).reshape(x.shape)


def all_reduce_rhd_ref(x: torch.Tensor, *, ctx: MeshContext,
                       axis: str = "tp") -> torch.Tensor:
    """Plain version of ``RECURSIVE``: at step s every position p of a
    group takes ``x.dtype(v[p] + v[p ^ n >> (s + 1)])`` (in fp32, rounded
    once a step), the kernel's halving tree; every rank of the group ends
    with the same sum."""
    n, st = tp_gemm.axis_groups(x, ctx, axis)
    v = tp_gemm.group_view(x, n, st)
    bit = n >> 1
    while bit:
        partner = [p ^ bit for p in range(n)]
        v = (v.float() + v[:, partner].float()).to(x.dtype)
        bit >>= 1
    return v.reshape(x.shape)


def all_reduce(x: torch.Tensor, *, ctx: MeshContext, axis: str = "tp",
               method=None, fault: int = 0,
               timeout_s: float = shmem.TIMEOUT_S,
               check: bool = False) -> torch.Tensor:
    """Every rank's all-reduce of ``x`` (R, ...) along ``axis`` → (R, ...).
    ``method``: an :class:`AllReduceMethod` or its value, None for JAX's
    choice. ``fault`` (a value of :data:`FAULTS`; in ``TWO_SHOT`` it goes
    to the reduce-scatter), ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    n, st = tp_gemm.axis_groups(x, ctx, axis)
    if n == 1:
        return x
    if isinstance(method, str):
        method = AllReduceMethod(method)
    if method is None:
        method = choose_method(x, n)
    kw = dict(ctx=ctx, axis=axis, timeout_s=timeout_s, check=check)
    if method == AllReduceMethod.TWO_SHOT:
        return all_gather(reduce_scatter(x, fault=fault, **kw), **kw)
    if method == AllReduceMethod.RECURSIVE:
        return _all_reduce_rhd(x, ctx=ctx, axis=axis, n=n, st=st,
                               fault=fault, timeout_s=timeout_s, check=check)
    if x.device.type == "cpu":
        return all_reduce_ref(x, ctx=ctx, axis=axis)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"all_reduce: the kernel adds bf16 (got {x.dtype})")
    c_bytes = x[0].numel() * x.element_size()
    out = torch.empty_like(x)
    where = tp_gemm.hop_name(ctx, axis)

    def describe(rank, step, slot, n_pc):
        return (f"all_reduce one_shot over {where}: rank {rank} waited for "
                f"piece {slot % n_pc} of group position {step}'s buffer "
                f"(flag slot {slot}) past {timeout_s} s")

    tp_gemm.launch_collective(KERNEL, x, out, chunk_bytes=c_bytes, n=n,
                              st=st, flags_per_rank=n, slots=n,
                              ctx=ctx, describe=describe, fault=fault,
                              timeout_s=timeout_s, check=check)
    return out


def _all_reduce_rhd(x, *, ctx, axis, n, st, fault, timeout_s, check):
    """``RECURSIVE``: the plain tree on a CPU tensor, else one launch of
    ``rhd_kernel``."""
    rows = x.shape[1]
    if n & (n - 1) or rows % n:           # JAX's precondition (:164-169)
        raise ValueError(
            f"RECURSIVE allreduce needs power-of-two ranks (n={n}) "
            f"and dim0 divisible by n (rows={rows})")
    if x.device.type == "cpu":
        return all_reduce_rhd_ref(x, ctx=ctx, axis=axis)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"all_reduce RECURSIVE: the kernel adds bf16 or fp32 "
                        f"(got {x.dtype})")
    c_bytes = x[0].numel() * x.element_size() // n
    out = torch.empty_like(x)
    where = tp_gemm.hop_name(ctx, axis)
    logn = n.bit_length() - 1

    def describe(rank, step, slot, n_pc):
        s = slot // (n_pc * n * ctx.n_ranks)
        c = slot // n_pc % n
        bit = n >> (s + 1) if s < logn else 1 << (2 * logn - 1 - s)
        src = ctx.device_id(axis, ctx.rank(axis, rank) ^ bit, rank)
        phase = (f"halving step {s}" if s < logn
                 else f"doubling step {s} (bit {2 * logn - 1 - s})")
        return (f"all_reduce recursive over {where}: rank {rank} waited at "
                f"{phase} for piece {slot % n_pc} of chunk {c} from rank "
                f"{src} (flag slot {slot}) past {timeout_s} s")

    tp_gemm.launch_collective(KERNEL_RHD, x, out, chunk_bytes=c_bytes, n=n,
                              st=st, flags_per_rank=2 * logn * n,
                              slots=n - 1, ctx=ctx, describe=describe,
                              fault=fault, timeout_s=timeout_s, check=check,
                              any_bytes=True, tail=(x.element_size(),))
    return out


def all_reduce_2d(x: torch.Tensor, *, ctx: MeshContext,
                  inner_axis: str = "tp", outer_axis: str = "dp",
                  outer_method="one_shot", timeout_s: float = shmem.TIMEOUT_S,
                  check: bool = False) -> torch.Tensor:
    """The sum over both axes, replicated (JAX :221): reduce-scatter on
    ``inner_axis``, all-reduce the shards across ``outer_axis`` with
    ``outer_method``, all-gather back on ``inner_axis``. ``x``'s dim 0
    must divide by the inner axis size."""
    ni, no = ctx.size(inner_axis), ctx.size(outer_axis)
    kw = dict(ctx=ctx, timeout_s=timeout_s, check=check)
    part = x
    if ni > 1:
        part = reduce_scatter(part, axis=inner_axis, **kw)
    if no > 1:
        part = all_reduce(part, axis=outer_axis, method=outer_method, **kw)
    if ni > 1:
        part = all_gather(part, axis=inner_axis, **kw)
    return part
