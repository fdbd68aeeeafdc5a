"""Reduce-scatter over simulated ranks (counterpart of
``triton_dist_tpu/ops/reduce_scatter.py``: ``reduce_scatter_ref`` and
``reduce_scatter``).

``x`` (R, n·c, ...) stacks every rank's per-shard (n·c, ...), R being every
rank of the mesh; along ``axis`` (size n) rank r ends with the sum over
its group of chunk ``me`` (its position), (R, c, ...). At one rank along
the axis it returns ``x``, as JAX does. On a CUDA tensor (bf16) it is one
cooperative launch of ``reduce_scatter_kernel`` (``csrc/collectives.cu``):
JAX's ring, in which chunk c's running sum starts at position c + 1 and
each rank adds its own chunk to the sum it received (own + received),
rounded to the input's type at every hop as JAX's receive buffers round
it; on a CPU tensor :func:`reduce_scatter_ref`, the same sums in the same
order, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

FAULTS = {"drop_partial": 1, "lost_signal": 2}

# ``KERNEL.launches`` counts launches of the CUDA kernel.
KERNEL = CudaKernel("collectives.cu", "tdt_reduce_scatter_ring_bf16",
                    tp_gemm.COLLECTIVE_ARGTYPES)


def _check(x: torch.Tensor, ctx: MeshContext, axis: str):
    n, st = tp_gemm.axis_groups(x, ctx, axis)
    if x.shape[1] % n:
        raise ValueError(f"dim0 {x.shape[1]} not divisible by axis size {n}")
    return n, st


def reduce_scatter_ref(x: torch.Tensor, *, ctx: MeshContext,
                       axis: str = "tp") -> torch.Tensor:
    """Plain version: the ring's sums in the ring's order, rounded to
    ``x.dtype`` at every hop."""
    n, st = _check(x, ctx, axis)
    v = tp_gemm.group_view(x, n, st)               # (A, n, st, n·c, ...)
    chunks = v.view(*v.shape[:3], n, x.shape[1] // n, *x.shape[2:])
    out = []
    for me in range(n):
        acc = chunks[:, (me + 1) % n, :, me]
        for j in range(2, n + 1):
            acc = (chunks[:, (me + j) % n, :, me].float()
                   + acc.float()).to(x.dtype)
        out.append(acc)
    return torch.stack(out, 1).reshape(x.shape[0], x.shape[1] // n,
                                       *x.shape[2:])


def reduce_scatter(x: torch.Tensor, *, ctx: MeshContext, axis: str = "tp",
                   mode: str = "ring", fault: int = 0,
                   timeout_s: float = shmem.TIMEOUT_S,
                   check: bool = False) -> torch.Tensor:
    """Every rank's reduce-scatter of ``x`` (R, n·c, ...) along ``axis``
    over dim 0 → (R, c, ...). ``fault`` (a value of :data:`FAULTS`),
    ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    if mode != "ring":
        raise ValueError(f"unknown reduce_scatter mode {mode!r}")
    n, st = tp_gemm.axis_groups(x, ctx, axis)
    if n == 1:
        return x
    _check(x, ctx, axis)
    if x.device.type == "cpu":
        return reduce_scatter_ref(x, ctx=ctx, axis=axis)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"reduce_scatter: the kernel adds bf16 (got "
                        f"{x.dtype})")
    c = x.shape[1] // n
    c_bytes = c * x[0, 0].numel() * x.element_size()
    out = torch.empty((x.shape[0], c, *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    where = tp_gemm.hop_name(ctx, axis)

    def describe(rank, step, slot, n_pc):
        return (f"reduce_scatter ring over {where}: rank {rank} waited at "
                f"ring step {step} for piece {slot % n_pc} of the running "
                f"sum from its left neighbour (flag slot {slot}) past "
                f"{timeout_s} s")

    tp_gemm.launch_collective(KERNEL, x, out, chunk_bytes=c_bytes, n=n,
                              st=st, flags_per_rank=n - 1, slots=n - 1,
                              ctx=ctx, describe=describe, fault=fault,
                              timeout_s=timeout_s, check=check)
    return out
