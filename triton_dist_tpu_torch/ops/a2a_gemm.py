"""All-to-all fused into a GEMM (counterpart of
``triton_dist_tpu/ops/a2a_gemm.py``: ``A2AGemmContext``,
``create_a2a_gemm_context``, ``a2a_gemm_ref``, ``a2a_gemm_fused`` and
``a2a_gemm``).

The ranks are the leading dimension (:mod:`~triton_dist_tpu_torch.
parallel.mesh`): ``x`` (n, n, C, d) stacks every rank's per-shard (n, C,
d), ``x[s][r]`` the chunk rank s sends rank r. Rank r multiplies the chunks
it receives, stacked by source, by its weight: ``out[r]`` (n·C, N), rows
``[s·C, (s+1)·C)`` from source s. The weight is stored ``(out, in)`` as
everywhere in the port: one (N, d) weight every rank holds (JAX's
replicated ``w``), or (n, N, d), one per rank.

On a CUDA tensor :func:`a2a_gemm_fused` is one cooperative launch of
``a2a_gemm_kernel`` (``csrc/a2a_gemm.cu``, row 28): every put issued at
entry, then each GEMM tile walks its chunk in the swizzle's order and waits
only for the row block of the source it reads. On a CPU tensor it runs
:func:`a2a_gemm_ref`. JAX's VMEM tile knobs (``block_m``/``block_n``/
``block_k``) and ``prefetch_depth`` steer only the TPU kernel and have no
counterpart (the CUDA kernel picks its own 128 x 128 tiles), nor has
``force_kernel``; ``swizzle_mode`` (``"a2a"``: the local chunk first, then
by ring offset; ``"identity"``: sources in order) is JAX's knob and the
kernel's. The ``_tuned`` form and its autotuner are ROADMAP.md queue A
item 4.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.ops.all_to_all import all_to_all, all_to_all_ref
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

SWIZZLE_MODES = ("a2a", "identity")
FAULTS = {"wrong_chunk": 1, "lost_signal": 2}
ROW_BLOCK = 128      # csrc/a2a_gemm.cu: rows a GEMM item (and a flag) covers

# ``KERNEL.launches`` counts launches of the CUDA kernel.
KERNEL = CudaKernel("a2a_gemm.cu", "tdt_a2a_gemm",
                    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
                    + [ctypes.c_uint64] * 2 + [ctypes.c_int])


@dataclasses.dataclass(frozen=True)
class A2AGemmContext:
    """JAX's ``A2AGemmContext``: the mesh, its axis, the output dtype
    (``None``: x's) and the chunk walk's ``swizzle_mode``."""
    mesh: MeshContext
    axis: str = "tp"
    out_dtype: Optional[torch.dtype] = None
    swizzle_mode: str = "a2a"


def create_a2a_gemm_context(mesh: MeshContext, axis: str = "tp", *,
                            out_dtype=None,
                            swizzle_mode: str = "a2a") -> A2AGemmContext:
    if swizzle_mode not in SWIZZLE_MODES:
        raise ValueError(f"unknown a2a_gemm swizzle_mode {swizzle_mode!r} "
                         f"(expected one of {SWIZZLE_MODES})")
    return A2AGemmContext(mesh=mesh, axis=axis, out_dtype=out_dtype,
                          swizzle_mode=swizzle_mode)


def _ranks(x: torch.Tensor, mesh: MeshContext, axis) -> int:
    if not isinstance(axis, str):
        raise ValueError(f"a2a_gemm: axis {axis!r} must be one mesh axis")
    tp_gemm.check_axis("a2a_gemm", mesh, axis)
    n = mesh.size(axis)
    if x.dim() != 4 or tuple(x.shape[:2]) != (n, n):
        raise ValueError(f"x {tuple(x.shape)}: expected (n={n}, n, C, d), "
                         "x[s][r] the chunk rank s sends rank r")
    return n


def _products(recv: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Every rank's rows (n, M, d) times its weight ((N, d), or (n, N, d)
    one per rank), fp32 sums: (n, M, N)."""
    n, m, d = recv.shape
    if w.dim() == 2:
        return tp_gemm.mm_f32(recv.reshape(n * m, d), w).view(n, m, -1)
    return torch.stack([tp_gemm.mm_f32(recv[r], w[r]) for r in range(n)])


def a2a_gemm_ref(x: torch.Tensor, w: torch.Tensor, *, axis: str = "tp",
                 **_) -> torch.Tensor:
    """Plain version: the exchange (:func:`~triton_dist_tpu_torch.ops.
    all_to_all.all_to_all_ref`), then each rank's received rows through
    its weight, fp32 sums rounded once to x's dtype: (n, n·C, N)."""
    recv = all_to_all_ref(x)
    n, _, c, d = recv.shape
    return _products(recv.reshape(n, n * c, d), w).to(x.dtype)


def a2a_gemm_fused(x: torch.Tensor, w: torch.Tensor, ctx: A2AGemmContext,
                   *, return_recv: bool = False, fault: int = 0,
                   timeout_s: float = shmem.TIMEOUT_S, check: bool = False):
    """Tile-fused A2A + GEMM: ``x`` (n, n, C, d), ``w`` (N, d) or (n, N,
    d). Returns (n, n·C, N) in ``ctx.out_dtype`` (x's by default); with
    ``return_recv`` also the received rows (n, n·C, d), the buffer the
    puts filled. On a CUDA tensor one launch of ``a2a_gemm_kernel``; on a
    CPU tensor :func:`a2a_gemm_ref`. ``fault`` (a value of
    :data:`FAULTS`), ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    n = _ranks(x, ctx.mesh, ctx.axis)
    _, _, c, d = x.shape
    out_dtype = ctx.out_dtype or x.dtype
    if w.shape[-1] != d or (w.dim() == 3 and w.shape[0] != n) \
            or w.dim() not in (2, 3):
        raise ValueError(f"w {tuple(w.shape)}: expected (N, d={d}) or "
                         f"(n={n}, N, d)")
    if x.device.type == "cpu":
        recv = all_to_all_ref(x).reshape(n, n * c, d)
        out = _products(recv, w).to(out_dtype)
        return (out, recv) if return_recv else out
    tp_gemm.check_operands("a2a_gemm", x.reshape(n, n * c, d),
                           w if w.dim() == 3 else w[None], out_dtype)
    if not x.is_contiguous():
        raise ValueError("a2a_gemm: x must be contiguous")
    dev = x.device
    n_out = w.shape[-2]
    n_rb = -(-c // ROW_BLOCK)
    # A planted fault leaves rows wrong or unwritten: zeros keep them visible.
    make = torch.zeros if fault else torch.empty
    out = make((n, n * c, n_out), dtype=out_dtype, device=dev)
    recv = make((n, n * c, d), dtype=x.dtype, device=dev)
    ws = shmem.workspace("a2a_gemm", (c,), n=n, device=dev,
                         n_flags=n * n * n_rb)

    def describe(rank, step, slot):
        return (f"a2a_gemm: rank {rank} waited for row block {slot % n_rb} "
                f"of rank {step}'s chunk (flag slot {slot}) past "
                f"{timeout_s} s")

    w_rank = w.stride(0) if w.dim() == 3 else 0
    tp_gemm.launch(KERNEL, ws, describe, x.data_ptr(), w.data_ptr(),
                   out.data_ptr(), recv.data_ptr(), w_rank, w.stride(-2), n,
                   c, d, n_out, int(return_recv),
                   SWIZZLE_MODES.index(ctx.swizzle_mode), device=dev,
                   timeout_s=timeout_s, fault=fault, check=check)
    return (out, recv) if return_recv else out


def a2a_gemm(x: torch.Tensor, w: torch.Tensor, *, ctx: MeshContext,
             axis: str = "tp", impl: str = "fused", **kw) -> torch.Tensor:
    """x (n, n, C, d), chunk ``x[s][r]`` for rank r; w (N, d) or (n, N, d).
    Returns (n, n·C, N): received rows through the GEMM. ``impl``:
    ``"fused"`` (the tile-fused kernel; ``kw``: :func:`create_a2a_gemm_context`'s
    ``out_dtype``/``swizzle_mode``), ``"pallas"`` (row 18's all-to-all,
    then the product), ``"xla"`` (:func:`~triton_dist_tpu_torch.ops.
    all_to_all.all_to_all_ref`, then the product)."""
    if impl == "fused":
        return a2a_gemm_fused(x, w, create_a2a_gemm_context(ctx, axis, **kw))
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown impl {impl!r} "
                         "(expected 'fused'/'pallas'/'xla')")
    if kw:
        raise TypeError(f"{sorted(kw)} only apply to impl='fused'")
    n = _ranks(x, ctx, axis)
    recv = (all_to_all(x, ctx=ctx, axis=axis) if impl == "pallas"
            else all_to_all_ref(x))
    _, _, c, d = recv.shape
    return _products(recv.reshape(n, n * c, d), w).to(x.dtype)
