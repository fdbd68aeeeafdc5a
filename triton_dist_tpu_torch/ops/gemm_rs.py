"""Fused GEMM + reduce-scatter, the tensor-parallel row-linear forward
(counterpart of ``triton_dist_tpu/ops/gemm_rs.py``: ``GemmRSContext``,
``create_gemm_rs_context``, ``gemm_rs`` and ``gemm_rs_ref``).

``a (n, M, K_loc)`` stacks every rank's K-shard of the activations and
``b (n, N, K_loc)`` every rank's row-parallel weight shard (a strided
view, :func:`~triton_dist_tpu_torch.ops.tp_gemm.row_shards`). Rank r ends
with the sum over ranks of rows ``[r·M/n, (r+1)·M/n)``: ``(n, M/n, N)``.
On a CUDA tensor :func:`gemm_rs` launches ``gemm_rs_kernel``
(``csrc/gemm_rs.cu``), JAX's ``"rs"`` ring run by every rank's thread
blocks in one launch; on a CPU tensor it runs :func:`gemm_rs_ref`. Both
add a chunk's partials in the ring's order (ranks c+1, c+2, ..., c) in
fp32 and round once.

The context keeps JAX's block names and divisibility contract
(``_rs_blocks``); ``prefetch_depth`` steers the TPU kernel's VMEM staging
and is left out. The ``"identity"`` swizzle (row 11) and tuple axes (row
12) raise: ROADMAP.md queue B.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from triton_dist_tpu_torch.lang import overlap
from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

SWIZZLE_MODES = ("rs", "identity")
FAULTS = {"drop_partial": 1, "lost_signal": 2}

# ``KERNEL.launches`` counts launches of the CUDA kernel.
KERNEL = CudaKernel("gemm_rs.cu", "tdt_gemm_rs_bf16",
                    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                    + [ctypes.c_uint64] * 2 + [ctypes.c_int])


@dataclasses.dataclass(frozen=True)
class GemmRSContext:
    mesh: MeshContext
    axis: str = "tp"
    block_m: int = 256
    block_n: int = 256
    block_k: int = 512
    out_dtype: Optional[torch.dtype] = None
    swizzle_mode: str = "rs"


def _check_ported(ctx: GemmRSContext) -> None:
    if ctx.swizzle_mode not in SWIZZLE_MODES:
        raise ValueError(f"unknown gemm_rs swizzle_mode "
                         f"{ctx.swizzle_mode!r} (expected one of "
                         f"{SWIZZLE_MODES})")
    if ctx.swizzle_mode != "rs":
        raise ValueError(f"gemm_rs swizzle_mode {ctx.swizzle_mode!r} "
                         "(_gemm_rs_identity_kernel) is not ported yet "
                         "(ROADMAP.md queue B)")
    if not isinstance(ctx.axis, str):
        raise ValueError("the hierarchical (outer, inner) gemm_rs "
                         "(_gemm_rs_2d_kernel) is not ported yet "
                         "(ROADMAP.md queue B)")


def create_gemm_rs_context(mesh: MeshContext, axis: str = "tp",
                           block_m: int = 256, block_n: int = 256,
                           block_k: int = 512, out_dtype=None,
                           swizzle_mode: str = "rs") -> GemmRSContext:
    ctx = GemmRSContext(mesh=mesh, axis=axis, block_m=block_m,
                        block_n=block_n, block_k=block_k,
                        out_dtype=out_dtype, swizzle_mode=swizzle_mode)
    _check_ported(ctx)
    return ctx


def rs_blocks(block_m: int, block_n: int, block_k: int, m_loc: int,
              n_dim: int, k_loc: int):
    """JAX's ``_rs_blocks``: clamp each block to its dimension; each must
    divide it. Returns ``(tm, tn, tk)``."""
    tm = min(block_m, m_loc)
    tn = min(block_n, n_dim)
    tk = min(block_k, k_loc)
    if m_loc % tm or n_dim % tn or k_loc % tk:
        raise ValueError(
            f"block sizes (block_m={tm}, block_n={tn}, block_k={tk}) must "
            f"divide (M_loc={m_loc}, N={n_dim}, K_loc={k_loc})")
    return tm, tn, tk


def gemm_rs_ref(a: torch.Tensor, b: torch.Tensor, *,
                out_dtype=None) -> torch.Tensor:
    """Plain version: each rank's fp32 partial; chunk c's sum taken in the
    ring's order (the partial of rank c+1 first, rank c's last), rounded
    once to ``out_dtype``."""
    n, m_full, _ = a.shape
    m_loc = m_full // n
    parts = [tp_gemm.mm_f32(a[r], b[r]) for r in range(n)]
    out = []
    for c in range(n):
        acc = None
        for s in range(n):
            # the rank that computes chunk c at step s of the "rs" ring
            r = next(r for r in range(n)
                     if overlap.chunk_at(s, r, n, "rs") == c)
            p = parts[r][c * m_loc:(c + 1) * m_loc]
            acc = p if acc is None else p + acc
        out.append(acc)
    return torch.stack(out).to(out_dtype or a.dtype)


def gemm_rs(a: torch.Tensor, b: torch.Tensor, ctx: GemmRSContext, *,
            fault: int = 0, timeout_s: float = shmem.TIMEOUT_S,
            check: bool = False) -> torch.Tensor:
    """Every rank's ``a[r] @ b[r].T`` reduce-scattered over the ranks:
    ``(n, M/n, N)`` in ``ctx.out_dtype`` (or a's). ``fault`` (a value of
    :data:`FAULTS`), ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    _check_ported(ctx)
    n = ctx.mesh.size(ctx.axis)
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != n or b.shape[0] != n
            or a.shape[2] != b.shape[2]):
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)}: expected "
                         f"(n={n}, M, K_loc) and (n, N, K_loc)")
    _, m_full, k_loc = a.shape
    n_dim = b.shape[1]
    if m_full % n:
        raise ValueError(f"M={m_full} not divisible by axis size {n}")
    m_loc = m_full // n
    rs_blocks(ctx.block_m, ctx.block_n, ctx.block_k, m_loc, n_dim, k_loc)
    out_dtype = ctx.out_dtype or a.dtype
    if a.device.type == "cpu":
        return gemm_rs_ref(a, b, out_dtype=out_dtype)
    tp_gemm.check_operands("gemm_rs", a, b, out_dtype)
    dev = a.device
    tm, tn = tp_gemm.tile(KERNEL, m_loc)
    n_rb, n_cb = -(-m_loc // tm), -(-n_dim // tn)
    slots = max(n - 1, 1)
    ws = shmem.workspace("gemm_rs", (m_loc, n_dim), n=n,
                         n_flags=n * slots * n_rb * n_cb, device=dev,
                         data_shape=(slots, m_loc, n_dim))
    out = torch.empty((n, m_loc, n_dim), dtype=out_dtype, device=dev)

    def describe(rank, step, slot):
        s, t = divmod(slot % (slots * n_rb * n_cb), n_rb * n_cb)
        return (f"gemm_rs: rank {rank} waited at ring step {step} for the "
                f"running sum of tile {divmod(t, n_cb)} from rank "
                f"{(rank - 1) % n} (receive slot {s}, flag slot {slot}) "
                f"past {timeout_s} s")

    tp_gemm.launch(KERNEL, ws, describe, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), ws.data.data_ptr(), b.stride(0),
                   b.stride(1), n, m_loc, n_dim, k_loc, device=dev,
                   timeout_s=timeout_s, fault=fault, check=check)
    return out
