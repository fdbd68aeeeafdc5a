"""Fused all-gather + GEMM, the tensor-parallel column-linear forward
(counterpart of ``triton_dist_tpu/ops/ag_gemm.py``: ``AGGemmContext``,
``create_ag_gemm_context``, ``ag_gemm`` and ``ag_gemm_ref``).

The ranks are simulated on one device (:mod:`~triton_dist_tpu_torch.
parallel.mesh`): ``a (n, M_loc, K)`` stacks every rank's row chunk and
``b (n, N_loc, K)`` every rank's column-parallel weight shard (the port's
``(out, in)`` layout, :func:`~triton_dist_tpu_torch.ops.tp_gemm.
column_shards`). Rank r's output is the gathered A (chunks in rank
order, as JAX's ``c_index`` places them) times its shard: ``(n, n·M_loc,
N_loc)``. On a CUDA tensor :func:`ag_gemm` launches ``ag_gemm_kernel``
(``csrc/ag_gemm.cu``), the ring of JAX's ``_ag_gemm_kernel`` run by every
rank's thread blocks in one launch; on a CPU tensor it runs
:func:`ag_gemm_ref`.

The context keeps JAX's block names and its divisibility contract
(:func:`panel_blocks` raises what JAX's ``_panel_blocks`` raises); the
CUDA kernel picks its own tile. Left out of the context, because they
steer the TPU kernel and nothing here: ``prefetch_depth`` and the VMEM
panel budget (the kernel stages K through shared memory itself), the
``straggler_*`` compute spin (the card check plants faults through
:func:`ag_gemm`'s ``fault`` instead) and ``sim_ranks`` (every rank here
is real and computes only its own shard). The ``"pipelined"`` variant
(row 8) and the ``"identity"`` swizzle raise: they are ROADMAP.md queue B.

An ``(outer, inner)`` tuple axis is the hierarchical form (JAX's
``_ag_gemm_2d``, row 9): over R = n_o·n_in ranks, rank r = o·n_in + i,
the result equals the flat one, and on a CUDA tensor it launches
``ag_gemm_2d_kernel`` (``csrc/ag_gemm.cu``), whose inner ring distributes
one outer column's chunks while that column's seed crosses the outer hop
(:func:`~triton_dist_tpu_torch.lang.overlap.ag_2d_step`); on a CPU tensor
:func:`ag_gemm_ref` over the flattened ranks. At ``n_o == 1`` it is the
single-axis op on the inner axis, as in JAX; only the ``"ag"`` schedule
has a 2D form (JAX :795-798).
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

SWIZZLE_MODES = ("ag", "identity")
FAULTS = {"wrong_chunk": 1, "lost_signal": 2}
# The hierarchical form's planted faults, one of each kind on each hop.
FAULTS_2D = {"wrong_chunk_inner": 1, "lost_signal_inner": 2,
             "wrong_chunk_outer": 3, "lost_signal_outer": 4}

# ``KERNEL.launches`` counts launches of the CUDA kernel.
KERNEL = CudaKernel("ag_gemm.cu", "tdt_ag_gemm_bf16",
                    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                    + [ctypes.c_uint64] * 2 + [ctypes.c_int])
KERNEL_2D = CudaKernel("ag_gemm.cu", "tdt_ag_gemm_2d_bf16",
                       [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
                       + [ctypes.c_uint64] * 2 + [ctypes.c_int])


@dataclasses.dataclass(frozen=True)
class AGGemmContext:
    mesh: MeshContext
    axis: object = "tp"      # one axis, or an (outer, inner) tuple
    block_m: int = 256
    block_n: int = 256
    block_k: int = 512
    out_dtype: Optional[torch.dtype] = None
    variant: str = "panel"
    swizzle_mode: str = "ag"


def _check_ported(ctx: AGGemmContext) -> None:
    if ctx.variant not in ("panel", "pipelined"):
        raise ValueError(f"unknown ag_gemm variant {ctx.variant!r} "
                         "(expected 'panel' or 'pipelined')")
    if ctx.swizzle_mode not in SWIZZLE_MODES:
        raise ValueError(f"unknown ag_gemm swizzle_mode "
                         f"{ctx.swizzle_mode!r} (expected one of "
                         f"{SWIZZLE_MODES})")
    if ctx.variant == "pipelined":
        raise ValueError("ag_gemm variant 'pipelined' (_ag_gemm_pipelined_"
                         "kernel) is not ported yet (ROADMAP.md queue B)")
    if ctx.swizzle_mode != "ag":
        raise ValueError(f"ag_gemm swizzle_mode {ctx.swizzle_mode!r} is "
                         "not ported yet (ROADMAP.md queue B)")
    tp_gemm.check_axis("ag_gemm", ctx.mesh, ctx.axis)


def create_ag_gemm_context(mesh: MeshContext, axis="tp",
                           block_m: int = 256, block_n: int = 256,
                           block_k: int = 512, out_dtype=None,
                           variant: str = "panel",
                           swizzle_mode: str = "ag") -> AGGemmContext:
    ctx = AGGemmContext(mesh=mesh, axis=axis, block_m=block_m,
                        block_n=block_n, block_k=block_k,
                        out_dtype=out_dtype, variant=variant,
                        swizzle_mode=swizzle_mode)
    _check_ported(ctx)
    return ctx


def panel_blocks(block_m: int, block_n: int, block_k: int, m_loc: int,
                 n_loc: int, kdim: int):
    """JAX's tile clamp and divisibility check (``panel_blocks`` without
    its TPU VMEM budget): tm snaps down to a divisor of M_loc, tn and tk
    must divide. Returns ``(tm, tn, tk)``."""
    tm = min(block_m, m_loc)
    tn = min(block_n, n_loc)
    tk = min(block_k, kdim)
    while tm > 1 and m_loc % tm:
        tm //= 2
    if m_loc % tm or n_loc % tn or kdim % tk:
        raise ValueError(
            f"block sizes (block_m={tm}, block_n={tn}, block_k={tk}) must "
            f"divide (M_loc={m_loc}, N_loc={n_loc}, K={kdim})")
    return tm, tn, tk


def ag_gemm_ref(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
                return_ag: bool = False):
    """Plain version: gather the chunks in rank order, then each rank's
    product with fp32 sums, rounded once to ``out_dtype``."""
    n, m_loc, kdim = a.shape
    a_full = a.reshape(n * m_loc, kdim)
    out = torch.stack([tp_gemm.mm_f32(a_full, b[r]) for r in range(n)])
    out = out.to(out_dtype or a.dtype)
    return (out, a_full.expand(n, n * m_loc, kdim)) if return_ag else out


def _ag_gemm_2d(a, b, ctx: AGGemmContext, *, return_ag: bool, fault: int,
                timeout_s: float, check: bool, puts):
    outer, inner = ctx.axis
    n_o, n_in = ctx.mesh.size(outer), ctx.mesh.size(inner)
    if n_o == 1:
        return ag_gemm(a, b, dataclasses.replace(ctx, axis=inner),
                       return_ag=return_ag, fault=fault, timeout_s=timeout_s,
                       check=check)
    n = n_o * n_in
    _, m_loc, kdim = a.shape
    n_loc = b.shape[1]
    out_dtype = ctx.out_dtype or a.dtype
    if a.device.type == "cpu":
        return ag_gemm_ref(a, b, out_dtype=out_dtype, return_ag=return_ag)
    tp_gemm.check_operands("ag_gemm", a, b, out_dtype)
    dev = a.device
    n_rb = -(-m_loc // tp_gemm.tile(KERNEL_2D, m_loc)[0])
    ws = shmem.workspace("ag_gemm_2d", (m_loc, n_o), n=n, device=dev,
                         hops={"inner": n * n_o * (n_in - 1) * n_rb,
                               "outer": n * (n_o - 1) * n_rb})
    out = torch.empty((n, n * m_loc, n_loc), dtype=out_dtype, device=dev)
    gathered = shmem.symm_tensor((n * m_loc, kdim), a.dtype, n, dev)

    def describe(rank, step, slot):
        # Every flag is signalled once a launch: name the first signal
        # that never came (a wait downstream of it may time out first).
        root = (ws.unsignalled() or [slot])[0]
        hop, k = ws.hop_of(root)
        per_rank = (n_o * (n_in - 1) if hop == "inner" else n_o - 1) * n_rb
        dst, (u, i) = k // per_rank, divmod(k % per_rank, n_rb)
        what = ("the inner ring's chunk of transfer" if hop == "inner"
                else "the seed chunk of super-step")
        return (f"ag_gemm 2d ({hop} hop, axis "
                f"{inner if hop == 'inner' else outer!r}): the signal to "
                f"rank {dst} for row block {i} of {what} "
                f"{u + (hop == 'outer')} (flag slot {root}) never came; "
                f"rank {rank} timed out first, at step {step} on flag slot "
                f"{slot}, past {timeout_s} s")

    tp_gemm.launch(KERNEL_2D, ws, describe, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), gathered.data_ptr(),
                   puts.data_ptr() if puts is not None else None,
                   b.stride(0), b.stride(1), n_o, n_in, m_loc, n_loc, kdim,
                   int(return_ag), device=dev, timeout_s=timeout_s,
                   fault=fault, check=check)
    return (out, gathered) if return_ag else out


def ag_gemm(a: torch.Tensor, b: torch.Tensor, ctx: AGGemmContext, *,
            return_ag: bool = False, fault: int = 0,
            timeout_s: float = shmem.TIMEOUT_S, check: bool = False,
            puts: Optional[torch.Tensor] = None):
    """Every rank's all-gather of ``a (n, M_loc, K)`` times its shard of
    ``b (n, N_loc, K)``: ``(n, n·M_loc, N_loc)`` in ``ctx.out_dtype`` (or
    a's). ``return_ag``: also the gathered A, ``(n, n·M_loc, K)``, rank
    r's copy at ``[r]`` (the kernel's gather buffer, allocated for this
    call: the caller may hold it across later calls). ``fault`` (a value
    of :data:`FAULTS`, or of :data:`FAULTS_2D` on a tuple axis),
    ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`. ``puts``: on a
    tuple axis, an int64 (2,) tensor on the card to which the kernel adds
    its chunk puts over the inner and the outer hop."""
    _check_ported(ctx)
    n = ctx.mesh.size(ctx.axis)
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != n or b.shape[0] != n
            or a.shape[2] != b.shape[2]):
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)}: expected "
                         f"(n={n}, M_loc, K) and (n, N_loc, K)")
    _, m_loc, kdim = a.shape
    n_loc = b.shape[1]
    panel_blocks(ctx.block_m, ctx.block_n, ctx.block_k, m_loc, n_loc, kdim)
    if len(axis_names(ctx.axis)) == 2:
        return _ag_gemm_2d(a, b, ctx, return_ag=return_ag, fault=fault,
                           timeout_s=timeout_s, check=check, puts=puts)
    out_dtype = ctx.out_dtype or a.dtype
    if a.device.type == "cpu":
        return ag_gemm_ref(a, b, out_dtype=out_dtype, return_ag=return_ag)
    tp_gemm.check_operands("ag_gemm", a, b, out_dtype)
    dev = a.device
    n_rb = -(-m_loc // tp_gemm.tile(KERNEL, m_loc)[0])
    ws = shmem.workspace("ag_gemm", (m_loc,), n=n,
                         n_flags=n * n * n_rb, device=dev)
    out = torch.empty((n, n * m_loc, n_loc), dtype=out_dtype, device=dev)
    gathered = shmem.symm_tensor((n * m_loc, kdim), a.dtype, n, dev)

    def describe(rank, step, slot):
        c, i = divmod(slot % (n * n_rb), n_rb)
        return (f"ag_gemm: rank {rank} waited at ring step {step} for row "
                f"block {i} of chunk {c} (flag slot {slot}) past "
                f"{timeout_s} s")

    tp_gemm.launch(KERNEL, ws, describe, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), gathered.data_ptr(), b.stride(0),
                   b.stride(1), n, m_loc, n_loc, kdim, int(return_ag),
                   device=dev, timeout_s=timeout_s, fault=fault, check=check)
    return (out, gathered) if return_ag else out
