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
and is left out. The ``"identity"`` swizzle (row 11) raises: ROADMAP.md
queue B.

An ``(outer, inner)`` tuple axis is the hierarchical form (JAX's
``_gemm_rs_2d``, row 12): over R = n_o·n_in ranks, rank r = o·n_in + i
ends with chunk r's sum, as in the flat form. On a CUDA tensor it launches
``gemm_rs_2d_kernel`` (``csrc/gemm_rs.cu``): super-step t ring-reduces the
chunks bound for one outer group through the GEMM, and each finished group
sum crosses the outer hop once
(:func:`~triton_dist_tpu_torch.lang.overlap.rs_2d_step`); on a CPU tensor
:func:`gemm_rs_2d_ref` walks the same schedule in the same fp32 order. At
``n_o == 1`` it is the single-axis op on the inner axis; ``"rs"`` is its
only schedule (JAX :452-455); M must divide by n_o·n_in.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from triton_dist_tpu_torch.lang import overlap
from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext, axis_names
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

SWIZZLE_MODES = ("rs", "identity")
FAULTS = {"drop_partial": 1, "lost_signal": 2}
# The hierarchical form's planted faults, one of each kind on each hop.
FAULTS_2D = {"wrong_chunk_inner": 1, "lost_signal_inner": 2,
             "wrong_chunk_outer": 3, "lost_signal_outer": 4}

# ``KERNEL.launches`` counts launches of the CUDA kernel.
KERNEL = CudaKernel("gemm_rs.cu", "tdt_gemm_rs_bf16",
                    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                    + [ctypes.c_uint64] * 2 + [ctypes.c_int])
KERNEL_2D = CudaKernel("gemm_rs.cu", "tdt_gemm_rs_2d_bf16",
                       [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                       + [ctypes.c_uint64] * 2 + [ctypes.c_int])


@dataclasses.dataclass(frozen=True)
class GemmRSContext:
    mesh: MeshContext
    axis: object = "tp"      # one axis, or an (outer, inner) tuple
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
    tp_gemm.check_axis("gemm_rs", ctx.mesh, ctx.axis)


def create_gemm_rs_context(mesh: MeshContext, axis="tp",
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


def gemm_rs_2d_ref(a: torch.Tensor, b: torch.Tensor, n_o: int, n_in: int, *,
                   out_dtype=None) -> torch.Tensor:
    """Plain version of the hierarchical form: every rank walks the 2D
    schedule (:func:`~triton_dist_tpu_torch.lang.overlap.rs_2d_step`) as
    the kernel does, its fp32 partial of each step's chunk plus the running
    sum from its inner neighbour; a group sum crosses to its destination,
    which adds the n_o - 1 it received in slot order; rounded once."""
    n, m_full, _ = a.shape
    m_loc = m_full // n
    parts = [tp_gemm.mm_f32(a[r], b[r]) for r in range(n)]
    inner, outer, out = {}, {}, [None] * n
    for q in range(n):
        t, s = divmod(q, n_in)
        for r in range(n):
            o, i = divmod(r, n_in)
            o_dst, c = overlap.rs_2d_step(q, o, i, n_o, n_in)
            v = parts[r][c * m_loc:(c + 1) * m_loc]
            if s > 0:
                v = v + inner[(r, t * (n_in - 1) + s - 1)]
            if s < n_in - 1:
                inner[(o * n_in + (i + 1) % n_in, t * (n_in - 1) + s)] = v
            elif t < n_o - 1:
                outer[(o_dst * n_in + i, t)] = v
            else:
                for h in range(n_o - 1):
                    v = v + outer[(r, h)]
                out[r] = v
    return torch.stack(out).to(out_dtype or a.dtype)


def _gemm_rs_2d(a, b, ctx: GemmRSContext, *, fault: int, timeout_s: float,
                check: bool, puts):
    outer_axis, inner_axis = ctx.axis
    n_o, n_in = ctx.mesh.size(outer_axis), ctx.mesh.size(inner_axis)
    if n_o == 1:
        return gemm_rs(a, b, dataclasses.replace(ctx, axis=inner_axis),
                       fault=fault, timeout_s=timeout_s, check=check)
    n = n_o * n_in
    _, m_full, k_loc = a.shape
    n_dim = b.shape[1]
    m_loc = m_full // n
    out_dtype = ctx.out_dtype or a.dtype
    if a.device.type == "cpu":
        return gemm_rs_2d_ref(a, b, n_o, n_in, out_dtype=out_dtype)
    tp_gemm.check_operands("gemm_rs", a, b, out_dtype)
    dev = a.device
    tm, tn = tp_gemm.tile(KERNEL_2D, m_loc)
    tiles = -(-m_loc // tm) * -(-n_dim // tn)
    u = n_o * (n_in - 1)
    ws = shmem.workspace("gemm_rs_2d", (m_loc, n_dim, n_o), n=n, device=dev,
                         hops={"inner": n * u * tiles,
                               "outer": n * (n_o - 1) * tiles},
                         buffers={"inner": ((max(u, 1), m_loc, n_dim),
                                            torch.float32),
                                  "outer": ((n_o - 1, m_loc, n_dim),
                                            torch.float32)})
    out = torch.empty((n, m_loc, n_dim), dtype=out_dtype, device=dev)
    irecv, orecv = ws.buffers["inner"], ws.buffers["outer"]

    def describe(rank, step, slot):
        # Every flag is signalled once a launch: name the first signal
        # that never came (a wait downstream of it may time out first).
        root = (ws.unsignalled() or [slot])[0]
        hop, k = ws.hop_of(root)
        per_rank = (u if hop == "inner" else n_o - 1) * tiles
        dst, (h, t) = k // per_rank, divmod(k % per_rank, tiles)
        what = (f"the running sum from its inner neighbour (transfer {h})"
                if hop == "inner" else f"the group sum of super-step {h}")
        return (f"gemm_rs 2d ({hop} hop, axis "
                f"{inner_axis if hop == 'inner' else outer_axis!r}): the "
                f"signal to rank {dst} for tile {t} of {what} (flag slot "
                f"{root}) never came; rank {rank} timed out first, at step "
                f"{step} on flag slot {slot}, past {timeout_s} s")

    tp_gemm.launch(KERNEL_2D, ws, describe, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), irecv.data_ptr(), orecv.data_ptr(),
                   puts.data_ptr() if puts is not None else None,
                   b.stride(0), b.stride(1), n_o, n_in, m_loc, n_dim, k_loc,
                   device=dev, timeout_s=timeout_s, fault=fault, check=check)
    return out


def gemm_rs(a: torch.Tensor, b: torch.Tensor, ctx: GemmRSContext, *,
            fault: int = 0, timeout_s: float = shmem.TIMEOUT_S,
            check: bool = False,
            puts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's ``a[r] @ b[r].T`` reduce-scattered over the ranks:
    ``(n, M/n, N)`` in ``ctx.out_dtype`` (or a's). ``fault`` (a value of
    :data:`FAULTS`, or of :data:`FAULTS_2D` on a tuple axis),
    ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`. ``puts``: on a
    tuple axis, an int64 (2,) tensor on the card to which the kernel adds
    its group-sum puts over the inner and the outer hop."""
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
    if len(axis_names(ctx.axis)) == 2:
        return _gemm_rs_2d(a, b, ctx, fault=fault, timeout_s=timeout_s,
                           check=check, puts=puts)
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
