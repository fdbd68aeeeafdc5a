"""Ulysses sequence parallelism with the projections fused into the
all-to-alls (counterpart of ``triton_dist_tpu/ops/ulysses_fused.py``:
``UlyssesFusedContext``, ``create_ulysses_fused_context``,
``qkv_gemm_a2a``, ``o_a2a_gemm``, ``group_qkv_columns``, ``group_o_rows``
and ``ulysses_attn_fused``).

The ranks are the leading dimension (:mod:`~triton_dist_tpu_torch.
parallel.mesh`) and weights are stored ``(out, in)``, so each of JAX's
owner-grouped weights is its transpose per owner:

- :func:`qkv_gemm_a2a`: x (n, S_loc, d) sequence-sharded, w (n, cols_loc,
  d) the QKV rows grouped by head owner (:func:`group_qkv_columns`) →
  (n, n, S_loc, cols_loc), ``out[o][s] = x[s] · w[o]ᵀ``: what
  ``pre_attn_a2a(x · W)`` gives owner o from source s. On a CUDA tensor one
  launch of ``ulysses_qkv_a2a_kernel`` (``csrc/ulysses_fused.cu``, row 29):
  every (source, owner, row block) projection stored straight into the
  owner's slot with one flag, and the launch ends once every owner has seen
  all its flags.
- :func:`o_a2a_gemm`: o (n, S, rows_loc) each rank's heads over the whole
  sequence, w (n, d, rows_loc) the O-projection columns of each owner's
  heads (:func:`group_o_rows`: a view of W_o, no copy) → (n, S_loc, d),
  ``post_attn_a2a(o) · W_oᵀ``, a sum of one partial product per source. On
  a CUDA tensor one launch of ``ulysses_o_a2a_kernel`` (row 30): every send
  issued at entry into the receiver's slot of a persistent workspace
  buffer, then each output tile accumulates the sources in the swizzle's
  order, waiting for each just before its first K stage.

On a CPU tensor each runs its plain version (:func:`qkv_gemm_a2a_ref`,
:func:`o_a2a_gemm_ref`: fp32 sums rounded once). JAX's VMEM tile knobs
(``block_m``/``block_n``), ``prefetch_depth`` and ``sim_ranks`` steer only
the TPU kernel (every simulated rank here is real) and have no
counterpart; ``swizzle_mode`` is the consumer's source walk, as in JAX.
The ``_tuned`` forms are ROADMAP.md queue A item 4.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

SWIZZLE_MODES = ("a2a", "identity")
FAULTS = {"wrong_chunk": 1, "lost_signal": 2}
ROW_BLOCK = 128      # csrc/ulysses_fused.cu: rows a flag covers

_SYNC = [ctypes.c_void_p] * 2 + [ctypes.c_uint64] * 2 + [ctypes.c_int]
# ``QKV_KERNEL.launches`` / ``O_KERNEL.launches`` count launches of the two
# CUDA kernels.
QKV_KERNEL = CudaKernel("ulysses_fused.cu", "tdt_ulysses_qkv_a2a",
                        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                        + [ctypes.c_int] * 4 + _SYNC)
O_KERNEL = CudaKernel("ulysses_fused.cu", "tdt_ulysses_o_a2a",
                      [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                      + [ctypes.c_int] * 5 + _SYNC)


@dataclasses.dataclass(frozen=True)
class UlyssesFusedContext:
    """JAX's ``UlyssesFusedContext``: the mesh, its axis and the O
    kernel's source walk (``swizzle_mode``)."""
    mesh: MeshContext
    axis: str = "sp"
    swizzle_mode: str = "a2a"


def create_ulysses_fused_context(mesh: MeshContext, axis: str = "sp", *,
                                 swizzle_mode: str = "a2a"
                                 ) -> UlyssesFusedContext:
    if swizzle_mode not in SWIZZLE_MODES:
        raise ValueError(f"unknown ulysses swizzle_mode {swizzle_mode!r} "
                         f"(expected one of {SWIZZLE_MODES})")
    return UlyssesFusedContext(mesh=mesh, axis=axis,
                               swizzle_mode=swizzle_mode)


def _ranks(ctx: UlyssesFusedContext, x: torch.Tensor, op: str) -> int:
    tp_gemm.check_axis(op, ctx.mesh, ctx.axis)
    n = ctx.mesh.size(ctx.axis)
    if x.shape[0] != n:
        raise ValueError(f"{op}: leading dim {x.shape[0]} != the "
                         f"{ctx.axis!r} axis size {n}")
    return n


def qkv_gemm_a2a_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`qkv_gemm_a2a` (JAX's XLA contract: every
    source projected onto every owner's heads, then exchanged): one fp32
    product of every rank's rows by every owner's weight, rounded once:
    (n_owner, n_src, S_loc, cols_loc)."""
    n, s_loc, d = x.shape
    cols = w.shape[1]
    z = tp_gemm.mm_f32(x.reshape(n * s_loc, d), w.reshape(n * cols, d))
    return (z.view(n, s_loc, n, cols).permute(2, 0, 1, 3)
            .to(x.dtype, memory_format=torch.contiguous_format))


def qkv_gemm_a2a(x: torch.Tensor, w: torch.Tensor, ctx: UlyssesFusedContext,
                 *, fault: int = 0, timeout_s: float = shmem.TIMEOUT_S,
                 check: bool = False) -> torch.Tensor:
    """Fused QKV projection + head-scatter all-to-all: x (n, S_loc, d), w
    (n, cols_loc, d) grouped by owner → (n, n, S_loc, cols_loc),
    ``out[o][s] = x[s] · w[o]ᵀ``. On a CUDA tensor one launch of
    ``ulysses_qkv_a2a_kernel``; on a CPU tensor :func:`qkv_gemm_a2a_ref`.
    ``fault`` (a value of :data:`FAULTS`), ``timeout_s`` and ``check`` as
    in :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    n = _ranks(ctx, x, "qkv_gemm_a2a")
    _, s_loc, d = x.shape
    if w.dim() != 3 or w.shape[0] != n or w.shape[2] != d:
        raise ValueError(f"w dims {tuple(w.shape)}: expected (n={n}, "
                         f"cols_loc, d={d})")
    if x.device.type == "cpu":
        return qkv_gemm_a2a_ref(x, w)
    tp_gemm.check_cuda("qkv_gemm_a2a", x, w)
    if not x.is_contiguous():
        raise ValueError("qkv_gemm_a2a: x must be contiguous")
    dev = x.device
    cols = w.shape[1]
    n_rb = -(-s_loc // ROW_BLOCK)
    # A planted fault leaves a slot unwritten: zeros keep it visible.
    out = (torch.zeros if fault else torch.empty)(
        (n, n, s_loc, cols), dtype=x.dtype, device=dev)
    ws = shmem.workspace("ulysses_qkv_a2a", (s_loc,), n=n, device=dev,
                         n_flags=n * n * n_rb)

    def describe(rank, step, slot):
        return (f"qkv_gemm_a2a: rank {rank} waited for row block "
                f"{slot % n_rb} of rank {step}'s projection onto its heads "
                f"(flag slot {slot}) past {timeout_s} s")

    tp_gemm.launch(QKV_KERNEL, ws, describe, x.data_ptr(), w.data_ptr(),
                   out.data_ptr(), w.stride(0), w.stride(1), n, s_loc, d,
                   cols, device=dev, timeout_s=timeout_s, fault=fault,
                   check=check)
    return out


def o_a2a_gemm_ref(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`o_a2a_gemm` (JAX's XLA contract
    ``einsum("nsr,nrd->sd")`` over the received chunks): rank r's rows of
    every source, side by side in source order, times the owners' columns
    of W_o in the same order, one fp32 contraction rounded once:
    (n, S_loc, d)."""
    n, s, rows = o.shape
    d = w.shape[1]
    s_loc = s // n
    recv = o.view(n, n, s_loc, rows).permute(1, 2, 0, 3).reshape(
        n * s_loc, n * rows)
    w_cat = w.permute(1, 0, 2).reshape(d, n * rows)
    return tp_gemm.mm_f32(recv, w_cat).view(n, s_loc, d).to(o.dtype)


def o_a2a_gemm(o: torch.Tensor, w: torch.Tensor, ctx: UlyssesFusedContext,
               *, fault: int = 0, timeout_s: float = shmem.TIMEOUT_S,
               check: bool = False) -> torch.Tensor:
    """Fused gather all-to-all + O projection: o (n, S, rows_loc), rank r's
    heads over the whole sequence; w (n, d, rows_loc), owner s's columns of
    W_o (a strided view is fine) → (n, S_loc, d). On a CUDA tensor one
    launch of ``ulysses_o_a2a_kernel``; on a CPU tensor
    :func:`o_a2a_gemm_ref`. ``fault``, ``timeout_s`` and ``check`` as in
    :func:`qkv_gemm_a2a`."""
    n = _ranks(ctx, o, "o_a2a_gemm")
    _, s, rows_loc = o.shape
    if w.dim() != 3 or w.shape[0] != n or w.shape[2] != rows_loc:
        raise ValueError(f"w shape {tuple(w.shape)} mismatches (n={n}, d, "
                         f"rows_loc={rows_loc})")
    if s % n:
        raise ValueError(f"sequence {s} not divisible by sp={n}")
    if o.device.type == "cpu":
        return o_a2a_gemm_ref(o, w)
    tp_gemm.check_cuda("o_a2a_gemm", o, w)
    if not o.is_contiguous():
        raise ValueError("o_a2a_gemm: o must be contiguous")
    dev = o.device
    s_loc, d = s // n, w.shape[1]
    n_rb = -(-s_loc // ROW_BLOCK)
    ws = shmem.workspace("ulysses_o_a2a", (s_loc, rows_loc), n=n, device=dev,
                         n_flags=n * n * n_rb, buffers={
                             "recv": ((n, s_loc, rows_loc), torch.bfloat16)})
    out = torch.empty((n, s_loc, d), dtype=o.dtype, device=dev)

    def describe(rank, step, slot):
        return (f"o_a2a_gemm: rank {rank} waited for row block {slot % n_rb} "
                f"of rank {step}'s attention rows (flag slot {slot}) past "
                f"{timeout_s} s")

    tp_gemm.launch(O_KERNEL, ws, describe, o.data_ptr(), w.data_ptr(),
                   ws.buffers["recv"].data_ptr(), out.data_ptr(), w.stride(0),
                   w.stride(1), n, s_loc, rows_loc, d,
                   SWIZZLE_MODES.index(ctx.swizzle_mode), device=dev,
                   timeout_s=timeout_s, fault=fault, check=check)
    return out


def group_qkv_columns(w_qkv: torch.Tensor, *, n: int, num_heads: int,
                      num_kv_heads: int, head_dim: int) -> torch.Tensor:
    """Rearrange a ((H + 2·KV)·hd, d) QKV weight (q rows, then k, then v)
    into the owner-grouped (n, cols_loc, d) layout :func:`qkv_gemm_a2a`
    takes: rank r's block is [its q heads | its k heads | its v heads]
    (GQA-aware). A copy: group once per set of weights."""
    if num_heads % n or num_kv_heads % n:
        raise ValueError(f"heads {num_heads}/{num_kv_heads} not divisible "
                         f"by sp={n}")
    d = w_qkv.shape[1]
    h_loc, kv_loc = num_heads // n, num_kv_heads // n
    q, k, v = torch.split(w_qkv, [num_heads * head_dim,
                                  num_kv_heads * head_dim,
                                  num_kv_heads * head_dim])
    parts = [q.reshape(n, h_loc * head_dim, d),
             k.reshape(n, kv_loc * head_dim, d),
             v.reshape(n, kv_loc * head_dim, d)]
    return torch.cat(parts, dim=1)     # (n, (h + 2kv)_loc · hd, d)


def group_o_rows(w_o: torch.Tensor, *, n: int, num_heads: int,
                 head_dim: int) -> torch.Tensor:
    """(d, H·hd) O-projection → (n, d, rows_loc), owner r's columns: a view
    (:func:`~triton_dist_tpu_torch.ops.tp_gemm.row_shards`)."""
    if num_heads % n or w_o.shape[1] != num_heads * head_dim:
        raise ValueError(f"w_o {tuple(w_o.shape)}: expected (d, "
                         f"{num_heads}·{head_dim}) with heads divisible by "
                         f"sp={n}")
    return tp_gemm.row_shards(w_o, n)


def ulysses_attn_fused(x: torch.Tensor, w_qkv_grouped: torch.Tensor,
                       w_o_grouped: torch.Tensor, ctx: UlyssesFusedContext,
                       *, num_heads: int, num_kv_heads: int, head_dim: int,
                       causal: bool = True, qk_transform=None) -> torch.Tensor:
    """The fused Ulysses attention block: :func:`qkv_gemm_a2a` → attention
    on each rank's heads over the whole sequence → :func:`o_a2a_gemm`.

    x: (n, S_loc, d). Returns (n, S_loc, d). ``qk_transform(q, k)`` (q (n,
    S, H/n, hd), k (n, S, KV/n, hd), global positions in order) inserts
    the per-position head transforms (q/k norm + rope) between the
    exchange and the attention. The attention is one
    :func:`~triton_dist_tpu_torch.layers.tp_attn.sdpa` over every rank's
    heads with the ranks as its batch (the flash-attention kernel on a CUDA
    tensor when causal)."""
    from triton_dist_tpu_torch.layers.tp_attn import sdpa

    n, s_loc = x.shape[:2]
    h_loc, kv_loc = num_heads // n, num_kv_heads // n
    qkv = qkv_gemm_a2a(x, w_qkv_grouped, ctx)       # (n, n, S_loc, cols)
    s = n * s_loc
    qkv = qkv.view(n, s, -1)
    q = qkv[..., :h_loc * head_dim].reshape(n, s, h_loc, head_dim)
    k = qkv[..., h_loc * head_dim:(h_loc + kv_loc) * head_dim].reshape(
        n, s, kv_loc, head_dim)
    v = qkv[..., (h_loc + kv_loc) * head_dim:].reshape(
        n, s, kv_loc, head_dim)
    if qk_transform is not None:
        q, k = qk_transform(q, k)
    o = sdpa(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    return o_a2a_gemm(o.reshape(n, s, h_loc * head_dim), w_o_grouped, ctx)
