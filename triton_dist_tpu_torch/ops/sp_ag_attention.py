"""KV-allgather attention for the long-context prefill of sequence
parallelism (counterpart of ``triton_dist_tpu/ops/sp_ag_attention.py``:
``sp_ag_attention_ref``, ``_masked_attn``, ``sp_ag_attention``,
``sp_ag_attention_fused`` and ``sp_ag_attention_2d``).

The ranks are the leading dimension (:mod:`~triton_dist_tpu_torch.
parallel.mesh`): q (n, S_loc, H, hd), k/v (n, S_loc, KV, hd), rank r
holding global positions ``[r·S_loc, (r+1)·S_loc)``; every function
returns (n, S_loc, H, hd). ``cu_seqlens`` ((num_seqs+1,) int32 packed
boundaries, cu[0] = 0, cu[-1] = n·S_loc, unused tail entries padded with
the total) switches to the varlen form: each query attends causally within
its own sequence only; it requires ``causal=True``.

- :func:`sp_ag_attention_ref`, the oracle: the whole sequence's K/V, then
  dense attention (:func:`_masked_attn`) at each rank's query offset.
- :func:`sp_ag_attention`: JAX's ring composition (KV chunks rotating one
  hop a step, flash-style online softmax in fp32), as plain PyTorch on the
  stacked ranks.
- :func:`sp_ag_attention_fused`: on a CUDA tensor one cooperative launch of
  ``sp_ag_attention_kernel`` (``csrc/sp_ag_attention.cu``, row 31): every
  rank pushes its KV chunk at entry into a persistent receive buffer of the
  ranks that read it (causal: the ranks above; varlen: pruned by JAX's
  ``span_need``), then each query tile walks the chunks in ring-arrival
  order with one arrival wait per source, KV at its true head count. On a
  CPU tensor it runs :func:`sp_ag_attention_ref`, its plain version.
- :func:`sp_ag_attention_2d`, the hierarchical form, raises: ROADMAP.md
  queue A item 6.

JAX's ``block_q``/``block_kv`` (VMEM tiles), ``prefetch_depth``,
``force_kernel`` and ``sim_ranks`` steer only the TPU kernel and have no
counterpart.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

FAULTS = {"slot_off_by_one": 1, "lost_signal": 2}
ROW_BLOCK_BYTES = 512 << 10    # bytes of K (and of V) a put item moves
MAX_BOUNDARIES = 512           # csrc/sp_ag_attention.cu kMaxCu
# Query rows of one dense block of the plain version: its fp32 scores stay
# near 1 GiB at Qwen3-8B width over S = 32768.
PLAIN_SCORES_ELEMS = 1 << 28

# ``KERNEL.launches`` counts launches of the CUDA kernel.
KERNEL = CudaKernel("sp_ag_attention.cu", "tdt_sp_ag_attention",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_uint64] * 2
                    + [ctypes.c_int])


def _check_varlen(causal: bool, cu_seqlens) -> None:
    if cu_seqlens is not None and not causal:
        raise ValueError("varlen (cu_seqlens) requires causal=True")


def _seq_of(cu_seqlens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Sequence id of each packed position: the count of sequence ends
    ``cu_seqlens[1:]`` at or before it (JAX's ``_seq_of``)."""
    cu = cu_seqlens.to(device=pos.device, dtype=torch.int64)
    return (cu[1:] <= pos[..., None]).sum(-1)


def _masked_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_offset: int, causal: bool = True,
                 cu_seqlens=None) -> torch.Tensor:
    """Dense attention where query row i sits at global position
    ``q_offset + i``: q (Sq, H, hd), k/v (Skv, KV, hd) → (Sq, H, hd). fp32
    scores divided by √hd and softmax, the probabilities rounded to v's
    dtype before P·V, as JAX's; query heads grouped by KV head (no K/V
    repeat). ``cu_seqlens`` confines each query to its own sequence. The
    queries run in blocks, so the scores of a long sequence fit."""
    sq, h, hd = q.shape
    skv, kvh = k.shape[:2]
    rep = h // kvh
    kf, ki = k.float(), torch.arange(skv, device=q.device)
    blk = max(1, min(sq, PLAIN_SCORES_ELEMS // max(1, h * skv)))
    outs = []
    for q0 in range(0, sq, blk):
        qb = q[q0:q0 + blk]
        scores = torch.einsum("qgrd,kgd->grqk",
                              qb.float().reshape(-1, kvh, rep, hd), kf)
        scores = scores / math.sqrt(hd)
        if causal:
            qi = q_offset + q0 + torch.arange(qb.shape[0], device=q.device)
            mask = ki[None, :] <= qi[:, None]
            if cu_seqlens is not None:
                mask = mask & (_seq_of(cu_seqlens, qi)[:, None]
                               == _seq_of(cu_seqlens, ki)[None, :])
            # A causal query always sees itself: no fully masked row.
            scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        del scores
        outs.append(torch.einsum("grqk,kgd->qgrd", probs, v).reshape(
            qb.shape[0], h, hd))
    return torch.cat(outs).to(q.dtype)


def sp_ag_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, axis: str = "sp", causal: bool = True,
                        cu_seqlens=None) -> torch.Tensor:
    """Oracle: every rank gathers the whole sequence's K/V, then dense
    (per-sequence) attention at its query offset."""
    _check_varlen(causal, cu_seqlens)
    n, s_loc = q.shape[:2]
    k_full = k.reshape(n * s_loc, *k.shape[2:])
    v_full = v.reshape(n * s_loc, *v.shape[2:])
    return torch.stack([
        _masked_attn(q[r], k_full, v_full, r * s_loc, causal=causal,
                     cu_seqlens=cu_seqlens) for r in range(n)])


def sp_ag_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    axis: str = "sp", causal: bool = True,
                    cu_seqlens=None) -> torch.Tensor:
    """JAX's ring composition on the stacked ranks: at ring step t rank r
    holds the KV chunk of rank (r - t) mod n (the rotation is an index
    here) and folds it into fp32 online-softmax state, the probabilities
    kept in fp32 for P·V; GQA grouped, KV at its true head count. Dense
    per step: for small shapes (the CPU tests), not the card's
    32768-token sequences."""
    _check_varlen(causal, cu_seqlens)
    n, s_loc, h, hd = q.shape
    if n == 1:
        return _masked_attn(q[0], k[0], v[0], 0, causal=causal,
                            cu_seqlens=cu_seqlens)[None]
    kvh = k.shape[2]
    rep = h // kvh
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    q32 = q.float().reshape(n, s_loc, kvh, rep, hd)
    ranks = torch.arange(n, device=dev)
    qi = ranks[:, None] * s_loc + torch.arange(s_loc, device=dev)  # (n, q)
    m = torch.full((n, h, s_loc), float("-inf"), device=dev)
    l = torch.zeros((n, h, s_loc), device=dev)
    acc = torch.zeros((n, h, s_loc, hd), device=dev)
    for shift in range(n):
        src = (ranks - shift) % n
        kc, vc = k[src].float(), v[src].float()
        s_blk = torch.einsum("nqgrd,nkgd->ngrqk", q32, kc).reshape(
            n, h, s_loc, s_loc) * scale
        if causal:
            ki = src[:, None] * s_loc + torch.arange(s_loc, device=dev)
            mask = ki[:, None, :] <= qi[:, :, None]               # (n, q, k)
            if cu_seqlens is not None:
                mask = mask & (_seq_of(cu_seqlens, qi)[:, :, None]
                               == _seq_of(cu_seqlens, ki)[:, None, :])
            s_blk = s_blk.masked_fill(~mask[:, None], float("-inf"))
        m_new = torch.maximum(m, s_blk.amax(-1))
        # Guard fully masked rows (m_new = -inf) against NaN.
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s_blk - m_safe[..., None])
        p = torch.where(torch.isfinite(s_blk), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("ngrqk,nkgd->ngrqd",
                          p.reshape(n, kvh, rep, s_loc, s_loc), vc)
        acc = acc * corr[..., None] + pv.reshape(n, h, s_loc, hd)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def sp_ag_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, ctx: MeshContext, axis: str = "sp",
                          causal: bool = True, cu_seqlens=None,
                          fault: int = 0, timeout_s: float = shmem.TIMEOUT_S,
                          check: bool = False) -> torch.Tensor:
    """Kernel-level KV-allgather attention: q (n, S_loc, H, hd), k/v (n,
    S_loc, KV, hd) sequence-sharded along ``axis`` → (n, S_loc, H, hd). On
    a CUDA tensor one launch of ``sp_ag_attention_kernel``; on a CPU tensor
    :func:`sp_ag_attention_ref`. ``fault`` (a value of :data:`FAULTS`),
    ``timeout_s`` and ``check`` as in :func:`~triton_dist_tpu_torch.ops.
    tp_gemm.launch`."""
    _check_varlen(causal, cu_seqlens)
    tp_gemm.check_axis("sp_ag_attention_fused", ctx, axis)
    n = ctx.size(axis)
    if q.dim() != 4 or q.shape[0] != n or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (n={n}, S_loc, H, hd) "
                         "and (n, S_loc, KV, hd) with H a multiple of KV")
    if q.device.type == "cpu":
        return sp_ag_attention_ref(q, k, v, causal=causal,
                                   cu_seqlens=cu_seqlens)
    tp_gemm.check_cuda("sp_ag_attention_fused", q, k, v)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("sp_ag_attention_fused: q, k and v must be "
                         "contiguous")
    _, s_loc, h, hd = q.shape
    kvh = k.shape[2]
    if hd % 8 or hd > 256:
        raise ValueError(f"head_dim={hd}: the kernel takes multiples of 8 "
                         "up to 256")
    dev = q.device
    cu = None
    if cu_seqlens is not None:
        cu = torch.as_tensor(cu_seqlens, dtype=torch.int32).to(dev)
        if cu.dim() != 1 or not 2 <= cu.numel() <= MAX_BOUNDARIES:
            raise ValueError(f"cu_seqlens: 2 to {MAX_BOUNDARIES} boundaries "
                             f"(got {tuple(cu.shape)})")
        cu = cu.contiguous()
    rb_rows = max(1, min(s_loc, ROW_BLOCK_BYTES // (kvh * hd * 2)))
    n_rb = -(-s_loc // rb_rows)
    ws = shmem.workspace(
        "sp_ag_attention", (s_loc, kvh, hd, rb_rows), n=n, device=dev,
        n_flags=n * n * n_rb,
        buffers={"k": ((n, s_loc, kvh, hd), torch.bfloat16),
                 "v": ((n, s_loc, kvh, hd), torch.bfloat16)})
    out = torch.empty_like(q)

    def describe(rank, step, slot):
        return (f"sp_ag_attention_fused: rank {rank} waited for row block "
                f"{slot % n_rb} of rank {step}'s KV chunk (flag slot {slot}) "
                f"past {timeout_s} s")

    tp_gemm.launch(KERNEL, ws, describe, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), ws.buffers["k"].data_ptr(),
                   ws.buffers["v"].data_ptr(),
                   None if cu is None else cu.data_ptr(),
                   0 if cu is None else cu.numel(), n, s_loc, h, kvh, hd,
                   1.0 / math.sqrt(hd), int(causal), rb_rows, device=dev,
                   timeout_s=timeout_s, fault=fault, check=check)
    return out


def sp_ag_attention_2d(q, k, v, *, ctx: MeshContext, inner_axis: str = "sp",
                       outer_axis: str = "dp", causal: bool = True,
                       cu_seqlens=None, **_) -> Optional[torch.Tensor]:
    """JAX's hierarchical (outer x inner) form, whose mirror ranks relay
    each chunk to their inner peers: not ported."""
    raise NotImplementedError(
        "sp_ag_attention_2d (the hierarchical mirror-and-relay schedule) is "
        "not ported yet: ROADMAP.md queue A item 6")
