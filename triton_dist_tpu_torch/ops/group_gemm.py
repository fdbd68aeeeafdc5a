"""Grouped expert GEMM for MoE (counterpart of
``triton_dist_tpu/ops/group_gemm.py``).

Two forms, as in the JAX package:

- :func:`grouped_gemm` / :func:`grouped_swiglu`: rows sorted by expert
  with unpadded segments. JAX computes them with ``jax.lax.ragged_dot``,
  outside any Pallas kernel, so the port computes them as plain PyTorch,
  one product per expert segment (the segment sizes are read on the
  host).
- :func:`grouped_gemm_tiles`: the row-tile-aligned expert-major layout of
  :func:`~triton_dist_tpu_torch.ops.ag_moe.prepare_grouped_tokens`, where
  row tile i belongs to expert ``tile_expert[i]``. On a CUDA tensor it
  launches ``group_gemm_kernel`` (``csrc/group_gemm.cu``), which replaces
  the Pallas ``_gg_tiles_kernel``; on a CPU tensor it runs
  :func:`grouped_gemm_tiles_ref`, JAX's per-tile product. Nothing is read
  on the host. The weights may be strided views (a tensor-parallel rank's
  ffn shard, :func:`~triton_dist_tpu_torch.layers.tp_moe.param_specs`),
  and a leading rank dimension runs n simulated ranks in one launch, with
  one tile map for every rank or a map of each rank's own, and optionally
  each rank's count of the tiles that hold a real row (the rest store
  zeros without being multiplied). JAX's ``block_n``/``block_k`` (VMEM
  tilings) have no counterpart; ``grouped_gemm_tiles_tuned`` waits for the
  autotuner (ROADMAP.md).

Expert weights are stored ``(E, out, in)`` (:mod:`~triton_dist_tpu_torch.
layers.ep_moe`), the transpose of JAX's ``(E, in, out)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.utils.build import CudaKernel

# ``KERNEL.launches`` counts launches of the CUDA kernel.
KERNEL = CudaKernel("group_gemm.cu", "tdt_group_gemm_bf16",
                    [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                    + [ctypes.c_void_p] + [ctypes.c_int] * 2
                    + [ctypes.c_void_p] + [ctypes.c_int] * 7
                    + [ctypes.c_longlong] * 6)


def sort_by_expert(tokens: torch.Tensor, expert_ids: torch.Tensor,
                   num_experts: int):
    """Sort (slots, d) tokens by expert id, stable (-1, an empty slot,
    goes last). Returns ``(sorted_tokens, group_sizes (num_experts,)
    int32, inverse permutation restoring slot order)``."""
    key = torch.where(expert_ids < 0, torch.full_like(expert_ids,
                                                      num_experts),
                      expert_ids).long()
    order = torch.argsort(key, stable=True)
    inv = torch.argsort(order)
    sizes = torch.bincount(key[order], minlength=num_experts + 1)
    return tokens[order], sizes[:num_experts].to(torch.int32), inv


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 ``x @ w.T``: on the card bf16 products accumulate in fp32 in
    one ``mm`` (``preferred_element_type=float32`` of the JAX package);
    elsewhere in fp32."""
    if x.is_cuda and x.dtype != torch.float32:
        return torch.mm(x, w.t(), out_dtype=torch.float32)
    return F.linear(x.float(), w.float())


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 batched ``a @ b``: on the card bf16 products accumulate in
    fp32 in one ``bmm``; elsewhere in fp32."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def grouped_swiglu(x: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor,
                   group_sizes: torch.Tensor, ranks: int = 1) -> torch.Tensor:
    """Per-expert SwiGLU MLP over expert-sorted rows (M, d): rows of group
    e go through ``w_gate[e]``, ``w_up[e]`` (E, f, d) and ``w_down[e]``
    (E, d, f). The gate and up products stay fp32, the activation rounds
    to ``x.dtype`` and the down product returns in ``x.dtype``, as the JAX
    version's ``ragged_dot`` calls. Returns (ranks, M, d): with ``ranks``
    n, the ffn dimension is cut into n tensor-parallel shards and rank r's
    partial is the down product over its shard (rows ``[r·F, (r+1)·F)`` of
    ``w_gate``/``w_up``, the same columns of ``w_down``; F = f/n). Every
    rank's products of one segment run together: gate/up over the whole
    ffn dimension, down as one batched product. The segment sizes are
    read on the host (one sync per call)."""
    m, d = x.shape
    fl = w_gate.shape[1] // ranks
    out = x.new_zeros((ranks, m, d))
    start = 0
    for e, cnt in enumerate(group_sizes.tolist()):
        if cnt == 0:
            continue
        seg = x[start:start + cnt]
        g = _mm_f32(seg, w_gate[e])
        u = _mm_f32(seg, w_up[e])
        h = (F.silu(g) * u).to(x.dtype).view(cnt, ranks, fl).transpose(0, 1)
        wd = w_down[e].view(d, ranks, fl).permute(1, 2, 0)   # (n, F, d)
        out[:, start:start + cnt] = _bmm_f32(h, wd).to(x.dtype)
        start += cnt
    return out


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (M, d) sorted by group; w: (E, f, d); group_sizes: (E,). Rows of
    group e times ``w[e]``, fp32 sums, returned in ``x.dtype`` (JAX's
    ``ragged_dot`` form). Rows past the groups are zero."""
    out = x.new_zeros((x.shape[0], w.shape[1]))
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            out[start:start + n] = _mm_f32(x[start:start + n],
                                           w[e]).to(x.dtype)
            start += n
    return out


Weights = Union[torch.Tensor, Sequence[torch.Tensor]]


def as_weights(w: Weights, ranks: bool = False):
    """One or two weights (E, f, d) of one E and d, or with ``ranks`` (n,
    E, f, d) of one n too."""
    ws = (w,) if isinstance(w, torch.Tensor) else tuple(w)
    if not 1 <= len(ws) <= 2:
        raise ValueError(f"one or two weights, got {len(ws)}")
    lead = 2 if ranks else 1
    for t in ws:
        if (t.dim() != lead + 2 or t.shape[:lead] != ws[0].shape[:lead]
                or t.shape[-1] != ws[0].shape[-1]):
            want = "(n, E, f, d)" if ranks else "(E, f, d)"
            raise ValueError(f"weights {[tuple(t.shape) for t in ws]} are "
                             f"not {want} of one "
                             f"{'n, E' if ranks else 'E'} and d")
    return ws


def _tile_maps(tile_expert: torch.Tensor, used, ranks: int):
    """Check the tile map and the used counts of :func:`grouped_gemm_tiles`
    (``ranks`` 0: one rank); returns ``(tiles, chunks)``."""
    per_rank = tile_expert.dim() == 2
    if tile_expert.dim() not in (1, 2) or (per_rank and (
            not ranks or tile_expert.shape[0] != ranks)):
        raise ValueError(f"tile_expert {tuple(tile_expert.shape)}: expected "
                         f"(tiles,) or, with {ranks} ranks, (n, tiles)")
    tiles = tile_expert.shape[-1]
    if used is None:
        return tiles, 1
    if used.dim() not in (1, 2) or (used.dim() == 2 and (
            not ranks or used.shape[0] != ranks)):
        raise ValueError(f"used {tuple(used.shape)}: expected (chunks,) or, "
                         f"with {ranks} ranks, (n, chunks)")
    chunks = used.shape[-1]
    if chunks == 0 or tiles % chunks:
        raise ValueError(f"{chunks} used counts do not cut {tiles} tiles into "
                         "equal chunks")
    return tiles, chunks


def grouped_gemm_tiles(x_sorted: torch.Tensor, w: Weights,
                       tile_expert: torch.Tensor,
                       used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped GEMM over a row-tile-aligned expert-major layout.

    ``x_sorted``: (S, d), every row tile owned by one expert; ``w``: (E, f,
    d), or a pair of them whose outputs stand side by side (the MoE gate
    and up weights: columns ``[0, f0)`` from the first, ``[f0, f0 + f1)``
    from the second, with no concatenated copy); ``tile_expert``: (S //
    tm,) int32, the row tile ``tm`` inferred from it. Each output is an
    fp32 sum rounded once to ``x_sorted.dtype``. Returns (S, sum of f).

    Simulated ranks: ``x_sorted`` (n, S, d) and weights (n, E, f, d), rank
    r's shard at ``[r]`` (views: any rank, expert and row stride, unit
    stride along d), ``tile_expert`` one map (S // tm,) for every rank or
    (n, S // tm), each rank's own: returns (n, S, sum of f), one launch.

    ``used`` (int32): the map's tiles cut into ``chunks`` equal chunks,
    the leading tiles of each chunk that hold a real row, (chunks,) or,
    with ranks, (n, chunks) per rank; a tile past its chunk's count is
    not multiplied and its rows are zeros (the sorted layout's all-padding
    tail, whose product is zero)."""
    ranks = x_sorted.dim() == 3
    ws = as_weights(w, ranks)
    s, d = x_sorted.shape[-2:]
    n = x_sorted.shape[0] if ranks else 1
    n_tiles, chunks = _tile_maps(tile_expert, used, n if ranks else 0)
    if (n_tiles == 0 or s % n_tiles or ws[0].shape[-1] != d
            or (ranks and ws[0].shape[0] != n)):
        raise ValueError(f"x_sorted {tuple(x_sorted.shape)}, {n_tiles} "
                         f"tiles, weights {tuple(ws[0].shape)}")
    if x_sorted.device.type == "cpu":
        if used is None:
            return grouped_gemm_tiles_ref(x_sorted, ws, tile_expert)
        return grouped_gemm_tiles_ref(x_sorted, ws, tile_expert, used=used)
    tm = s // n_tiles
    dev = x_sorted.device
    if dev.type != "cuda":
        raise RuntimeError(f"grouped_gemm_tiles runs on CUDA tensors (got "
                           f"{dev}); only CPU tensors take the plain version")
    for t in (x_sorted, *ws):
        if t.device != dev or t.dtype != torch.bfloat16:
            raise TypeError(f"expected bf16 tensors on {dev}, got {t.dtype} "
                            f"on {t.device}")
    if not x_sorted.is_contiguous() or x_sorted.data_ptr() % 16:
        raise ValueError("x_sorted must be contiguous and 16-byte aligned")
    for t in ws:
        if t.stride(-1) != 1 or t.data_ptr() % 16:
            raise ValueError("the weights need unit stride along d and a "
                             "16-byte aligned start")
    for name, t in (("tile_expert", tile_expert), ("used", used)):
        if t is not None and (t.device != dev or t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous int32 on {dev}")
    if tm > 64 and tm % 64:
        raise ValueError(f"row tile {tm}: the kernel takes tiles of at most "
                         "64 rows or multiples of 64")
    f0 = ws[0].shape[-2]
    f1 = ws[1].shape[-2] if len(ws) == 2 else 0

    def strides(t):   # (rank, expert, row)
        return (t.stride(0) if ranks else 0, t.stride(-3), t.stride(-2))

    out = x_sorted.new_empty((*x_sorted.shape[:-1], f0 + f1))
    KERNEL.launch(x_sorted.data_ptr(), ws[0].data_ptr(),
                  ws[1].data_ptr() if f1 else None, tile_expert.data_ptr(),
                  n_tiles if tile_expert.dim() == 2 else 0,
                  None if used is None else used.data_ptr(),
                  chunks if used is not None and used.dim() == 2 else 0,
                  n_tiles // chunks, out.data_ptr(), n, s, d,
                  ws[0].shape[-3], f0, f1, tm, *strides(ws[0]),
                  *(strides(ws[1]) if f1 else (0, 0, 0)), device=dev)
    return out


def grouped_gemm_tiles_ref(x_sorted: torch.Tensor, w: Weights,
                           tile_expert: torch.Tensor, *,
                           used: Optional[torch.Tensor] = None,
                           tiles_per_step: int = 16) -> torch.Tensor:
    """Plain version, JAX's per-tile product: each row tile times its
    expert's weight in fp32, rounded once to ``x_sorted.dtype``; tiles past
    their chunk's ``used`` count are zeros. The weight gather runs
    ``tiles_per_step`` tiles at a time, so it never holds every tile's
    weights at once. Simulated ranks (a leading rank dimension on
    ``x_sorted`` and the weights) run one after another."""
    if x_sorted.dim() == 3:
        ws = as_weights(w, True)

        def mine(t, r):
            return None if t is None else t[r] if t.dim() == 2 else t

        return torch.stack([
            grouped_gemm_tiles_ref(x_sorted[r], [t[r] for t in ws],
                                   mine(tile_expert, r), used=mine(used, r),
                                   tiles_per_step=tiles_per_step)
            for r in range(x_sorted.shape[0])])
    ws = as_weights(w)
    s, d = x_sorted.shape
    n_tiles = tile_expert.shape[0]
    tm = s // n_tiles
    tiles = x_sorted.reshape(n_tiles, tm, d)
    te = tile_expert.long()
    out = x_sorted.new_empty((n_tiles, tm, sum(t.shape[1] for t in ws)))
    for i in range(0, n_tiles, tiles_per_step):
        sl = slice(i, i + tiles_per_step)
        a = tiles[sl].float()
        out[sl] = torch.cat([torch.bmm(a, t[te[sl]].float().transpose(1, 2))
                             for t in ws], dim=-1).to(out.dtype)
    if used is not None:
        per = n_tiles // used.shape[0]
        idx = torch.arange(n_tiles, device=used.device)
        out[idx % per >= used.long()[idx // per]] = 0
    return out.reshape(s, -1)
