"""Expert-major token layout and the fused all-gather + grouped GEMM
(counterpart of ``triton_dist_tpu/ops/ag_moe.py``: ``AGMoEContext``,
``create_ag_moe_context``, ``padded_rows``, ``suggested_block_m``,
``prepare_grouped_tokens``, ``ag_moe_ref`` and ``ag_group_gemm``), and
the same layout for the expert-parallel experts' received rows
(:func:`prepare_expert_rows`, every rank at once).

Each rank's top-k-replicated tokens are sorted expert-major with every
expert's segment padded to the row tile ``block_m``, so tile i belongs to
one expert, ``tile_expert[i]``. The row count comes from shapes alone
(:func:`padded_rows`), so preparing the layout never reads the device
from the host.

At one rank (a 2-D ``x_sorted``) the all-gather is the identity:
:func:`ag_group_gemm` is the row-tile grouped GEMM of
:func:`~triton_dist_tpu_torch.ops.group_gemm.grouped_gemm_tiles` (PERF.md
row 17 on a CUDA tensor), what JAX's ``n == 1`` form computes. Over n
simulated ranks (:mod:`~triton_dist_tpu_torch.parallel.mesh`: ``x_sorted``
(n, S_loc, d) stacks every rank's sorted chunk, the weights (n, E, F_loc,
d) every rank's ffn shard, views of the one weight) rank r computes the
all-gathered chunks in rank order times each tile's expert's shard,
``(n, n·S_loc, F)``: on a CUDA tensor one launch of ``ag_moe_kernel``
(``csrc/ag_moe.cu``), the ring of JAX's ``_ag_moe_kernel`` (row 19) run by
every rank's thread blocks; on a CPU tensor :func:`ag_moe_ref`. JAX's
VMEM panel budget has no counterpart: the CUDA kernel picks its tile by
the row tile.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.ops.group_gemm import (
    Weights, as_weights, grouped_gemm_tiles, grouped_gemm_tiles_ref)
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel, load

FAULTS = {"wrong_chunk": 1, "lost_signal": 2}

# ``KERNEL.launches`` counts launches of the CUDA kernel.
KERNEL = CudaKernel("ag_moe.cu", "tdt_ag_moe_bf16",
                    [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 6
                    + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
                    + [ctypes.c_uint64] * 2 + [ctypes.c_int])


@dataclasses.dataclass(frozen=True)
class AGMoEContext:
    """JAX's ``AGMoEContext``: the mesh, its axis, the expert count and
    ``block_m``, the row tile of the sorted layout. JAX's ``block_n``/
    ``block_k`` tile the TPU kernel's VMEM panels, and its ``out_dtype`` is
    the tokens' in every caller: none has a counterpart."""
    mesh: MeshContext
    axis: str = "tp"
    num_experts: int = 8
    block_m: int = 128


def create_ag_moe_context(mesh: MeshContext, *, num_experts: int,
                          axis: str = "tp",
                          block_m: int = 128) -> AGMoEContext:
    return AGMoEContext(mesh=mesh, axis=axis, num_experts=num_experts,
                        block_m=block_m)


def padded_rows(num_tokens: int, topk: int, num_experts: int,
                block_m: int) -> int:
    """Static row count of the sorted layout: every expert segment padded
    up to a multiple of ``block_m`` (worst case ``block_m - 1`` rows per
    expert), rounded up to whole tiles."""
    total = num_tokens * topk + num_experts * (block_m - 1)
    return -(-total // block_m) * block_m


def suggested_block_m(num_tokens: int, topk: int, num_experts: int,
                      block_m: int, floor: int = 8) -> int:
    """Largest power-of-two cap of ``block_m`` whose worst-case padding
    (``E·(block_m-1)`` rows) does not exceed the real row count ``T·K``
    (never below ``floor``)."""
    while block_m > floor and num_experts * (block_m - 1) > (
            num_tokens * topk):
        block_m = max(floor, block_m // 2)
    return block_m


def prepare_grouped_tokens(x: torch.Tensor, topk_ids: torch.Tensor,
                           num_experts: int, block_m: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Sort top-k-replicated tokens expert-major with ``block_m``-aligned
    expert segments.

    x: (T, d); topk_ids: (T, K). Returns ``(x_sorted (S, d), tile_expert
    (S // block_m,) int32, row_src (S,) int32)``: ``row_src[r]`` is the
    flat ``token·K + k`` assignment sorted row r came from, or -1 for a
    padding row (whose x_sorted row is zero). Tiles past the last used row
    map to the last expert, as in JAX. Every step is a device op of fixed
    shape: nothing is read on the host."""
    t, d = x.shape
    k = topk_ids.shape[1]
    e, tm = num_experts, block_m
    dev = x.device
    flat = topk_ids.reshape(-1).long()                     # (TK,)
    tk_total = t * k
    s_pad = padded_rows(t, k, e, tm)

    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat))
    pad_counts = (counts + tm - 1) // tm * tm
    bounds = torch.cumsum(pad_counts, 0)
    seg_off = bounds - pad_counts
    # Rank within the expert: position in the stable expert-major order
    # less the start of that expert's run.
    order = torch.argsort(flat, stable=True)
    sorted_exp = flat[order]
    seg_start = torch.searchsorted(sorted_exp,
                                   torch.arange(e, device=dev))
    rank_sorted = torch.arange(tk_total, device=dev) - seg_start[sorted_exp]
    rank_within = torch.empty_like(flat).scatter_(0, order, rank_sorted)
    dest = seg_off[flat] + rank_within                     # (TK,)

    x_rep = x[:, None].expand(t, k, d).reshape(tk_total, d)
    x_sorted = x.new_zeros((s_pad, d)).index_copy_(0, dest, x_rep)
    row_src = torch.full((s_pad,), -1, dtype=torch.int32,
                         device=dev).index_copy_(
        0, dest, torch.arange(tk_total, dtype=torch.int32, device=dev))
    starts = torch.arange(s_pad // tm, device=dev) * tm
    tile_expert = torch.searchsorted(bounds, starts, right=True)
    tile_expert = torch.clamp(tile_expert, max=e - 1).to(torch.int32)
    return x_sorted, tile_expert, row_src


def prepare_expert_rows(rows: torch.Tensor, expert_ids: torch.Tensor,
                        num_experts: int, block_m: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every rank's received rows in :func:`prepare_grouped_tokens`' layout,
    for the expert-parallel experts.

    rows (n, R, d): rank r's rows; expert_ids (n, R): each row's local
    expert in ``[0, num_experts)``, or -1 for an empty row (it is left
    out). Returns ``(x_sorted (n, S, d), tile_expert (n, S // block_m)
    int32, row_src (n, S) int32)`` with S = :func:`padded_rows` (R, 1,
    num_experts, block_m): rank r's rows sorted expert-major (stable) in
    ``block_m``-aligned segments, each rank's own tile map (tiles past the
    last used row map to the last expert), and each sorted row's source
    row in ``[0, R)`` or -1 for padding (a zero row). All ranks at once,
    device ops of fixed shape: nothing is read on the host."""
    n, r_rows, d = rows.shape
    e, tm = num_experts, block_m
    dev = rows.device
    s_pad = padded_rows(r_rows, 1, e, tm)
    ids = torch.where(expert_ids < 0, e, expert_ids).long()     # (n, R)
    key = (ids + (e + 1) * torch.arange(n, device=dev)[:, None]).reshape(-1)
    counts = torch.zeros(n * (e + 1), dtype=torch.long, device=dev
                         ).scatter_add_(0, key, torch.ones_like(key))
    counts = counts.view(n, e + 1)[:, :e]
    pad_counts = (counts + tm - 1) // tm * tm
    bounds = torch.cumsum(pad_counts, 1)                         # (n, E)
    seg_off = bounds - pad_counts
    # Rank within the (rank, expert) run: position in the stable sorted
    # order less the start of that run.
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    run_start = torch.searchsorted(
        sorted_key, torch.arange(n * (e + 1), device=dev))
    within = torch.empty_like(key).scatter_(
        0, order, torch.arange(n * r_rows, device=dev) - run_start[sorted_key])
    rank = torch.arange(n, device=dev).repeat_interleave(r_rows)
    flat_ids = ids.reshape(-1)
    dest = torch.where(
        flat_ids < e,
        rank * s_pad + seg_off[rank, flat_ids.clamp(max=e - 1)] + within,
        n * s_pad)                                   # empty rows: dropped
    x_sorted = rows.new_zeros((n * s_pad + 1, d)).index_copy_(
        0, dest, rows.reshape(n * r_rows, d))[:-1].view(n, s_pad, d)
    src = torch.arange(r_rows, dtype=torch.int32, device=dev).repeat(n)
    row_src = torch.full((n * s_pad + 1,), -1, dtype=torch.int32,
                         device=dev).index_copy_(0, dest, src)[:-1]
    starts = (torch.arange(s_pad // tm, device=dev) * tm).expand(n, -1)
    tile_expert = torch.searchsorted(bounds, starts.contiguous(), right=True)
    tile_expert = torch.clamp(tile_expert, max=e - 1).to(torch.int32)
    return x_sorted, tile_expert, row_src.view(n, s_pad)


def tiles_used(row_src: torch.Tensor, block_m: int) -> torch.Tensor:
    """(n, S_loc) ``row_src`` of n ranks' layouts → (n,) int32: the leading
    row tiles of each that hold a real row (the rest is the all-padding
    tail, whose rows are zeros). A device op: nothing is read on the
    host."""
    n, s = row_src.shape
    real = (row_src.view(n, s // block_m, block_m) >= 0).any(-1)
    return real.sum(-1).to(torch.int32)


def ag_moe_ref(x_sorted: torch.Tensor, w: Weights,
               tile_expert: torch.Tensor) -> torch.Tensor:
    """Plain version (JAX's oracle: the all-gather, then the per-tile
    dense product). One rank: ``x_sorted`` (S, d), ``w`` (E, f, d) or the
    (gate, up) pair, ``tile_expert`` (S // tm,). Ranks: ``x_sorted`` (n,
    S_loc, d), ``w`` (n, E, F, d) or a pair, ``tile_expert`` (n, S_loc //
    tm), every rank's map: rank r's output is the gathered chunks (in rank
    order) times its shard, (n, n·S_loc, sum of F)."""
    if x_sorted.dim() == 2:
        return grouped_gemm_tiles_ref(x_sorted, w, tile_expert)
    ws = as_weights(w, True)
    n, s_loc, d = x_sorted.shape
    x_full = x_sorted.reshape(n * s_loc, d)
    te_full = tile_expert.reshape(-1)
    return torch.stack([grouped_gemm_tiles_ref(x_full, [t[r] for t in ws],
                                               te_full) for r in range(n)])


def ag_group_gemm(x_sorted: torch.Tensor, w: Weights,
                  tile_expert: torch.Tensor,
                  ctx: Optional[AGMoEContext] = None, *,
                  block_m: Optional[int] = None,
                  te_all: Optional[torch.Tensor] = None,
                  used: Optional[torch.Tensor] = None, fault: int = 0,
                  timeout_s: float = shmem.TIMEOUT_S,
                  check: bool = False) -> torch.Tensor:
    """All-gather of the sorted tokens times per-expert weights.

    One rank: ``x_sorted`` (S, d) from :func:`prepare_grouped_tokens` with
    row tile ``block_m`` (or ``ctx.block_m``), ``w`` (E, f, d) or the
    (gate, up) pair, ``tile_expert`` (S // tm,): returns (S, sum of f).

    Ranks (``ctx.mesh``'s axis of size n): ``x_sorted`` (n, S_loc, d),
    ``w`` (n, E, F_loc, d) or a pair (each rank's ffn shard), ``tile_expert``
    (n, S_loc // tm), every rank's map (the stacked maps are JAX's
    ``te_all``; a given ``te_all`` must equal their shape): returns (n,
    n·S_loc, sum of F_loc) in global sorted order, chunk c's rows at
    ``c·S_loc``. ``used`` (n,) int32 (:func:`tiles_used`): the leading
    tiles of each chunk that hold a real row; the kernel neither sends nor
    multiplies the rest (zero rows) and stores their product, zeros.
    ``fault`` (a value of :data:`FAULTS`), ``timeout_s`` and ``check`` as
    in :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    if x_sorted.dim() == 2:
        s = x_sorted.shape[0]
        tm = min(block_m or ctx.block_m, s)
        if s % tm or tile_expert.shape[0] != s // tm:
            raise ValueError(f"tile_expert has {tile_expert.shape[0]} tiles, "
                             f"expected {s // tm} (S={s} / block_m={tm})")
        return grouped_gemm_tiles(x_sorted, w, tile_expert)
    n = ctx.mesh.size(ctx.axis)
    ws = as_weights(w, True)
    if x_sorted.dim() != 3 or x_sorted.shape[0] != n or ws[0].shape[0] != n:
        raise ValueError(f"x_sorted {tuple(x_sorted.shape)} / weights "
                         f"{tuple(ws[0].shape)}: expected (n={n}, S_loc, d) "
                         "and (n, E, F_loc, d)")
    _, s_loc, d = x_sorted.shape
    tm = min(block_m or ctx.block_m, s_loc)
    if s_loc % tm:
        raise ValueError(f"block_m={tm} must divide S_loc={s_loc}")
    if tile_expert.shape[-1] != s_loc // tm:
        raise ValueError(
            f"tile_expert has {tile_expert.shape[-1]} tiles, expected "
            f"{s_loc // tm} (S_loc={s_loc} / block_m={tm})")
    if te_all is not None and tuple(te_all.shape) != (n, s_loc // tm):
        raise ValueError(f"te_all {tuple(te_all.shape)} != "
                         f"{(n, s_loc // tm)}")
    te = tile_expert if te_all is None else te_all
    if n == 1:
        # JAX's n == 1 form: the grouped GEMM, no ring.
        return grouped_gemm_tiles(x_sorted[0], [t[0] for t in ws],
                                  te.reshape(-1))[None]
    if x_sorted.device.type == "cpu":
        return ag_moe_ref(x_sorted, ws, te)
    dev = x_sorted.device
    if dev.type != "cuda":
        raise RuntimeError(f"ag_group_gemm runs on CUDA tensors (got {dev}); "
                           "only CPU tensors take the plain version")
    for t in (x_sorted, *ws):
        if t.device != dev or t.dtype != torch.bfloat16:
            raise TypeError(f"ag_group_gemm: expected bf16 tensors on {dev}, "
                            f"got {t.dtype} on {t.device}")
    if not x_sorted.is_contiguous() or x_sorted.data_ptr() % 16 or d % 8:
        raise ValueError("ag_group_gemm: x_sorted must be contiguous and "
                         "16-byte aligned, d a multiple of 8")
    for t in ws:
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(st % 8 for st in t.stride()[:3])):
            raise ValueError("ag_group_gemm: the weights need unit stride "
                             "along d, other strides a multiple of 8 and a "
                             "16-byte aligned start")
    if tm > 64 and tm % 64:
        raise ValueError(f"row tile {tm}: the kernel takes tiles of at most "
                         "64 rows or multiples of 64")
    if used is None:
        used = torch.full((n,), s_loc // tm, dtype=torch.int32, device=dev)
    for name, t in (("tile_expert", te), ("used", used)):
        if (t.device != dev or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous int32 on {dev}")
    rb_fn = load(KERNEL.source).tdt_ag_moe_row_block
    rb_fn.argtypes, rb_fn.restype = [ctypes.c_int], ctypes.c_int
    n_rb = s_loc // rb_fn(tm)
    f0 = ws[0].shape[2]
    f1 = ws[1].shape[2] if len(ws) == 2 else 0
    # The gather buffer persists with the flags: a row block is read only
    # after its flag reaches this call's epoch.
    ws_ = shmem.workspace("ag_moe", (s_loc, tm, d), n=n,
                          n_flags=n * n * n_rb, device=dev,
                          data_shape=(n * s_loc, d),
                          data_dtype=x_sorted.dtype)
    out = torch.empty((n, n * s_loc, f0 + f1), dtype=x_sorted.dtype,
                      device=dev)

    def describe(rank, step, slot):
        c, i = divmod(slot % (n * n_rb), n_rb)
        return (f"ag_group_gemm: rank {rank} waited at ring step {step} for "
                f"row block {i} of chunk {c} (flag slot {slot}) past "
                f"{timeout_s} s")

    strides = [st for t in (ws[0], ws[1] if f1 else ws[0])
               for st in t.stride()[:3]]
    tp_gemm.launch(KERNEL, ws_, describe, x_sorted.data_ptr(),
                   ws[0].data_ptr(), ws[1].data_ptr() if f1 else None,
                   te.data_ptr(), used.data_ptr(), out.data_ptr(),
                   ws_.data.data_ptr(), *strides, n, s_loc, d,
                   ws[0].shape[1], f0, f1, tm, device=dev,
                   timeout_s=timeout_s, fault=fault, check=check)
    return out
