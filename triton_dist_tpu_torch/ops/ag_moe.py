"""Expert-major token layout and the AG-MoE grouped GEMM at one rank
(counterpart of ``triton_dist_tpu/ops/ag_moe.py``: ``padded_rows``,
``suggested_block_m``, ``prepare_grouped_tokens``, ``ag_moe_ref`` and
``ag_group_gemm``).

Each rank's top-k-replicated tokens are sorted expert-major with every
expert's segment padded to the row tile ``block_m``, so tile i belongs to
one expert, ``tile_expert[i]``. The row count comes from shapes alone
(:func:`padded_rows`), so preparing the layout never reads the device
from the host. At one rank the all-gather is the identity:
:func:`ag_group_gemm` is the row-tile grouped GEMM of
:func:`~triton_dist_tpu_torch.ops.group_gemm.grouped_gemm_tiles` (the
CUDA kernel of PERF.md's row 17 on a CUDA tensor), computing what JAX's
``n == 1`` form computes (each row tile times its expert's weight, fp32
sums, one rounding) without materialising ``w[tile_expert]``. The ring
kernel ``_ag_moe_kernel`` spans ranks and waits for the expert-parallel
slice (ROADMAP.md, queue A item 5).
"""

from __future__ import annotations

from typing import Tuple

import torch

from triton_dist_tpu_torch.ops.group_gemm import (
    Weights, grouped_gemm_tiles, grouped_gemm_tiles_ref)


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


def ag_moe_ref(x_sorted: torch.Tensor, w: Weights,
               tile_expert: torch.Tensor) -> torch.Tensor:
    """Oracle at one rank (the all-gather is the identity): the per-tile
    dense product."""
    return grouped_gemm_tiles_ref(x_sorted, w, tile_expert)


def ag_group_gemm(x_sorted: torch.Tensor, w: Weights,
                  tile_expert: torch.Tensor, *, block_m: int) -> torch.Tensor:
    """All-gather of the sorted tokens times per-expert weights, at one
    rank. ``x_sorted``: (S, d) from :func:`prepare_grouped_tokens` with
    row tile ``block_m``; ``w``: (E, f, d) or the (gate, up) pair;
    ``tile_expert``: (S // block_m,). Returns (S, sum of f)."""
    s = x_sorted.shape[0]
    tm = min(block_m, s)
    if s % tm or tile_expert.shape[0] != s // tm:
        raise ValueError(f"tile_expert has {tile_expert.shape[0]} tiles, "
                         f"expected {s // tm} (S={s} / block_m={tm})")
    return grouped_gemm_tiles(x_sorted, w, tile_expert)
