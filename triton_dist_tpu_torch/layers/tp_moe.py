"""Tensor-parallel MoE layer at one rank (counterpart of ``_expert_mlp``,
``fwd``, ``fwd_ar`` and ``fwd_fused`` in
``triton_dist_tpu/layers/tp_moe.py``).

Every expert is replicated and, at one rank, the ffn slice is the whole
ffn dimension, so the all-gathers, reduce-scatters and all-reduces are
the identity: ``fwd`` (prefill) and ``fwd_ar`` (decode) compute the same
grouped SwiGLU and fp32 combine. ``fwd_fused`` runs the fused pipeline in
its static expert-major layout, whose gate/up and down projections are
the row-tile grouped GEMM (PERF.md row 17's CUDA kernel on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.layers.ep_moe import MoE, route
from triton_dist_tpu_torch.ops.ag_moe import (
    ag_group_gemm, prepare_grouped_tokens, suggested_block_m)
from triton_dist_tpu_torch.ops.group_gemm import (
    grouped_gemm_tiles, grouped_swiglu, sort_by_expert)
from triton_dist_tpu_torch.ops.moe_reduce import moe_reduce_ar, moe_reduce_rs


def _expert_mlp(params: MoE, x: torch.Tensor, *, topk: int,
                num_experts: int, norm_topk_prob: bool):
    """Route, replicate each row per selected expert, sort by expert, run
    the grouped SwiGLU, un-sort. Returns ``(out (t, k, d), topk_w (t,
    k))``."""
    t, d = x.shape
    topk_ids, topk_w = route(params.router, x, topk,
                             norm_topk_prob=norm_topk_prob)
    k = topk_ids.shape[1]
    tok_rep = torch.repeat_interleave(x, k, dim=0)
    sorted_tok, group_sizes, inv = sort_by_expert(
        tok_rep, topk_ids.reshape(-1), num_experts)
    out = grouped_swiglu(sorted_tok, params.w_gate, params.w_up,
                         params.w_down, group_sizes)
    return out[inv].reshape(t, k, d), topk_w


def fwd(params: MoE, x: torch.Tensor, *, topk: int, num_experts: int,
        norm_topk_prob: bool = True) -> torch.Tensor:
    """Prefill-path MoE on (t, d) tokens: the routed experts' outputs,
    weighted by their combine weights and summed in fp32
    (:func:`~triton_dist_tpu_torch.ops.moe_reduce.moe_reduce_rs` at one
    rank), in ``x.dtype``."""
    out, topk_w = _expert_mlp(params, x, topk=topk, num_experts=num_experts,
                              norm_topk_prob=norm_topk_prob)
    return moe_reduce_rs(out, topk_w)


def fwd_ar(params: MoE, x: torch.Tensor, *, topk: int, num_experts: int,
           norm_topk_prob: bool = True) -> torch.Tensor:
    """Decode-path MoE on a (b, d) batch: :func:`fwd`'s combine, as the
    JAX version's psum over one rank."""
    out, topk_w = _expert_mlp(params, x, topk=topk, num_experts=num_experts,
                              norm_topk_prob=norm_topk_prob)
    return moe_reduce_ar(out, topk_w)


def fwd_fused(params: MoE, x: torch.Tensor, *, topk: int, num_experts: int,
              block_m: int = 64, norm_topk_prob: bool = True,
              epilogue: str = "rs") -> torch.Tensor:
    """The fused tensor-parallel MoE forward at one rank: route, sort the
    top-k-replicated tokens expert-major in ``block_m``-aligned segments
    (capped by :func:`~triton_dist_tpu_torch.ops.ag_moe.suggested_block_m`
    so padding stays below the real rows), the gate and up projections as
    ONE grouped GEMM over the two weights, SwiGLU in fp32, the down
    projection as a second grouped GEMM in the sorted layout, the un-sort
    to (token, k) order, and the ``epilogue`` combine (``"rs"`` or
    ``"ar"``, the same at one rank). Padding rows are dropped on the
    un-sort. No host read anywhere. x: (t, d) → (t, d) in ``x.dtype``."""
    if epilogue not in ("rs", "ar"):
        raise ValueError(f"unknown epilogue {epilogue!r} "
                         "(expected 'rs' or 'ar')")
    t, d = x.shape
    topk_ids, topk_w = route(params.router, x, topk,
                             norm_topk_prob=norm_topk_prob)
    block_m = suggested_block_m(t, topk, num_experts, block_m)
    x_s, te, row_src = prepare_grouped_tokens(x, topk_ids, num_experts,
                                              block_m)
    f = params.w_gate.shape[1]
    h = ag_group_gemm(x_s, (params.w_gate, params.w_up), te,
                      block_m=block_m)                   # (S, 2f)
    act = (F.silu(h[:, :f].float()) * h[:, f:].float()).to(x.dtype)
    y_sorted = grouped_gemm_tiles(act, params.w_down, te)
    # Un-sort: padding rows (row_src -1) land in a spare row past the end.
    tk = t * topk
    dst = torch.where(row_src >= 0, row_src, tk).long()
    y = y_sorted.new_zeros((tk + 1, d)).index_copy_(0, dst, y_sorted)
    reduce = moe_reduce_ar if epilogue == "ar" else moe_reduce_rs
    return reduce(y[:tk].view(t, topk, d), topk_w)
