"""Tensor-parallel MoE layer at one rank (counterpart of ``_expert_mlp``
and ``fwd_ar`` in ``triton_dist_tpu/layers/tp_moe.py``).

Every expert is replicated and, at one rank, the ffn slice is the whole
ffn dimension, so ``fwd_ar``'s all-reduce is the identity. The
all-gather/reduce-scatter prefill ``fwd`` and the fused ``fwd_fused``
(which reaches the grouped-GEMM Pallas kernel) wait for the dense-cache
prefill slice (ROADMAP.md, queue A item 2).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.layers.ep_moe import MoE, route
from triton_dist_tpu_torch.ops.group_gemm import (grouped_swiglu,
                                                  sort_by_expert)


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


def fwd_ar(params: MoE, x: torch.Tensor, *, topk: int, num_experts: int,
           norm_topk_prob: bool = True) -> torch.Tensor:
    """Decode-path MoE on a (b, d) batch: the routed experts' outputs,
    weighted by their combine weights and summed in fp32, in ``x.dtype``
    (the JAX version's psum over one rank)."""
    out, topk_w = _expert_mlp(params, x, topk=topk, num_experts=num_experts,
                              norm_topk_prob=norm_topk_prob)
    partial = torch.einsum("tkd,tk->td", out.float(), topk_w.float())
    return partial.to(x.dtype)
