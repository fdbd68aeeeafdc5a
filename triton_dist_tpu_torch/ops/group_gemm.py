"""Grouped expert GEMM for MoE (counterpart of
``triton_dist_tpu/ops/group_gemm.py``: ``sort_by_expert`` and
``grouped_swiglu``).

The JAX package computes ``grouped_swiglu`` with ``jax.lax.ragged_dot``,
outside any Pallas kernel, so the port computes it as plain PyTorch: one
product per expert segment of the expert-sorted rows. Its Pallas kernel,
``_gg_tiles_kernel`` (``grouped_gemm_tiles``), runs only on the fused
tensor-parallel prefill (``Engine(mode="fused").prefill``) and waits for
that slice (ROADMAP.md, queue A item 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def grouped_swiglu(x: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU MLP over expert-sorted rows: rows of group e go
    through ``w_gate[e]``, ``w_up[e]`` (E, f, d) and ``w_down[e]`` (E, d,
    f). The gate and up products stay fp32, the activation rounds to
    ``x.dtype`` and the down product returns in ``x.dtype``, as the JAX
    version's ``ragged_dot`` calls. The segment sizes are read on the
    host (one sync per call)."""
    out = torch.zeros_like(x)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n == 0:
            continue
        seg = x[start:start + n]
        g = _mm_f32(seg, w_gate[e])
        u = _mm_f32(seg, w_up[e])
        h = (F.silu(g) * u).to(x.dtype)
        out[start:start + n] = _mm_f32(h, w_down[e]).to(x.dtype)
        start += n
    return out
