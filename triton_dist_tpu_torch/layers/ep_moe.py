"""MoE expert weights and the Qwen3-MoE router (counterpart of the
``init`` and ``route`` of ``triton_dist_tpu/layers/ep_moe.py``).

The expert-parallel dispatch/combine half of that module (the
``transport`` knobs, hot-expert replicas) spans ranks and is not ported
yet (ROADMAP.md, queue A item 5). The experts run the tensor-parallel
regime (:mod:`~triton_dist_tpu_torch.layers.tp_moe`), at one rank or over
simulated ranks.

The JAX package stores ``router`` as ``(d, E)``, ``w_gate``/``w_up`` as
``(E, d, f)`` and ``w_down`` as ``(E, f, d)`` and multiplies ``x @ w``.
The port stores each as ``(out_features, in_features)``, the layout
``F.linear`` takes: ``router (E, d)``, ``w_gate``/``w_up (E, f, d)``,
``w_down (E, d, f)``
(:func:`~triton_dist_tpu_torch.models.convert.from_jax_params` transposes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from triton_dist_tpu_torch.layers.tp_attn import empty_param


class MoE(nn.Module):
    """One layer's router and ``num_experts`` SwiGLU experts."""

    def __init__(self, cfg, *, device=None, dtype=torch.bfloat16):
        super().__init__()
        d, f, e = (cfg.hidden_size, cfg.moe_intermediate_size,
                   cfg.num_experts)
        kw = dict(device=device, dtype=dtype)
        self.router = empty_param((e, d), **kw)
        self.w_gate = empty_param((e, f, d), **kw)
        self.w_up = empty_param((e, f, d), **kw)
        self.w_down = empty_param((e, d, f), **kw)


def init(cfg, *, generator: torch.Generator, device=None,
         dtype=torch.bfloat16) -> MoE:
    """Random weights with the JAX package's scales (``N(0, 1)·d^-½`` for
    the router, gate and up, ``·f^-½`` for down), drawn from
    ``generator``; the numbers differ from JAX's for the same seed."""
    p = MoE(cfg, device=device, dtype=dtype)
    d, f = cfg.hidden_size, cfg.moe_intermediate_size
    with torch.no_grad():
        for w, scale in ((p.router, d ** -0.5), (p.w_gate, d ** -0.5),
                         (p.w_up, d ** -0.5), (p.w_down, f ** -0.5)):
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=device, dtype=dtype))
            w.mul_(scale)
    return p


def route(router_w: torch.Tensor, x: torch.Tensor, topk: int, *,
          norm_topk_prob: bool = True):
    """Qwen3-MoE router: fp32 softmax over the experts, then the top-k
    (the lower expert id first among equal probabilities, as
    ``jax.lax.top_k``), renormalised to sum to one when
    ``norm_topk_prob``. Returns ``(ids (t, k) int32, weights (t, k)
    fp32)``."""
    logits = F.linear(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_ids = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    topk_w, topk_ids = topk_w[:, :topk], topk_ids[:, :topk]
    if norm_topk_prob:
        topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)
    return topk_ids.to(torch.int32), topk_w
