"""Qwen3-MoE on one card (counterpart of
``triton_dist_tpu/models/qwen_moe.py``: ``init_params``, ``moe_ffn``,
``moe_ffn_decode``, the dense-cache ``prefill``/``forward_tokens``/
``decode_step`` and the paged ``prefill_chunk_paged``/
``decode_step_paged``).

The transformer trunk is :mod:`~triton_dist_tpu_torch.models.dense`'s,
with the MoE block plugged into its ``ffn_fn`` hook: one trunk, two
models. The experts run the tensor-parallel regime at one rank: a
prefill in ``mode="fused"`` through
:func:`~triton_dist_tpu_torch.layers.tp_moe.fwd_fused` (the row-tile
grouped GEMM kernel), otherwise :func:`~triton_dist_tpu_torch.layers.
tp_moe.fwd`; decode and paged chunks through
:func:`~triton_dist_tpu_torch.layers.tp_moe.fwd_ar`. The expert-parallel
regime, the shared expert and the per-step expert counts of the layer
path (``with_expert_counts``) are not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from triton_dist_tpu_torch.layers import ep_moe, tp_attn, tp_moe
from triton_dist_tpu_torch.layers.tp_attn import empty_param
from triton_dist_tpu_torch.models import dense
from triton_dist_tpu_torch.models.config import ModelConfig


class MoEDecoderLayer(nn.Module):
    """Attention, the MoE block (``moe``, the JAX pytree's key) and the
    two norms of one layer."""

    def __init__(self, attn: tp_attn.Attention, moe: ep_moe.MoE, cfg, *,
                 device=None, dtype=torch.bfloat16):
        super().__init__()
        self.attn = attn
        self.moe = moe
        self.ln_attn = empty_param((cfg.hidden_size,), device=device,
                                   dtype=dtype)
        self.ln_mlp = empty_param((cfg.hidden_size,), device=device,
                                  dtype=dtype)


class MoELM(dense.DenseLM):
    """:class:`~triton_dist_tpu_torch.models.dense.DenseLM` with
    :class:`MoEDecoderLayer` layers."""

    @classmethod
    def empty(cls, cfg: ModelConfig, *, device=None,
              dtype=torch.bfloat16) -> "MoELM":
        kw = dict(device=device, dtype=dtype)
        return cls(cfg, [MoEDecoderLayer(tp_attn.Attention(cfg, **kw),
                                         ep_moe.MoE(cfg, **kw), cfg, **kw)
                         for _ in range(cfg.num_hidden_layers)], **kw)


def init_layer(cfg: ModelConfig, *, generator: torch.Generator,
               device=None, dtype=torch.bfloat16) -> MoEDecoderLayer:
    """One layer's random weights (JAX scales, unit norms)."""
    kw = dict(device=device, dtype=dtype)
    layer = MoEDecoderLayer(tp_attn.init(cfg, generator=generator, **kw),
                            ep_moe.init(cfg, generator=generator, **kw),
                            cfg, **kw)
    with torch.no_grad():
        layer.ln_attn.fill_(1.0)
        layer.ln_mlp.fill_(1.0)
    return layer


def init_head(cfg: ModelConfig, *, generator: torch.Generator, device=None,
              dtype=torch.bfloat16) -> MoELM:
    """The model without layers: embedding and lm_head ``N(0, 0.02²)``,
    unit final norm. After :func:`init_layer` for every layer from the
    same generator, the numbers :func:`init_params` draws."""
    model = MoELM(cfg, [], device=device, dtype=dtype)
    with torch.no_grad():
        heads = (model.embed,) if cfg.tie_word_embeddings else (
            model.embed, model.lm_head)
        for w in heads:
            w.copy_(torch.randn(w.shape, generator=generator, device=device,
                                dtype=dtype))
            w.mul_(0.02)
        model.ln_f.fill_(1.0)
    return model


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None, dtype=torch.bfloat16) -> MoELM:
    """Random weights with the JAX package's scales, drawn from
    ``generator`` layer by layer, then the head. The same seed gives
    other numbers than JAX's ``init_params``; carry JAX weights across
    with :func:`~triton_dist_tpu_torch.models.convert.from_jax_params`."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    layers = [init_layer(cfg, **kw) for _ in range(cfg.num_hidden_layers)]
    model = init_head(cfg, **kw)
    model.layers = nn.ModuleList(layers)
    return model


def moe_ffn(moe: ep_moe.MoE, h: torch.Tensor, cfg: ModelConfig, *,
            mode: str, ctxs: dense.FwdContexts) -> torch.Tensor:
    """One prefill MoE FFN block: ``mode="fused"`` runs the fused
    pipeline (:func:`tp_moe.fwd_fused`, row tile ``ctxs.block_m``), the
    other modes :func:`tp_moe.fwd`."""
    if mode == "fused":
        return tp_moe.fwd_fused(
            moe, h, topk=cfg.num_experts_per_tok,
            num_experts=cfg.num_experts, block_m=ctxs.block_m,
            norm_topk_prob=cfg.norm_topk_prob)
    return tp_moe.fwd(moe, h, topk=cfg.num_experts_per_tok,
                      num_experts=cfg.num_experts,
                      norm_topk_prob=cfg.norm_topk_prob)


def _moe_block(layer: MoEDecoderLayer, h: torch.Tensor, cfg: ModelConfig, *,
               mode: str, ctxs: dense.FwdContexts) -> torch.Tensor:
    """The dense trunk's ``ffn_fn`` hook form of :func:`moe_ffn`."""
    return moe_ffn(layer.moe, h, cfg, mode=mode, ctxs=ctxs)


def prefill(params: MoELM, input_ids: torch.Tensor, cfg: ModelConfig, *,
            mode: str = "xla", ctxs: dense.FwdContexts = dense.FwdContexts(),
            max_len: Optional[int] = None):
    """:func:`~triton_dist_tpu_torch.models.dense.prefill` with the MoE
    block: ``(last-position logits (B, vocab), KVCache)``."""
    ffn = functools.partial(_moe_block, cfg=cfg, mode=mode, ctxs=ctxs)
    return dense.prefill(params, input_ids, cfg, mode=mode,
                         max_len=max_len, ffn_fn=ffn)


def forward_tokens(params: MoELM, input_ids: torch.Tensor, cfg: ModelConfig,
                   *, mode: str = "xla",
                   ctxs: dense.FwdContexts = dense.FwdContexts()
                   ) -> torch.Tensor:
    """Logits of every position (B, S, vocab), the MoE block in the
    trunk."""
    ffn = functools.partial(_moe_block, cfg=cfg, mode=mode, ctxs=ctxs)
    return dense.forward_tokens(params, input_ids, cfg, mode=mode,
                                ffn_fn=ffn)


def decode_step(params: MoELM, token_ids: torch.Tensor, cache,
                cfg: ModelConfig, *, mode: str = "xla"):
    """:func:`~triton_dist_tpu_torch.models.dense.decode_step` with the
    small-batch MoE FFN (:func:`tp_moe.fwd_ar`)."""
    ffn = functools.partial(_moe_ffn_decode, cfg=cfg)
    return dense.decode_step(params, token_ids, cache, cfg, mode=mode,
                             ffn_fn=ffn)


def moe_ffn_decode(moe: ep_moe.MoE, h: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Small-batch MoE FFN (decode rows, or a prefill chunk's rows): the
    tensor-parallel experts through :func:`tp_moe.fwd_ar`."""
    return tp_moe.fwd_ar(moe, h, topk=cfg.num_experts_per_tok,
                         num_experts=cfg.num_experts,
                         norm_topk_prob=cfg.norm_topk_prob)


def _moe_ffn_decode(layer: MoEDecoderLayer, h: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """The dense trunk's ``ffn_fn`` hook form (receives the layer)."""
    return moe_ffn_decode(layer.moe, h, cfg)


def prefill_chunk_paged(params: MoELM, chunk_toks: torch.Tensor, cache,
                        table_row: torch.Tensor, cfg: ModelConfig, *,
                        start: int, wfrom: int, valid: int) -> torch.Tensor:
    """One bucketed chunk of a paged prefill
    (:func:`~triton_dist_tpu_torch.models.dense.prefill_chunk_paged`)
    with the MoE FFN in the decode regime. Returns the fp32 logits
    (vocab,) of the last valid token."""
    ffn = functools.partial(_moe_ffn_decode, cfg=cfg)
    return dense.prefill_chunk_paged(params, chunk_toks, cache, table_row,
                                     cfg, start=start, wfrom=wfrom,
                                     valid=valid, ffn_fn=ffn)


def verify_step_paged(params: MoELM, token_ids: torch.Tensor, cache,
                      cfg: ModelConfig, *, budget=None) -> torch.Tensor:
    """One speculative-verify step
    (:func:`~triton_dist_tpu_torch.models.dense.verify_step_paged`) with
    the MoE FFN in the decode regime. Returns fp32 logits (S, K, vocab)."""
    ffn = functools.partial(_moe_ffn_decode, cfg=cfg)
    return dense.verify_step_paged(params, token_ids, cache, cfg,
                                   budget=budget, ffn_fn=ffn)


def decode_step_paged(params: MoELM, token_ids: torch.Tensor, cache,
                      cfg: ModelConfig) -> torch.Tensor:
    """One continuous-batching decode step
    (:func:`~triton_dist_tpu_torch.models.dense.decode_step_paged`) with
    the MoE FFN. Returns fp32 logits (S, vocab)."""
    ffn = functools.partial(_moe_ffn_decode, cfg=cfg)
    return dense.decode_step_paged(params, token_ids, cache, cfg,
                                   ffn_fn=ffn)
