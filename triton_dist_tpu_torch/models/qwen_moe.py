"""Qwen3-MoE on one card (counterpart of
``triton_dist_tpu/models/qwen_moe.py``: ``init_params``, ``moe_ffn``,
``moe_ffn_decode``, the dense-cache ``prefill``/``forward_tokens``/
``decode_step`` and the paged ``prefill_chunk_paged``/
``decode_step_paged``).

The transformer trunk is :mod:`~triton_dist_tpu_torch.models.dense`'s,
with the MoE block plugged into its ``ffn_fn`` hook: one trunk, two
models. Two regimes, JAX's ``moe_impl``:

- ``"tp"``: the tensor-parallel experts, at one rank or, with
  ``mesh=make_mesh(tp=n)``, over n simulated ranks (the dense-cache
  functions; each rank's ffn shard a view of the one weight): a prefill in
  ``mode="fused"`` through :func:`~triton_dist_tpu_torch.layers.tp_moe.
  fwd_fused` (the row-tile grouped GEMM kernel; at tp > 1 also the
  AG+grouped GEMM and the fused reduce-scatter epilogue), otherwise
  :func:`~triton_dist_tpu_torch.layers.tp_moe.fwd`; decode and paged
  chunks through :func:`~triton_dist_tpu_torch.layers.tp_moe.fwd_ar`. At
  tp > 1 a ``"fused_ar"`` prefill's residual is replicated, where JAX's
  ``fwd`` gathers n copies of it and computes each: the port computes one,
  through ``fwd_ar``, the same values.
- ``"ep"``: the experts sharded by expert over the same ranks (an
  ``ep_ctx`` over the ``tp`` axis, as JAX's engine builds it, or an
  ``EP2DContext`` over an ``(outer, inner)`` axis pair, the trunk sharded
  over the same pair with ``axis=``), the dense-cache functions only: the
  prefill's FFN through :func:`~triton_dist_tpu_torch.layers.ep_moe.fwd`
  (:func:`~triton_dist_tpu_torch.layers.ep_moe.fwd_2d` for the pair) on
  the rows each rank holds (token-sharded (n, t/n, d) in
  ``"xla"``/``"fused"``, replicated (n, t, d) in ``"fused_ar"``, where
  every owner receives n copies, as in JAX), decode through
  :func:`~triton_dist_tpu_torch.layers.ep_moe.fwd_decode` with the
  ``transport`` knob (the ``"ll"``/``"ll2d"`` parities keyed by the layer
  index).

Not ported yet: the shared expert and the per-step expert counts of the
layer path (``with_expert_counts``, ROADMAP.md queue A item 5), and the
expert-parallel regime on the paged lanes (queue A item 8).
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
from triton_dist_tpu_torch.ops.ep_a2a import EP2DContext


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


def param_specs(params: MoELM, n: int, *, moe_impl: str = "tp"):
    """Every layer's expert shards over n ranks in the ``moe_impl`` regime,
    as views of the one weight (JAX's ``param_specs`` cuts, no copy):
    :func:`tp_moe.param_specs` (ffn rows/columns) or
    :func:`ep_moe.param_specs` (experts; over an ``(outer, inner)`` pair,
    JAX's ``ep_axis=(outer, inner)``, n = n_o·n_in outer-major ranks: the
    same views). Attention's shards are the dense model's
    (:mod:`~triton_dist_tpu_torch.ops.tp_gemm`)."""
    specs = tp_moe.param_specs if moe_impl == "tp" else ep_moe.param_specs
    return [specs(layer.moe, n) for layer in params.layers]


def moe_ffn(moe: ep_moe.MoE, h: torch.Tensor, cfg: ModelConfig, *,
            mode: str, ctxs: dense.FwdContexts, moe_impl: str = "tp",
            ep_ctx=None) -> torch.Tensor:
    """One prefill MoE FFN block in JAX's dispatch. ``moe_impl="ep"``: the
    expert-parallel layer over ``ep_ctx`` on the rows each rank holds, in
    every mode (row tile ``ctxs.block_m``; the two-hop :func:`ep_moe.fwd_2d`
    for an ``EP2DContext``). ``"tp"``: ``mode="fused"``
    runs the fused pipeline (:func:`tp_moe.fwd_fused`; at tp > 1 over
    ``ctxs.ag``'s mesh), the other modes :func:`tp_moe.fwd`. The row tile
    is the fused context's (``ctxs.ag.block_m`` at tp > 1, as JAX's engine
    sets it; ``ctxs.block_m`` at one rank). h: (t, d) at one rank; at tp =
    n the residual the trunk holds, token-sharded (n, t/n, d), or
    replicated (n, t, d) in ``"fused_ar"``, where :func:`tp_moe.fwd_ar`
    gives the values of JAX's ``fwd`` on its n gathered copies."""
    if moe_impl == "ep":
        fwd = ep_moe.fwd_2d if isinstance(ep_ctx, EP2DContext) else ep_moe.fwd
        return fwd(moe, h, ep_ctx, topk=cfg.num_experts_per_tok,
                   norm_topk_prob=cfg.norm_topk_prob, block_m=ctxs.block_m)
    kw = dict(topk=cfg.num_experts_per_tok, num_experts=cfg.num_experts,
              norm_topk_prob=cfg.norm_topk_prob)
    ranks = h.dim() == 3
    if mode == "fused":
        if not ranks:
            return tp_moe.fwd_fused(moe, h, block_m=ctxs.block_m, **kw)
        return tp_moe.fwd_fused(moe, h, mesh_ctx=ctxs.ag.mesh,
                                axis=ctxs.ag.axis, block_m=ctxs.ag.block_m,
                                **kw)
    if ranks and mode == "fused_ar":
        return tp_moe.fwd_ar(moe, h, **kw)
    return tp_moe.fwd(moe, h, **kw)


def _moe_block(layer: MoEDecoderLayer, h: torch.Tensor, cfg: ModelConfig, *,
               mode: str, ctxs: dense.FwdContexts, moe_impl: str = "tp",
               ep_ctx=None) -> torch.Tensor:
    """The dense trunk's ``ffn_fn`` hook form of :func:`moe_ffn`."""
    return moe_ffn(layer.moe, h, cfg, mode=mode, ctxs=ctxs,
                   moe_impl=moe_impl, ep_ctx=ep_ctx)


def prefill(params: MoELM, input_ids: torch.Tensor, cfg: ModelConfig, *,
            mode: str = "xla", ctxs: dense.FwdContexts = dense.FwdContexts(),
            max_len: Optional[int] = None, mesh=None, axis="tp",
            moe_impl: str = "tp", ep_ctx=None):
    """:func:`~triton_dist_tpu_torch.models.dense.prefill` with the MoE
    block: ``(last-position logits (B, vocab), KVCache)``; ``mesh`` with
    tp > 1 along ``axis`` (one axis or an ``(outer, inner)`` pair): n
    simulated ranks, fused ops from ``ctxs``; ``moe_impl`` / ``ep_ctx``:
    the experts' regime (:func:`moe_ffn`)."""
    ffn = functools.partial(_moe_block, cfg=cfg, mode=mode, ctxs=ctxs,
                            moe_impl=moe_impl, ep_ctx=ep_ctx)
    return dense.prefill(params, input_ids, cfg, mode=mode,
                         max_len=max_len, ffn_fn=ffn, mesh=mesh, ctxs=ctxs,
                         axis=axis)


def forward_tokens(params: MoELM, input_ids: torch.Tensor, cfg: ModelConfig,
                   *, mode: str = "xla",
                   ctxs: dense.FwdContexts = dense.FwdContexts(),
                   mesh=None, axis="tp", moe_impl: str = "tp",
                   ep_ctx=None) -> torch.Tensor:
    """Logits of every position (B, S, vocab), the MoE block in the
    trunk; ``mesh``/``ctxs``/``axis``/``moe_impl``/``ep_ctx`` as in
    :func:`prefill`."""
    ffn = functools.partial(_moe_block, cfg=cfg, mode=mode, ctxs=ctxs,
                            moe_impl=moe_impl, ep_ctx=ep_ctx)
    return dense.forward_tokens(params, input_ids, cfg, mode=mode,
                                ffn_fn=ffn, mesh=mesh, ctxs=ctxs, axis=axis)


def decode_step(params: MoELM, token_ids: torch.Tensor, cache,
                cfg: ModelConfig, *, mode: str = "xla", mesh=None,
                ctxs: Optional[dense.FwdContexts] = None, axis="tp",
                moe_impl: str = "tp", ep_ctx=None,
                transport: Optional[str] = None):
    """:func:`~triton_dist_tpu_torch.models.dense.decode_step` with the
    small-batch MoE FFN (:func:`moe_ffn_decode`, on the replicated residual
    at tp > 1; the layer index keys the ``"ll"``/``"ll2d"`` parities);
    ``axis`` as in :func:`prefill`."""
    ffn = functools.partial(_moe_ffn_decode, cfg=cfg, moe_impl=moe_impl,
                            ep_ctx=ep_ctx, transport=transport,
                            _layer_cursor=[0])
    return dense.decode_step(params, token_ids, cache, cfg, mode=mode,
                             ffn_fn=ffn, mesh=mesh, ctxs=ctxs, axis=axis)


def moe_ffn_decode(moe: ep_moe.MoE, h: torch.Tensor, cfg: ModelConfig, *,
                   moe_impl: str = "tp", ep_ctx=None,
                   transport: Optional[str] = None,
                   layer: int = 0) -> torch.Tensor:
    """Small-batch MoE FFN (decode rows, or a prefill chunk's rows): the
    tensor-parallel experts through :func:`tp_moe.fwd_ar` (h (b, d), or
    replicated (n, b, d) over n ranks); the expert-parallel ones through
    :func:`ep_moe.fwd_decode` over ``ep_ctx`` with ``transport`` (None is
    ``"ar"``, as in JAX) at layer ``layer``."""
    if moe_impl == "ep":
        return ep_moe.fwd_decode(moe, h, topk=cfg.num_experts_per_tok,
                                 norm_topk_prob=cfg.norm_topk_prob,
                                 transport=transport or "ar", ep_ctx=ep_ctx,
                                 layer=layer)
    return tp_moe.fwd_ar(moe, h, topk=cfg.num_experts_per_tok,
                         num_experts=cfg.num_experts,
                         norm_topk_prob=cfg.norm_topk_prob)


def _moe_ffn_decode(layer: MoEDecoderLayer, h: torch.Tensor,
                    cfg: ModelConfig, *, moe_impl: str = "tp", ep_ctx=None,
                    transport: Optional[str] = None,
                    _layer_cursor=None) -> torch.Tensor:
    """The dense trunk's ``ffn_fn`` hook form (receives the layer).
    ``_layer_cursor`` (a one-element list) counts the trunk's in-order
    calls: the layer index, as JAX's hook keeps it."""
    li = 0
    if _layer_cursor is not None:
        li = _layer_cursor[0]
        _layer_cursor[0] += 1
    return moe_ffn_decode(layer.moe, h, cfg, moe_impl=moe_impl,
                          ep_ctx=ep_ctx, transport=transport, layer=li)


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
