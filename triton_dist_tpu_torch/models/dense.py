"""Dense Qwen3-style LLM on one card (counterpart of
``triton_dist_tpu/models/dense.py``: ``init_params``,
``make_fwd_contexts``, the dense-cache ``prefill``/``forward_tokens``/
``decode_step`` and the paged ``prefill_chunk_paged``/
``decode_step_paged``/``verify_step_paged``).

The weights are an ``nn.Module`` tree (:class:`DenseLM`) whose names
follow the JAX pytree's keys; the model functions take it as ``params``.
Without a mesh (or at tp = 1) the three forward modes compute the same
function (:mod:`~triton_dist_tpu_torch.layers.tp_attn`). With
``mesh=make_mesh(tp=n)`` the dense-cache functions run n simulated
tensor-parallel ranks on the one device, and with ``make_mesh(dp=n_o,
tp=n_in)`` and ``axis=("dp", "tp")`` n = n_o·n_in ranks sharded over both
axes (JAX's hierarchical forms; rank r = o·n_in + i holds the shard of the
flat tp = n engine's rank r): rank r's weight shards are
views of the one full weight, as the JAX ``param_specs`` cut them
(``lm_head`` by vocabulary rows), and its fused ops take the contexts of
:func:`make_fwd_contexts`. The prefill's residual is token-sharded in
``"xla"``/``"fused"`` (B·S divisible by n) and replicated in
``"fused_ar"``; decode runs replicated, ``"fused_ar"`` unless the mode is
``"xla"``. The KV cache keeps the global ``(layers, B, max_len, KV, hd)``
layout: rank r owns KV heads ``[r·KV/n, (r+1)·KV/n)``, the JAX cache's
global view. The paged decode and chunk steps take the same mesh (one
axis; JAX's ``decode_step_paged``/``prefill_chunk_paged`` in their
``shard_map``): the residual is replicated, every rank projects its heads,
the pools hold every rank's KV heads in rank order (the one pool is each
rank's shard side by side), so one paged-attention launch covers every
rank, and the row-parallel products run ``"fused_ar"`` (GEMM+AR) unless
the mode is ``"xla"``; the logits are the ranks' vocabulary shards,
concatenated. The speculative verify step is one rank only (ROADMAP.md
queue A item 8). The prefill attends through the flash-attention
kernel wrapper, the paged steps through the paged kernel wrappers; each
launches its CUDA kernel on a CUDA tensor and runs its plain version on a
CPU tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from triton_dist_tpu_torch.layers import tp_attn, tp_mlp
from triton_dist_tpu_torch.layers.norm import rms_norm
from triton_dist_tpu_torch.layers.tp_attn import empty_param
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.kv_cache import KVCache
from triton_dist_tpu_torch.ops.ag_gemm import create_ag_gemm_context
from triton_dist_tpu_torch.ops.gemm_ar import create_gemm_ar_context
from triton_dist_tpu_torch.ops.gemm_rs import create_gemm_rs_context
from triton_dist_tpu_torch.ops.tp_gemm import column_shards
from triton_dist_tpu_torch.ops.paged_flash_decode import paged_flash_decode
from triton_dist_tpu_torch.ops.paged_flash_qblock import paged_flash_qblock


class DecoderLayer(nn.Module):
    def __init__(self, attn: tp_attn.Attention, mlp: tp_mlp.MLP, cfg, *,
                 device=None, dtype=torch.bfloat16):
        super().__init__()
        self.attn = attn
        self.mlp = mlp
        self.ln_attn = empty_param((cfg.hidden_size,), device=device, dtype=dtype)
        self.ln_mlp = empty_param((cfg.hidden_size,), device=device, dtype=dtype)


class DenseLM(nn.Module):
    """Embedding, decoder layers, final norm and lm_head. ``embed`` and
    ``lm_head`` are (vocab, d); the layers' linear weights are
    (out_features, in_features)."""

    def __init__(self, cfg: ModelConfig, layers, *, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        shape = (cfg.vocab_size, cfg.hidden_size)
        self.embed = empty_param(shape, device=device, dtype=dtype)
        self.layers = nn.ModuleList(layers)
        self.ln_f = empty_param((cfg.hidden_size,), device=device, dtype=dtype)
        self.lm_head = (self.embed if cfg.tie_word_embeddings
                        else empty_param(shape, device=device, dtype=dtype))

    @classmethod
    def empty(cls, cfg: ModelConfig, *, device=None,
              dtype=torch.bfloat16) -> "DenseLM":
        """Uninitialised weights of ``cfg``'s shapes."""
        kw = dict(device=device, dtype=dtype)
        return cls(cfg, [DecoderLayer(tp_attn.Attention(cfg, **kw),
                                      tp_mlp.MLP(cfg, **kw), cfg, **kw)
                         for _ in range(cfg.num_hidden_layers)], **kw)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None, dtype=torch.bfloat16) -> DenseLM:
    """Random weights with the JAX package's scales (norms at one,
    embeddings ``N(0, 0.02²)``), drawn from ``generator`` on ``device``.
    The same seed gives other numbers than JAX's ``init_params``; carry
    JAX weights across with :func:`~triton_dist_tpu_torch.models.convert.
    from_jax_params`."""
    kw = dict(device=device, dtype=dtype)
    layers = []
    for _ in range(cfg.num_hidden_layers):
        layer = DecoderLayer(
            tp_attn.init(cfg, generator=generator, **kw),
            tp_mlp.init(cfg, generator=generator, **kw), cfg, **kw)
        with torch.no_grad():
            layer.ln_attn.fill_(1.0)
            layer.ln_mlp.fill_(1.0)
        layers.append(layer)
    model = DenseLM(cfg, layers, **kw)
    with torch.no_grad():
        heads = (model.embed,) if cfg.tie_word_embeddings else (
            model.embed, model.lm_head)
        for w in heads:
            w.copy_(torch.randn(w.shape, generator=generator, **kw))
            w.mul_(0.02)
        model.ln_f.fill_(1.0)
    return model


@dataclasses.dataclass(frozen=True)
class FwdContexts:
    """The JAX per-layer fused-op contexts: ``ag``/``rs``/``ar`` of the
    tensor-parallel dense path (:func:`make_fwd_contexts`), and
    ``block_m``, the MoE row tile of the fused expert layout (capped per
    call by ``ops.ag_moe.suggested_block_m``, read by the one-rank MoE
    prefill)."""
    ag: object = None
    rs: object = None
    ar: object = None
    block_m: int = 256


def make_fwd_contexts(mesh, axis="tp", block_m: int = 256,
                      block_n: int = 256, block_k: int = 512) -> FwdContexts:
    """The three fused-op contexts of ``mesh`` over ``axis`` (one axis or
    an ``(outer, inner)`` tuple) with JAX's block knobs and JAX's default
    variants (GEMM+AR ``"ll"``)."""
    return FwdContexts(
        ag=create_ag_gemm_context(mesh, axis, block_m, block_n, block_k),
        rs=create_gemm_rs_context(mesh, axis, block_m, block_n, block_k),
        ar=create_gemm_ar_context(mesh, axis, block_n, block_k),
        block_m=block_m)


def _tp_size(mesh, axis) -> int:
    return 1 if mesh is None else mesh.size(axis)


def lm_head_logits(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """fp32 logits (tokens, vocab): bf16 products accumulate and stay in
    fp32 (on the card one ``mm`` with ``out_dtype``; elsewhere in fp32)."""
    if x.is_cuda and x.dtype != torch.float32:
        return torch.mm(x, lm_head.t(), out_dtype=torch.float32)
    return F.linear(x.float(), lm_head.float())


def _layer_tail(layer, x, o, cfg, ffn_fn=None):
    """o-projection + residual, then the FFN block + residual: the dense
    MLP, or ``ffn_fn(layer, h)`` (the MoE model's hook)."""
    x = x + tp_attn.decode_output(layer.attn, o.reshape(x.shape[0], -1))
    h = rms_norm(x, layer.ln_mlp, cfg.rms_norm_eps)
    if ffn_fn is None:
        return x + tp_mlp.fwd(layer.mlp, h)
    return x + ffn_fn(layer, h)


def _layer_tail_tp(layer, x, o, cfg, *, n: int, mode: str, ctxs,
                   ffn_fn=None):
    """:func:`_layer_tail` at tp = n on the replicated (n, rows, d)
    residual, in JAX's decode regime: the row-parallel products through
    GEMM+AR (``"fused_ar"``) unless ``mode`` is ``"xla"`` (plain sums);
    ``ffn_fn`` sees the replicated residual."""
    dec_mode = "xla" if mode == "xla" else "fused_ar"
    x = x + tp_attn.decode_output_tp(layer.attn, o.reshape(o.shape[0], -1),
                                     n=n, mode=dec_mode, ar_ctx=ctxs.ar)
    h = rms_norm(x, layer.ln_mlp, cfg.rms_norm_eps)
    if ffn_fn is not None:
        return x + ffn_fn(layer, h)
    return x + tp_mlp.fwd_tp(layer.mlp, h, ctxs=ctxs,
                             mode="xla_ar" if dec_mode == "xla"
                             else "fused_ar")


def _embed_tokens(params: DenseLM, input_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) ids → (B·S, d) embeddings (one rank embeds every token)."""
    return params.embed[input_ids.reshape(-1).long()]


def _layer_fwd_prefill(layer, x, cfg, *, batch: int, mode: str,
                       ffn_fn=None):
    """One layer of the prefill trunk; ``ffn_fn(layer, h)`` replaces the
    dense MLP (the MoE model's hook)."""
    h = rms_norm(x, layer.ln_attn, cfg.rms_norm_eps)
    attn_out, kv = tp_attn.fwd_prefill(layer.attn, h, cfg, batch=batch,
                                       mode=mode)
    x = x + attn_out
    h = rms_norm(x, layer.ln_mlp, cfg.rms_norm_eps)
    x = x + (tp_mlp.fwd(layer.mlp, h) if ffn_fn is None
             else ffn_fn(layer, h))
    return x, kv


def _forward_trunk(params: DenseLM, input_ids: torch.Tensor,
                   cfg: ModelConfig, *, mode: str,
                   cache: Optional[KVCache], ffn_fn=None):
    """Embed → layers (recording K/V into ``cache`` when given) → final
    norm. Returns ``(x (B·S, d), cache)``."""
    b = input_ids.shape[0]
    x = _embed_tokens(params, input_ids)
    for li, layer in enumerate(params.layers):
        x, kv = _layer_fwd_prefill(layer, x, cfg, batch=b, mode=mode,
                                   ffn_fn=ffn_fn)
        if cache is not None:
            cache.write_prefill(li, *kv)
    return rms_norm(x, params.ln_f, cfg.rms_norm_eps), cache


def _lm_head(params: DenseLM, x: torch.Tensor) -> torch.Tensor:
    return lm_head_logits(x, params.lm_head)


# ---- tp = n simulated ranks ------------------------------------------------

def _embed_tokens_tp(params: DenseLM, input_ids: torch.Tensor, *, mode: str,
                     n: int) -> torch.Tensor:
    """Slice before gather: in the token-sharded modes rank r embeds only
    tokens ``[r·T/n, (r+1)·T/n)`` → (n, T/n, d); in ``"fused_ar"`` every
    rank embeds every token → (n, T, d)."""
    flat = input_ids.reshape(-1).long()
    if mode in ("xla", "fused"):
        if flat.shape[0] % n:
            # A TypeError, as the JAX package's reshape raises for it.
            raise TypeError(
                f"cannot shard B*S={flat.shape[0]} tokens over tp={n}: mode "
                f"{mode!r} shards the residual stream over tokens (B*S must "
                f"be divisible by tp)")
        return params.embed[flat.view(n, -1)]
    x = params.embed[flat]
    return x.expand(n, *x.shape).contiguous()


def _forward_trunk_tp(params: DenseLM, input_ids: torch.Tensor,
                      cfg: ModelConfig, *, mode: str, n: int, ctxs,
                      cache: Optional[KVCache], ffn_fn=None):
    """Embed → layers → final norm at tp = n, then the final all-gather
    of the token-sharded modes. ``ffn_fn(layer, h)`` replaces the MLP (the
    MoE model's hook) and sees what the MLP sees: the token-sharded (n,
    B·S/n, d) in ``"xla"``/``"fused"``, the replicated (n, B·S, d) in
    ``"fused_ar"``. Returns ``(x, cache)``: x (B·S, d) after the gather,
    or (n, B·S, d) replicated for ``"fused_ar"``."""
    b = input_ids.shape[0]
    x = _embed_tokens_tp(params, input_ids, mode=mode, n=n)
    eps = cfg.rms_norm_eps
    for li, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln_attn, eps)
        attn_out, kv = tp_attn.fwd_prefill_tp(layer.attn, h, cfg, batch=b,
                                              mode=mode, ctxs=ctxs)
        x = x + attn_out
        h = rms_norm(x, layer.ln_mlp, eps)
        x = x + (tp_mlp.fwd_tp(layer.mlp, h, mode=mode, ctxs=ctxs)
                 if ffn_fn is None else ffn_fn(layer, h))
        if cache is not None:
            cache.write_prefill(li, *kv)
    x = rms_norm(x, params.ln_f, eps)
    if mode in ("xla", "fused"):
        x = x.reshape(-1, x.shape[-1])       # chunks in rank order
    return x, cache


def _lm_head_tp(params: DenseLM, x: torch.Tensor, n: int) -> torch.Tensor:
    """Vocabulary-sharded head: rank r's logits of vocabulary rows
    ``[r·V/n, (r+1)·V/n)`` from its copy of x ((n, M, d), or (M, d) that
    every rank holds), gathered along the vocabulary → (M, V) fp32."""
    heads = column_shards(params.lm_head, n)
    return torch.cat([lm_head_logits(x if x.dim() == 2 else x[r], heads[r])
                      for r in range(n)], dim=-1)


def prefill(params: DenseLM, input_ids: torch.Tensor, cfg: ModelConfig, *,
            mode: str = "xla", max_len: Optional[int] = None, ffn_fn=None,
            mesh=None, ctxs: Optional[FwdContexts] = None, axis="tp"):
    """Prefill of (B, S) token ids. Returns ``(logits (B, vocab) fp32 of
    the last position, KVCache)``, the cache ``max_len`` (default S)
    positions long with the prompt written and ``length = S``. ``mesh``
    with n > 1 ranks along ``axis`` (one axis or an ``(outer, inner)``
    tuple): n simulated ranks, fused ops from ``ctxs``."""
    n = _tp_size(mesh, axis)
    b, s = input_ids.shape
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    cache = KVCache.empty(cfg.num_hidden_layers, b, max_len,
                          cfg.num_key_value_heads, cfg.head_dim,
                          device=params.embed.device,
                          dtype=params.embed.dtype)
    if n > 1:
        tp_attn.check_mode(mode)
        x, cache = _forward_trunk_tp(params, input_ids, cfg, mode=mode, n=n,
                                     ctxs=ctxs, cache=cache, ffn_fn=ffn_fn)
        cache.length = s
        last = (x.view(b, s, -1)[:, -1] if x.dim() == 2
                else x.view(n, b, s, -1)[:, :, -1])
        return _lm_head_tp(params, last, n), cache
    x, cache = _forward_trunk(params, input_ids, cfg, mode=mode,
                              cache=cache, ffn_fn=ffn_fn)
    cache.length = s
    last = x.view(b, s, -1)[:, -1]
    return _lm_head(params, last), cache


def forward_tokens(params: DenseLM, input_ids: torch.Tensor,
                   cfg: ModelConfig, *, mode: str = "xla", ffn_fn=None,
                   mesh=None, ctxs: Optional[FwdContexts] = None,
                   axis="tp"):
    """Logits of every position, (B, S, vocab) fp32 (the training-loss
    forward); ``mesh``/``ctxs``/``axis`` as in :func:`prefill`."""
    n = _tp_size(mesh, axis)
    b, s = input_ids.shape
    if n > 1:
        tp_attn.check_mode(mode)
        x, _ = _forward_trunk_tp(params, input_ids, cfg, mode=mode, n=n,
                                 ctxs=ctxs, cache=None, ffn_fn=ffn_fn)
        return _lm_head_tp(params, x, n).view(b, s, cfg.vocab_size)
    x, _ = _forward_trunk(params, input_ids, cfg, mode=mode, cache=None,
                          ffn_fn=ffn_fn)
    return _lm_head(params, x).view(b, s, cfg.vocab_size)


def decode_step(params: DenseLM, token_ids: torch.Tensor, cache: KVCache,
                cfg: ModelConfig, *, mode: str = "xla", ffn_fn=None,
                mesh=None, ctxs: Optional[FwdContexts] = None, axis="tp"):
    """One decode step over a dense :class:`KVCache`. token_ids: (B,).
    Per layer: :func:`tp_attn.decode_project` at position
    ``cache.length``, :meth:`KVCache.append_decode` (in place), plain
    attention over the first ``length + 1`` positions, o-projection, FFN
    (``ffn_fn``, the MoE hook, or the MLP). Returns ``(logits (B, vocab)
    fp32, cache)`` with ``length`` advanced by one. ``mesh`` with tp > 1:
    n simulated ranks on a replicated residual, the row-parallel products
    through ``gemm_ar`` unless ``mode`` is ``"xla"`` (JAX's decode
    regime); ``axis`` as in :func:`prefill`."""
    tp_attn.check_mode(mode)
    n = _tp_size(mesh, axis)
    if n > 1:
        return _decode_step_tp(params, token_ids, cache, cfg, mode=mode,
                               n=n, ctxs=ctxs, ffn_fn=ffn_fn)
    b = token_ids.shape[0]
    dev = token_ids.device
    x = params.embed[token_ids.long()]
    pos = cache.length
    positions = torch.full((b,), pos, dtype=torch.int32, device=dev)
    for li, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln_attn, cfg.rms_norm_eps)
        q, k_tok, v_tok = tp_attn.decode_project(layer.attn, h, cfg,
                                                 positions)
        cache.append_decode(li, k_tok, v_tok)
        # The written prefix only: JAX masks the positions past it
        # (kv_len = length + 1), which adds exact zeros.
        o = tp_attn.sdpa(q, cache.k[li, :, :pos + 1],
                         cache.v[li, :, :pos + 1], causal=False)
        x = _layer_tail(layer, x, o, cfg, ffn_fn)
    x = rms_norm(x, params.ln_f, cfg.rms_norm_eps)
    return _lm_head(params, x), cache.advance()


def _decode_step_tp(params: DenseLM, token_ids: torch.Tensor,
                    cache: KVCache, cfg: ModelConfig, *, mode: str, n: int,
                    ctxs, ffn_fn=None) -> tuple:
    """:func:`decode_step` at tp = n: the residual (n, B, d) replicated on
    every rank, attention over the stacked heads of the global cache;
    ``ffn_fn(layer, h)`` (the MoE hook) sees that replicated residual."""
    b = token_ids.shape[0]
    x = params.embed[token_ids.long()]
    x = x.expand(n, *x.shape).contiguous()
    pos = cache.length
    positions = torch.full((b,), pos, dtype=torch.int32,
                           device=token_ids.device)
    eps = cfg.rms_norm_eps
    for li, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln_attn, eps)
        q, k_tok, v_tok = tp_attn.decode_project_tp(layer.attn, h, cfg,
                                                    positions)
        cache.append_decode(li, k_tok, v_tok)
        o = tp_attn.sdpa(q, cache.k[li, :, :pos + 1],
                         cache.v[li, :, :pos + 1], causal=False)
        x = _layer_tail_tp(layer, x, o, cfg, n=n, mode=mode, ctxs=ctxs,
                           ffn_fn=ffn_fn)
    x = rms_norm(x, params.ln_f, eps)
    return _lm_head_tp(params, x, n), cache.advance()


def _paged_setup(params: DenseLM, token_ids: torch.Tensor, *, mesh, axis,
                 mode: str, ffn_fn):
    """The paged steps' tp and first residual: (rows, d), or (n, rows, d)
    replicated at tp = n > 1 (a dense model over one mesh axis)."""
    n = _tp_size(mesh, axis)
    x = params.embed[token_ids.long()]
    if n > 1:
        tp_attn.check_mode(mode)
        if isinstance(axis, (tuple, list)) or ffn_fn is not None:
            raise NotImplementedError(
                "the paged steps at tp > 1 run a dense model over one mesh "
                "axis; MoE and an (outer, inner) axis are ROADMAP.md queue "
                "A item 8")
        x = x.expand(n, *x.shape).contiguous()
    return n, x


def _paged_project(layer, x, cfg, positions, n):
    """QKV of the paged steps: every rank's heads in rank order."""
    if n == 1:
        return tp_attn.decode_project(layer.attn, x, cfg, positions)
    return tp_attn.decode_project_tp(layer.attn, x, cfg, positions)


def prefill_chunk_paged(params: DenseLM, chunk_toks: torch.Tensor, cache,
                        table_row: torch.Tensor, cfg: ModelConfig, *,
                        start: int, wfrom: int, valid: int,
                        ffn_fn=None, mode: str = "xla", mesh=None,
                        ctxs: Optional[FwdContexts] = None,
                        axis="tp") -> torch.Tensor:
    """One fixed-shape chunk of a bucketed paged prefill.

    chunk_toks: (C,) int32, padded past ``valid``; ``table_row``:
    (p_max,) int32 — the slot's block-table row; ``start``: global
    position of the chunk's first token; ``wfrom``: positions below it
    are prefix-resident (computed, never rewritten); ``valid``: real
    tokens in the chunk.

    Per layer: project the chunk through the decode contract
    (:func:`tp_attn.decode_project` at per-row positions), write its K/V
    into the slot's pages IN PLACE (:meth:`PagedKVCache.write_chunk`),
    then attend the chunk's queries over the slot's pages through
    :func:`~triton_dist_tpu_torch.ops.paged_flash_qblock.paged_flash_qblock`
    with the global causal mask. Padding rows clamp to the last valid
    position, so they do not stretch the kernel's key walk.
    ``ffn_fn(layer, h) -> h`` replaces the dense MLP block (the MoE
    model's hook, as in the JAX trunk). ``mesh`` with tp = n > 1 over one
    ``axis``: n simulated ranks on a replicated residual (module
    docstring), the fused ops from ``ctxs``.

    Returns the fp32 logits (vocab,) of the LAST VALID token."""
    c = chunk_toks.shape[0]
    dev = chunk_toks.device
    n, x = _paged_setup(params, chunk_toks, mesh=mesh, axis=axis, mode=mode,
                        ffn_fn=ffn_fn)
    positions = start + torch.arange(c, dtype=torch.int32, device=dev)
    last = max(valid - 1, 0)
    qpos = torch.where(torch.arange(c, device=dev) < valid, positions,
                       torch.full_like(positions, start + last))
    for li, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln_attn, cfg.rms_norm_eps)
        q, k_tok, v_tok = _paged_project(layer, h, cfg, positions, n)
        cache.write_chunk(li, k_tok, v_tok, table_row, positions, valid,
                          wfrom)
        ksc, vsc = cache.layer_scales(li)
        o = paged_flash_qblock(q[:, 0][None], cache.k_pages[li],
                               cache.v_pages[li], table_row[None],
                               qpos[None], k_scale=ksc, v_scale=vsc)[0]
        x = (_layer_tail(layer, x, o, cfg, ffn_fn) if n == 1 else
             _layer_tail_tp(layer, x, o, cfg, n=n, mode=mode, ctxs=ctxs))
    x = rms_norm(x[..., last:last + 1, :], params.ln_f, cfg.rms_norm_eps)
    if n > 1:
        return _lm_head_tp(params, x, n)[0]
    return lm_head_logits(x, params.lm_head)[0]


def decode_step_paged(params: DenseLM, token_ids: torch.Tensor, cache,
                      cfg: ModelConfig, *, ffn_fn=None, mode: str = "xla",
                      mesh=None, ctxs: Optional[FwdContexts] = None,
                      axis="tp") -> torch.Tensor:
    """One continuous-batching decode step over a
    :class:`~triton_dist_tpu_torch.serving.blocks.PagedKVCache`.

    token_ids: (S,) int32, one per batch slot; every slot ropes and
    attends at its own length. Parked slots (live 0) still flow through
    the math, but their appends land in the scratch page, their lengths
    do not advance and their logits are garbage the scheduler ignores.
    The cache is updated IN PLACE (appends and :meth:`advance`).
    ``ffn_fn``, ``mode``, ``mesh``, ``ctxs`` and ``axis`` as in
    :func:`prefill_chunk_paged`. Returns fp32 logits (S, vocab)."""
    n, x = _paged_setup(params, token_ids, mesh=mesh, axis=axis, mode=mode,
                        ffn_fn=ffn_fn)
    lens = cache.lens
    # Live slots attend including the token appended this step; parked
    # slots clamp to one position.
    kv_len = torch.clamp(lens + cache.live, min=1)
    for li, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln_attn, cfg.rms_norm_eps)
        q, k_tok, v_tok = _paged_project(layer, h, cfg, lens, n)
        cache.append_decode(li, k_tok, v_tok)
        ksc, vsc = cache.layer_scales(li)
        o = paged_flash_decode(q[:, 0], cache.k_pages[li],
                               cache.v_pages[li], cache.block_table, kv_len,
                               k_scale=ksc, v_scale=vsc)
        x = (_layer_tail(layer, x, o, cfg, ffn_fn) if n == 1 else
             _layer_tail_tp(layer, x, o, cfg, n=n, mode=mode, ctxs=ctxs))
    x = rms_norm(x, params.ln_f, cfg.rms_norm_eps)
    logits = (_lm_head_tp(params, x, n) if n > 1
              else lm_head_logits(x, params.lm_head))
    cache.advance()
    return logits


def verify_step_paged(params: DenseLM, token_ids: torch.Tensor, cache,
                      cfg: ModelConfig, *, budget=None,
                      ffn_fn=None) -> torch.Tensor:
    """One speculative-verify step over a
    :class:`~triton_dist_tpu_torch.serving.blocks.PagedKVCache`: K
    candidate tokens per slot in one fixed-shape dispatch.

    token_ids: (S, K) int32 — slot s's candidates are fed at positions
    ``lens[s] .. lens[s] + K - 1``; ``budget`` (S,) int32 caps how many
    candidates of a slot write real pages (the rest go to the scratch
    page). Per layer: project the S·K rows at their positions, write
    every candidate's K/V IN PLACE (:meth:`PagedKVCache.append_block`),
    then attend each candidate through
    :func:`~triton_dist_tpu_torch.ops.paged_flash_qblock.paged_flash_qblock`
    under its own causal bound ``lens[s] + j`` (a parked slot's rows at
    position 0), so candidate j sees what a sequential decode of the
    accepted prefix would see. ``ffn_fn`` as in
    :func:`prefill_chunk_paged`.

    Returns fp32 logits (S, K, vocab): ``[s, j]`` is the next-token
    distribution after feeding candidates 0..j. The lengths are NOT
    advanced: the host commits the accepted prefix by advancing its
    length mirrors (rejected candidates stay masked garbage)."""
    s, k = token_ids.shape
    dev = token_ids.device
    x = params.embed[token_ids.reshape(-1).long()]        # (S·K, d)
    lens = cache.lens
    j = torch.arange(k, dtype=torch.int32, device=dev)
    positions = (lens[:, None] + j[None]).reshape(-1)
    qpos = (torch.clamp(lens[:, None] + cache.live[:, None] * (j[None] + 1),
                        min=1) - 1).to(torch.int32)
    if budget is not None:
        budget = torch.as_tensor(budget, dtype=torch.int32, device=dev)
    for li, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln_attn, cfg.rms_norm_eps)
        q, k_tok, v_tok = tp_attn.decode_project(layer.attn, h, cfg,
                                                 positions)
        hl, hd = q.shape[2], q.shape[3]
        cache.append_block(li, k_tok[:, 0].reshape(s, k, -1, hd),
                           v_tok[:, 0].reshape(s, k, -1, hd), budget=budget)
        ksc, vsc = cache.layer_scales(li)
        o = paged_flash_qblock(q[:, 0].reshape(s, k, hl, hd),
                               cache.k_pages[li], cache.v_pages[li],
                               cache.block_table, qpos, k_scale=ksc,
                               v_scale=vsc)
        x = _layer_tail(layer, x, o, cfg, ffn_fn)
    x = rms_norm(x, params.ln_f, cfg.rms_norm_eps)
    return lm_head_logits(x, params.lm_head).view(s, k, -1)
