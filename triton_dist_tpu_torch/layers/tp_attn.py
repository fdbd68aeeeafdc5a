"""Attention of one decoder layer (counterpart of
``triton_dist_tpu/layers/tp_attn.py``: ``init``, ``sdpa``, ``_head_split``,
``_project_qkv``, ``fwd_prefill``, ``decode_project``, ``decode_output``,
``fwd_decode`` and the q/k norm + rope of ``_norm_rope``).

One rank (no mesh, or tp = 1): every projection is one ``F.linear`` with
no cross-shard collective, and the modes ``"xla"``, ``"fused"`` and
``"fused_ar"`` compute the same function (JAX's one-rank
``ag_gemm``/``gemm_rs``/``gemm_ar`` are plain products).

tp = n simulated ranks (:mod:`~triton_dist_tpu_torch.parallel.mesh`,
the ``*_tp`` functions): heads are sharded contiguously by rank, as the
JAX ``param_specs`` shard ``wq``/``wk``/``wv`` by columns and ``wo`` by
rows; activations carry the rank as their leading dimension. The residual
stream is token-sharded ``(n, T/n, d)`` in ``"xla"``/``"fused"`` and
replicated ``(n, T, d)`` in ``"fused_ar"`` and decode. ``"fused"``
projects Q through :func:`~triton_dist_tpu_torch.ops.ag_gemm.ag_gemm`
(its gathered A feeds K and V) and O through
:func:`~triton_dist_tpu_torch.ops.gemm_rs.gemm_rs`; ``"fused_ar"`` and
every decode step's O go through
:func:`~triton_dist_tpu_torch.ops.gemm_ar.gemm_ar`; ``"xla"`` sums the
ranks' fp32 partials in plain PyTorch (JAX's XLA collectives). The
ranks are those of the contexts' axis: over an ``(outer, inner)`` tuple
n = n_o·n_in (the head split takes that product, rank r = o·n_in + i
holding the flat tp = n engine's heads of rank r), and the fused ops take
their hierarchical forms. Rank r's
heads are heads ``[r·H/n, (r+1)·H/n)`` of the whole model and its KV heads
``[r·KV/n, (r+1)·KV/n)``, so attention over every rank's heads, stacked in
rank order, is the tp = 1 attention: one flash-attention launch covers
all ranks.

A causal prefill attends through
:func:`~triton_dist_tpu_torch.ops.flash_attention.flash_attention` (a
CUDA kernel on the card at every shape). Linear weights are stored
``(out_features, in_features)``, the layout ``F.linear`` takes; the JAX
package stores their transpose and multiplies ``x @ w``
(:func:`triton_dist_tpu_torch.models.convert.from_jax_params` carries
weights across).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from triton_dist_tpu_torch.layers.norm import rms_norm
from triton_dist_tpu_torch.layers.rope import apply_rope, rope_freqs
from triton_dist_tpu_torch.ops.ag_gemm import ag_gemm
from triton_dist_tpu_torch.ops.flash_attention import flash_attention
from triton_dist_tpu_torch.ops.gemm_ar import gemm_ar, gemm_ar_ref
from triton_dist_tpu_torch.ops.gemm_rs import gemm_rs
from triton_dist_tpu_torch.ops.tp_gemm import (column_shards, mm_f32,
                                               row_shards)

MODES = ("xla", "fused", "fused_ar")


def empty_param(shape, *, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Attention(nn.Module):
    """Qwen3 GQA attention weights: q/k/v/o projections and the
    per-head q/k RMS norms."""

    def __init__(self, cfg, *, device=None, dtype=torch.bfloat16):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
        if h % kvh:
            raise ValueError(f"num_attention_heads={h} is not a multiple "
                             f"of num_key_value_heads={kvh}")
        kw = dict(device=device, dtype=dtype)
        self.wq = empty_param((h * hd, d), **kw)
        self.wk = empty_param((kvh * hd, d), **kw)
        self.wv = empty_param((kvh * hd, d), **kw)
        self.wo = empty_param((d, h * hd), **kw)
        self.q_norm = empty_param((hd,), **kw)
        self.k_norm = empty_param((hd,), **kw)
        # Rope's inverse frequencies, made once instead of every call.
        self.register_buffer("inv_freq",
                             rope_freqs(hd, cfg.rope_theta, device=device),
                             persistent=False)


def init(cfg, *, generator: torch.Generator, device=None,
         dtype=torch.bfloat16) -> Attention:
    """Random weights with the JAX package's scales (``N(0, 1)·d^-½``
    for q/k/v, ``·(H·hd)^-½`` for o, unit norms), drawn from
    ``generator``; the numbers differ from JAX's for the same seed."""
    p = Attention(cfg, device=device, dtype=dtype)
    d = cfg.hidden_size
    with torch.no_grad():
        for w, scale in ((p.wq, d ** -0.5), (p.wk, d ** -0.5),
                         (p.wv, d ** -0.5),
                         (p.wo, p.wo.shape[1] ** -0.5)):
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=device, dtype=dtype))
            w.mul_(scale)
        p.q_norm.fill_(1.0)
        p.k_norm.fill_(1.0)
    return p


def _norm_rope(q, k, params: Attention, cfg, positions):
    """q: (B, S, H, hd); k: (B, S, KV, hd); positions (B, S)."""
    q = rms_norm(q, params.q_norm, cfg.rms_norm_eps)
    k = rms_norm(k, params.k_norm, cfg.rms_norm_eps)
    return (apply_rope(q, positions, params.inv_freq),
            apply_rope(k, positions, params.inv_freq))


def decode_project(params: Attention, x: torch.Tensor, cfg,
                   positions: torch.Tensor):
    """Project one token per row: QKV + q/k norm + rope.

    x: (B, d); ``positions``: (B,) int — per-row cache positions (a
    decode batch ropes each slot at its own length; a prefill chunk
    passes ``start + arange(C)``). Returns (q (B, 1, H, hd),
    k (B, 1, KV, hd), v (B, 1, KV, hd))."""
    b = x.shape[0]
    hd = cfg.head_dim
    q = F.linear(x, params.wq).view(b, 1, -1, hd)
    k = F.linear(x, params.wk).view(b, 1, -1, hd)
    v = F.linear(x, params.wv).view(b, 1, -1, hd)
    q, k = _norm_rope(q, k, params, cfg, positions.view(b, 1))
    return q, k, v


def decode_output(params: Attention, o: torch.Tensor) -> torch.Tensor:
    """o-projection of the attention output o: (B, H·hd) → (B, d)."""
    return F.linear(o, params.wo)


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown TP_Attn mode {mode!r} (one of {MODES})")


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
         kv_len=None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd). GQA by head group.

    ``kv_len`` may be (B,), one length per batch row, or (B, Sq), one per
    query. A causal attention of a sequence over its own keys (a prefill:
    ``kv_len`` None, ``Sq == Skv``) goes through
    :func:`~triton_dist_tpu_torch.ops.flash_attention.flash_attention`,
    the CUDA kernel on a CUDA tensor at every such shape. The other forms
    (decode over the dense cache, a causal block over a cache prefix) are
    plain PyTorch, as JAX leaves them to XLA: fp32 scores, query heads
    grouped by their KV head (a reshape of q, no K/V repeat),
    probabilities cast to the value dtype before P·V. Returns (B, Sq, H,
    hd)."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if causal and kv_len is None and sq == skv:
        return flash_attention(q, k, v, causal=True, sm_scale=hd ** -0.5)
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    keep = None                                   # (B or 1, Sq or 1, Skv)
    ki = torch.arange(skv, device=q.device)
    if causal:
        qi = torch.arange(sq, device=q.device)
        keep = (ki[None, :] <= qi[:, None] + (skv - sq))[None]
    if kv_len is not None:
        lim = kv_len[:, None] if kv_len.dim() == 1 else kv_len
        in_len = ki[None, None, :] < lim[..., None]
        keep = in_len if keep is None else keep & in_len
    if keep is not None:
        scores = scores.masked_fill(~keep[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, hd)


def fwd_prefill(params: Attention, x: torch.Tensor, cfg, *, batch: int,
                mode: str = "xla"):
    """x: (tokens, d), ``batch`` sequences of ``tokens // batch``
    positions each. QKV, q/k norm and rope at positions ``0..S-1``,
    causal attention (:func:`sdpa`), o-projection. Returns ``(y (tokens,
    d), (k, v))`` with k/v (B, S, KV, hd), the prompt's cache rows."""
    check_mode(mode)
    tokens, hd = x.shape[0], cfg.head_dim
    seq = tokens // batch
    q = F.linear(x, params.wq).view(batch, seq, -1, hd)
    k = F.linear(x, params.wk).view(batch, seq, -1, hd)
    v = F.linear(x, params.wv).view(batch, seq, -1, hd)
    positions = torch.arange(seq, device=x.device).expand(batch, seq)
    q, k = _norm_rope(q, k, params, cfg, positions)
    o = sdpa(q, k, v, causal=True)
    return F.linear(o.reshape(tokens, -1), params.wo), (k, v)


def fwd_decode(params: Attention, x: torch.Tensor, cfg,
               k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len: int,
               *, mode: str = "xla"):
    """Single-token decode over one layer's dense cache. x: (B, d);
    caches (B, max_len, KV, hd), written IN PLACE at ``cache_len``.
    :func:`decode_project` → cache write → :func:`sdpa` over the first
    ``cache_len + 1`` positions → :func:`decode_output`. Returns ``(y (B,
    d), (k_cache, v_cache))``."""
    check_mode(mode)
    b = x.shape[0]
    positions = torch.full((b,), cache_len, dtype=torch.int32,
                           device=x.device)
    q, k, v = decode_project(params, x, cfg, positions)
    k_cache[:, cache_len] = k[:, 0].to(k_cache.dtype)
    v_cache[:, cache_len] = v[:, 0].to(v_cache.dtype)
    kv_len = torch.full((b,), cache_len + 1, dtype=torch.int32,
                        device=x.device)
    o = sdpa(q, k_cache, v_cache, causal=False, kv_len=kv_len)
    return decode_output(params, o.reshape(b, -1)), (k_cache, v_cache)


# ---- tp = n simulated ranks ------------------------------------------------

def _head_split(cfg, n: int):
    """Per-rank head counts; KV-head replication for n > KV heads is not
    implemented (as in the JAX package), so fail loudly rather than
    mis-reshape."""
    if cfg.num_attention_heads % n:
        raise ValueError(
            f"num_attention_heads={cfg.num_attention_heads} not divisible "
            f"by tp={n}")
    if cfg.num_key_value_heads % n:
        raise ValueError(
            f"num_key_value_heads={cfg.num_key_value_heads} not divisible "
            f"by tp={n} (KV-head replication unimplemented)")
    return cfg.num_attention_heads // n, cfg.num_key_value_heads // n


def _stack_heads(t: torch.Tensor, batch: int, seq: int,
                 hd: int) -> torch.Tensor:
    """(n, B·S, X_loc·hd), rank-major → (B, S, n·X_loc, hd): every rank's
    heads side by side in rank order (the whole model's head order)."""
    n = t.shape[0]
    return (t.view(n, batch, seq, -1, hd).permute(1, 2, 0, 3, 4)
            .reshape(batch, seq, -1, hd).contiguous())


def _rank_heads(o: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, H, hd) → (n, B·S, H/n·hd): rank r's heads of every token."""
    b, s, h, hd = o.shape
    return (o.reshape(b, s, n, (h // n) * hd).permute(2, 0, 1, 3)
            .reshape(n, b * s, -1).contiguous())


def reduce_scatter_plain(x: torch.Tensor, w: torch.Tensor,
                         dtype) -> torch.Tensor:
    """The ``"xla"`` row-parallel product: every rank's fp32 partial
    ``x[r] @ w[r].T``, summed over ranks (rank order), token chunk r to
    rank r, rounded to ``dtype``: (n, T, K_loc) → (n, T/n, N)."""
    n = x.shape[0]
    total = sum(mm_f32(x[r], w[r]) for r in range(n))
    return total.view(n, -1, total.shape[-1]).to(dtype)


def _project_qkv_tp(params: Attention, x: torch.Tensor, *, mode: str,
                    ag_ctx):
    """Every rank's Q, K and V, each (n, T, X_loc·hd). x: (n, T/n, d)
    token-sharded (``"xla"``, ``"fused"``) or (n, T, d) replicated
    (``"fused_ar"``)."""
    n = x.shape[0]
    wq, wk, wv = (column_shards(w, n) for w in (params.wq, params.wk,
                                                params.wv))
    if mode == "xla":
        x_full = x.reshape(-1, x.shape[-1])    # the all-gather, rank order
        q = torch.matmul(x_full, wq.transpose(1, 2))
    elif mode == "fused":
        q, x_full = ag_gemm(x, wq, ag_ctx, return_ag=True)
    else:
        x_full = x
        q = torch.matmul(x, wq.transpose(1, 2))
    k = torch.matmul(x_full, wk.transpose(1, 2))
    v = torch.matmul(x_full, wv.transpose(1, 2))
    return q, k, v


def fwd_prefill_tp(params: Attention, x: torch.Tensor, cfg, *, batch: int,
                   mode: str, ctxs):
    """The prefill attention block at tp = n (``x.shape[0]``): QKV
    (:func:`_project_qkv_tp`), q/k norm and rope at positions ``0..S-1``,
    causal attention over the stacked heads (one :func:`sdpa`), then the
    row-parallel O projection through ``mode``'s reduce. x: (n, T/n, d)
    or, for ``"fused_ar"``, (n, T, d). Returns ``(y in x's layout, (k, v))``
    with k/v (B, S, KV, hd), every rank's KV heads in rank order."""
    check_mode(mode)
    n, hd = x.shape[0], cfg.head_dim
    _head_split(cfg, n)
    q, k, v = _project_qkv_tp(params, x, mode=mode, ag_ctx=ctxs.ag)
    seq = q.shape[1] // batch
    q, k, v = (_stack_heads(t, batch, seq, hd) for t in (q, k, v))
    positions = torch.arange(seq, device=x.device).expand(batch, seq)
    q, k = _norm_rope(q, k, params, cfg, positions)
    o = _rank_heads(sdpa(q, k, v, causal=True), n)
    wo = row_shards(params.wo, n)
    if mode == "xla":
        y = reduce_scatter_plain(o, wo, x.dtype)
    elif mode == "fused":
        y = gemm_rs(o, wo, ctxs.rs)
    else:
        y = gemm_ar(o, wo, ctxs.ar)
    return y, (k, v)


def decode_project_tp(params: Attention, x: torch.Tensor, cfg,
                      positions: torch.Tensor):
    """:func:`decode_project` at tp = n: x (n, B, d) replicated; every
    rank projects its heads. Returns q (B, 1, H, hd), k/v (B, 1, KV, hd),
    the ranks' heads stacked in rank order."""
    n, b = x.shape[:2]
    hd = cfg.head_dim
    _head_split(cfg, n)
    q, k, v = (_stack_heads(torch.matmul(x, column_shards(w, n)
                                         .transpose(1, 2)), b, 1, hd)
               for w in (params.wq, params.wk, params.wv))
    q, k = _norm_rope(q, k, params, cfg, positions.view(b, 1))
    return q, k, v


def decode_output_tp(params: Attention, o: torch.Tensor, *, n: int,
                     mode: str, ar_ctx) -> torch.Tensor:
    """:func:`decode_output` at tp = n: o (B, H·hd), every rank's heads
    stacked → (n, B, d) on every rank, through
    :func:`~triton_dist_tpu_torch.ops.gemm_ar.gemm_ar` unless ``mode`` is
    ``"xla"``."""
    o = o.view(o.shape[0], n, -1).transpose(0, 1).contiguous()
    wo = row_shards(params.wo, n)
    if mode == "xla":
        return gemm_ar_ref(o, wo)
    return gemm_ar(o, wo, ar_ctx)
