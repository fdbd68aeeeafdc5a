"""Ulysses sequence-parallel attention layer (counterpart of
``triton_dist_tpu/layers/ulysses_sp.py``: ``init``, ``param_specs`` and
``fwd``).

Layer form: the QKV projection of each rank's sequence slice, the
head-resharding all-to-all, attention over the whole sequence, the inverse
all-to-all, the O projection. The ranks are the leading dimension
(:mod:`~triton_dist_tpu_torch.parallel.mesh`): x (n, S_loc, d), rank r
holding global positions ``[r·S_loc, (r+1)·S_loc)``. The weights are
``tp_attn``'s, unsharded (:class:`~triton_dist_tpu_torch.layers.tp_attn.
Attention`; :func:`~triton_dist_tpu_torch.models.convert.from_jax_params`
carries JAX's tree over): Ulysses shards the sequence, not the weights.

``impl``:

- ``"xla"`` / ``"pallas"``: the projections as plain products, q/k norm
  and rope at global positions, then :func:`~triton_dist_tpu_torch.ops.
  ulysses.pre_attn_a2a` / ``post_attn_a2a`` through
  :func:`~triton_dist_tpu_torch.ops.all_to_all.all_to_all_ref` (``"xla"``)
  or row 18 (``"pallas"``: four launches a layer), and one
  :func:`~triton_dist_tpu_torch.layers.tp_attn.sdpa` over every rank's
  heads (the flash-attention kernel on a CUDA tensor when causal).
- ``"fused"``: :func:`~triton_dist_tpu_torch.ops.ulysses_fused.
  ulysses_attn_fused`, rows 29 and 30 around the same attention, with q/k
  norm and rope applied to the exchanged full-sequence heads through its
  ``qk_transform`` (elementwise per (position, head), so the order swap
  with the transport is exact). The owner-grouped QKV weight is made once
  per parameter set (:func:`grouped_weights`), not per call, as JAX's note
  asks of serving code; the O weight's grouping is a view.
"""

from __future__ import annotations

import weakref
from typing import Dict

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.layers import tp_attn
from triton_dist_tpu_torch.ops.ulysses import post_attn_a2a, pre_attn_a2a
from triton_dist_tpu_torch.ops.ulysses_fused import (
    create_ulysses_fused_context, group_o_rows, group_qkv_columns,
    ulysses_attn_fused)
from triton_dist_tpu_torch.parallel.mesh import MeshContext

IMPLS = ("xla", "pallas", "fused")


def init(cfg, *, generator: torch.Generator, device=None,
         dtype=torch.bfloat16) -> tp_attn.Attention:
    """``tp_attn``'s weights. The forward applies no projection biases and
    assumes the q/k norm, so bias-carrying or norm-free (Seed-OSS-class)
    configs are rejected rather than mis-served, as in JAX."""
    if (getattr(cfg, "attention_bias", False)
            or not getattr(cfg, "qk_norm", True)
            or getattr(cfg, "attn_gate", False)):
        raise NotImplementedError(
            "ulysses_sp covers the Qwen3 layer shape (no attention "
            "biases or output gate, per-head q/k norm)")
    return tp_attn.init(cfg, generator=generator, device=device, dtype=dtype)


def param_specs(params: tp_attn.Attention, n: int) -> Dict[str, torch.Tensor]:
    """Rank r's view of each weight (JAX's replicated ``P(None, ...)``
    specs): the whole weight, as an (n, ...) view of stride 0 along the
    ranks, never a copy."""
    return {name: getattr(params, name).expand(n, *getattr(params, name).shape)
            for name in ("wq", "wk", "wv", "wo", "q_norm", "k_norm")}


_GROUPED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def grouped_weights(params: tp_attn.Attention, cfg, n: int):
    """The fused path's weights for n ranks: the owner-grouped QKV weight
    (n, cols_loc, d), made once per parameter set and kept while ``params``
    lives (remade if a weight is written in place), and the O weight's
    owner view (n, d, rows_loc)."""
    h, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    ws = (params.wq, params.wk, params.wv)
    stamp = (n,) + tuple((w.data_ptr(), w._version) for w in ws)
    try:
        hit = _GROUPED.get(params)
    except TypeError:           # not weak-referenceable: no cache
        hit = None
    if hit is None or hit[0] != stamp:
        w_qkv = group_qkv_columns(torch.cat(ws), n=n, num_heads=h,
                                  num_kv_heads=kvh, head_dim=hd)
        hit = (stamp, w_qkv)
        try:
            _GROUPED[params] = hit
        except TypeError:
            pass
    return hit[1], group_o_rows(params.wo, n=n, num_heads=h, head_dim=hd)


def fwd(params: tp_attn.Attention, x: torch.Tensor, cfg, *,
        axis: str = "sp", ctx: MeshContext = None, impl: str = "pallas",
        causal: bool = True) -> torch.Tensor:
    """x: (n, S_loc, d) sequence-sharded along ``axis`` → the same layout
    out. ``ctx`` (the mesh) is needed by ``"pallas"`` and ``"fused"``;
    without it the exchange is the plain one."""
    if impl not in IMPLS:
        raise ValueError(f"unknown ulysses_sp impl {impl!r} (one of {IMPLS})")
    if impl == "fused":
        return _fwd_fused(params, x, cfg, axis=axis, ctx=ctx, causal=causal)
    n, s_loc = x.shape[:2]
    hd = cfg.head_dim
    h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads

    q = F.linear(x, params.wq).view(n, s_loc, h, hd)
    k = F.linear(x, params.wk).view(n, s_loc, kvh, hd)
    v = F.linear(x, params.wv).view(n, s_loc, kvh, hd)

    # q/k norm + rope at *global* positions (each rank's sequence slice).
    positions = (torch.arange(n, device=x.device)[:, None] * s_loc
                 + torch.arange(s_loc, device=x.device))
    q, k = tp_attn._norm_rope(q, k, params, cfg, positions)

    # Head-reshard, attend over the whole sequence, reshard back.
    qh = pre_attn_a2a(q, axis=axis, ctx=ctx, impl=impl)
    kh = pre_attn_a2a(k, axis=axis, ctx=ctx, impl=impl)
    vh = pre_attn_a2a(v.contiguous(), axis=axis, ctx=ctx, impl=impl)
    o = tp_attn.sdpa(qh, kh, vh, causal=causal)
    o = post_attn_a2a(o, axis=axis, ctx=ctx, impl=impl)
    return F.linear(o.reshape(n, s_loc, h * hd), params.wo).to(x.dtype)


def _fwd_fused(params, x, cfg, *, axis: str, ctx: MeshContext,
               causal: bool) -> torch.Tensor:
    if ctx is None:
        raise ValueError("ulysses_sp impl='fused' needs the mesh (ctx=)")
    n = ctx.size(axis)
    hd = cfg.head_dim
    h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    s = n * x.shape[1]
    fctx = create_ulysses_fused_context(ctx, axis=axis)
    w_qkv, w_o = grouped_weights(params, cfg, n)

    def norm_rope(q, k):
        positions = torch.arange(s, device=x.device).expand(n, s)
        return tp_attn._norm_rope(q, k, params, cfg, positions)

    return ulysses_attn_fused(
        x, w_qkv, w_o, fctx, num_heads=h, num_kv_heads=kvh, head_dim=hd,
        causal=causal, qk_transform=norm_rope).to(x.dtype)
