"""SwiGLU MLP of one decoder layer (counterpart of
``triton_dist_tpu/layers/tp_mlp.py``). Weights are stored
``(out_features, in_features)`` like
:mod:`~triton_dist_tpu_torch.layers.tp_attn`.

:func:`fwd` is one rank (no reduce). :func:`fwd_tp` is tp = n simulated
ranks in JAX's four modes: ``w_gate``/``w_up`` column-parallel,
``w_down`` row-parallel; ``"xla"``/``"fused"`` take and return the
token-sharded residual ``(n, T/n, d)``, ``"xla_ar"``/``"fused_ar"`` the
replicated one ``(n, T, d)``. ``"fused"`` runs one
:func:`~triton_dist_tpu_torch.ops.ag_gemm.ag_gemm` for the gate, whose
gathered A also feeds the up product, then
:func:`~triton_dist_tpu_torch.ops.gemm_rs.gemm_rs`; ``"fused_ar"`` ends
in :func:`~triton_dist_tpu_torch.ops.gemm_ar.gemm_ar`; the ``"xla*"``
modes sum the ranks' fp32 partials in plain PyTorch. The ranks are those
of the contexts' axis: over an ``(outer, inner)`` tuple n = n_o·n_in, the
shards are the flat tp = n ones, and the fused ops take their
hierarchical forms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from triton_dist_tpu_torch.layers.tp_attn import (empty_param,
                                                  reduce_scatter_plain)
from triton_dist_tpu_torch.ops.ag_gemm import ag_gemm
from triton_dist_tpu_torch.ops.gemm_ar import gemm_ar, gemm_ar_ref
from triton_dist_tpu_torch.ops.gemm_rs import gemm_rs
from triton_dist_tpu_torch.ops.tp_gemm import column_shards, row_shards

TP_MODES = ("xla", "xla_ar", "fused", "fused_ar")


class MLP(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=torch.bfloat16):
        super().__init__()
        d, ff = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.w_gate = empty_param((ff, d), **kw)
        self.w_up = empty_param((ff, d), **kw)
        self.w_down = empty_param((d, ff), **kw)


def init(cfg, *, generator: torch.Generator, device=None,
         dtype=torch.bfloat16) -> MLP:
    """Random weights with the JAX package's scales, from ``generator``."""
    p = MLP(cfg, device=device, dtype=dtype)
    d, ff = cfg.hidden_size, cfg.intermediate_size
    with torch.no_grad():
        for w, scale in ((p.w_gate, d ** -0.5), (p.w_up, d ** -0.5),
                         (p.w_down, ff ** -0.5)):
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=device, dtype=dtype))
            w.mul_(scale)
    return p


def _swiglu(x, w_gate, w_up):
    """silu(x·gate) · (x·up) in fp32, cast back to ``x.dtype``. In bf16
    the two products round to bf16 first (the JAX package keeps them
    fp32); in fp32 the two agree."""
    g = F.linear(x, w_gate).float()
    u = F.linear(x, w_up).float()
    return (F.silu(g) * u).to(x.dtype)


def fwd(params: MLP, x: torch.Tensor) -> torch.Tensor:
    """x: (tokens, d) → (tokens, d): SwiGLU then the down projection."""
    return F.linear(_swiglu(x, params.w_gate, params.w_up), params.w_down)


def _swiglu_ranks(x, w_gate, w_up):
    """:func:`_swiglu` of every rank: x (T, d) shared or (n, T, d);
    weights (n, ff/n, d) → (n, T, ff/n)."""
    g = torch.matmul(x, w_gate.transpose(1, 2)).float()
    u = torch.matmul(x, w_up.transpose(1, 2)).float()
    return (F.silu(g) * u).to(x.dtype)


def fwd_tp(params: MLP, x: torch.Tensor, *, mode: str,
           ctxs) -> torch.Tensor:
    """The MLP at tp = n (``x.shape[0]``) in ``mode`` (one of
    :data:`TP_MODES`); x and the result in the mode's residual layout."""
    n = x.shape[0]
    wg, wu = column_shards(params.w_gate, n), column_shards(params.w_up, n)
    wd = row_shards(params.w_down, n)
    if mode == "xla":
        h = _swiglu_ranks(x.reshape(-1, x.shape[-1]), wg, wu)
        return reduce_scatter_plain(h, wd, x.dtype)
    if mode == "xla_ar":
        return gemm_ar_ref(_swiglu_ranks(x, wg, wu), wd)
    if mode == "fused":
        # One all-gather feeds both column products.
        g, x_full = ag_gemm(x, wg, ctxs.ag, return_ag=True)
        u = torch.matmul(x_full, wu.transpose(1, 2))
        h = (F.silu(g.float()) * u.float()).to(x.dtype)
        return gemm_rs(h, wd, ctxs.rs)
    if mode == "fused_ar":
        return gemm_ar(_swiglu_ranks(x, wg, wu), wd, ctxs.ar)
    raise ValueError(f"unknown TP_MLP mode {mode!r} (one of {TP_MODES})")
