"""Tensor-parallel MoE layer (counterpart of ``param_specs``,
``_expert_mlp``, ``fwd``, ``fwd_ar`` and ``fwd_fused`` in
``triton_dist_tpu/layers/tp_moe.py``): every expert replicated, the ffn
dimension sharded.

One rank (x (t, d)): the ffn slice is the whole ffn dimension, so the
all-gathers, reduce-scatters and all-reduces are the identity: ``fwd``
(prefill) and ``fwd_ar`` (decode) compute the same grouped SwiGLU and fp32
combine. ``fwd_fused`` runs the fused pipeline in its static expert-major
layout, whose gate/up and down projections are the row-tile grouped GEMM
(PERF.md row 17's CUDA kernel on the card).

n simulated ranks (:mod:`~triton_dist_tpu_torch.parallel.mesh`; x carries
the rank as its leading dimension): rank r holds rows ``[r·F, (r+1)·F)`` of
every expert's ``w_gate``/``w_up`` and columns ``[r·F, (r+1)·F)`` of its
``w_down`` (F = f/n), strided views of the one weight
(:func:`param_specs`). ``fwd`` takes the token-sharded residual (n, t/n,
d): the all-gather of x, every rank's grouped SwiGLU on its shard, then the
fp32 combine and reduce-scatter, plain (JAX's XLA collectives) or, with
``mesh_ctx``, through :func:`~triton_dist_tpu_torch.ops.moe_reduce.
moe_reduce_rs`. ``fwd_ar`` takes the replicated residual (n, b, d): the
same SwiGLU on every rank's shard, the combine, then a sum over ranks.
``fwd_fused`` takes the token-sharded residual: route, each rank's sorted
layout, the gathered routing metadata (plain, JAX's XLA gathers of a few
KB), the fused all-gather + gate/up grouped GEMM
(:func:`~triton_dist_tpu_torch.ops.ag_moe.ag_group_gemm`, row 19),
SwiGLU, the down projection in the sorted layout (row 17, every rank in
one launch, skipping each chunk's padded tail by row 19's used-tile
counts), the un-sort, then the ``"rs"`` (row 21) or ``"ar"`` (row 20)
epilogue.

The plain per-rank SwiGLU reads the segment sizes on the host once per
call (:func:`~triton_dist_tpu_torch.ops.group_gemm.grouped_swiglu`), as at
one rank: every rank's products of one expert segment run together
(gate/up over the whole ffn dimension, whose column blocks are the ranks'
shards; down as one batched product over the ranks).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.layers.ep_moe import MoE, route
from triton_dist_tpu_torch.ops.ag_moe import (
    ag_group_gemm, create_ag_moe_context, prepare_grouped_tokens,
    suggested_block_m, tiles_used)
from triton_dist_tpu_torch.ops.group_gemm import (
    grouped_gemm_tiles, grouped_swiglu, sort_by_expert)
from triton_dist_tpu_torch.ops.moe_reduce import moe_reduce_ar, moe_reduce_rs


def param_specs(params: MoE, n: int) -> Dict[str, torch.Tensor]:
    """The ranks' shards as JAX's ``param_specs`` cut them, as views of
    the one weight (no copy): ``router`` replicated (E, d); ``w_gate``,
    ``w_up`` (n, E, F, d), rank r's rows ``[r·F, (r+1)·F)`` of every
    expert; ``w_down`` (n, E, d, F), rank r's columns."""
    e, f, d = params.w_gate.shape
    if f % n:
        raise ValueError(f"moe_intermediate_size={f} not divisible by "
                         f"tp={n}")
    fl = f // n

    def rows(w):
        return w.view(e, n, fl, d).transpose(0, 1)

    return {"router": params.router, "w_gate": rows(params.w_gate),
            "w_up": rows(params.w_up),
            "w_down": params.w_down.view(e, d, n, fl).permute(2, 0, 1, 3)}


def _expert_mlp(params: MoE, x: torch.Tensor, *, topk: int,
                num_experts: int, norm_topk_prob: bool, n: int = 0):
    """Route, replicate each row per selected expert, sort by expert, run
    the grouped SwiGLU, un-sort. Returns ``(out, topk_w (t, k))``: out (t,
    k, d) at one rank (``n`` 0), or every rank's partial (n, t, k, d) over
    its ffn shard."""
    t, d = x.shape
    topk_ids, topk_w = route(params.router, x, topk,
                             norm_topk_prob=norm_topk_prob)
    k = topk_ids.shape[1]
    tok_rep = torch.repeat_interleave(x, k, dim=0)
    sorted_tok, group_sizes, inv = sort_by_expert(
        tok_rep, topk_ids.reshape(-1), num_experts)
    out = grouped_swiglu(sorted_tok, params.w_gate, params.w_up,
                         params.w_down, group_sizes, max(n, 1))[:, inv]
    return (out.reshape(n, t, k, d) if n else out[0].reshape(t, k, d),
            topk_w)


def _partials(params: MoE, x_full: torch.Tensor, n: int, **kw):
    """Every rank's fp32 combine over its ffn shard: (n, t, d)."""
    out, topk_w = _expert_mlp(params, x_full, n=n, **kw)
    return torch.einsum("ntkd,tk->ntd", out.float(), topk_w.float())


def fwd(params: MoE, x: torch.Tensor, *, topk: int, num_experts: int,
        norm_topk_prob: bool = True, mesh_ctx=None) -> torch.Tensor:
    """Prefill-path MoE. One rank: (t, d) tokens → the routed experts'
    outputs, weighted by their combine weights and summed in fp32, in
    ``x.dtype``. Ranks: the token-sharded (n, t/n, d) → the same layout:
    every rank's partial of the gathered tokens, reduce-scattered (a sum
    over ranks in rank order; with ``mesh_ctx``, JAX's fused
    :func:`~triton_dist_tpu_torch.ops.moe_reduce.moe_reduce_rs`)."""
    kw = dict(topk=topk, num_experts=num_experts,
              norm_topk_prob=norm_topk_prob)
    if x.dim() == 2:
        out, topk_w = _expert_mlp(params, x, **kw)
        return moe_reduce_rs(out, topk_w)
    n, t_loc, d = x.shape
    x_full = x.reshape(n * t_loc, d)
    if mesh_ctx is not None:
        out, topk_w = _expert_mlp(params, x_full, n=n, **kw)
        return moe_reduce_rs(out, topk_w.contiguous().expand(
            n, *topk_w.shape), ctx=mesh_ctx)
    return _partials(params, x_full, n, **kw).sum(0).view(
        n, t_loc, d).to(x.dtype)


def fwd_ar(params: MoE, x: torch.Tensor, *, topk: int, num_experts: int,
           norm_topk_prob: bool = True) -> torch.Tensor:
    """Decode-path MoE. One rank: a (b, d) batch, :func:`fwd`'s combine
    (JAX's psum over one rank). Ranks: the replicated (n, b, d) batch →
    the same on every rank: every rank routes the same rows (rank 0's
    copy), computes its ffn shard's partial, and the partials are summed
    over ranks (JAX's psum)."""
    kw = dict(topk=topk, num_experts=num_experts,
              norm_topk_prob=norm_topk_prob)
    if x.dim() == 2:
        out, topk_w = _expert_mlp(params, x, **kw)
        return moe_reduce_ar(out, topk_w)
    n = x.shape[0]
    out = _partials(params, x[0], n, **kw).sum(0).to(x.dtype)
    return out.expand(n, *out.shape)


def fwd_fused(params: MoE, x: torch.Tensor, *, topk: int, num_experts: int,
              mesh_ctx=None, axis: str = "tp", block_m: int = 64,
              norm_topk_prob: bool = True,
              epilogue: str = "rs") -> torch.Tensor:
    """The fused tensor-parallel MoE forward: route, sort the
    top-k-replicated tokens expert-major in ``block_m``-aligned segments
    (capped by :func:`~triton_dist_tpu_torch.ops.ag_moe.suggested_block_m`
    so padding stays below the real rows), the gate and up projections as
    ONE grouped GEMM over the two weights, SwiGLU in fp32, the down
    projection as a second grouped GEMM in the sorted layout, the un-sort
    to (token, k) order (padding rows dropped), and the ``epilogue``
    combine (``"rs"`` or ``"ar"``). No host read anywhere.

    One rank: x (t, d) → (t, d) in ``x.dtype`` (both epilogues the same).
    Ranks (``mesh_ctx``'s ``axis`` of size n): x (n, t_loc, d) token-sharded
    → (n, t_loc, d) token-sharded for ``"rs"``, the whole replicated (n,
    n·t_loc, d) for ``"ar"``; the gate/up GEMM gathers the sorted tokens
    (row 19), the epilogue reduces over ranks (rows 21 / 20). JAX's
    ``block_n``/``block_k`` tile the TPU kernels' VMEM panels and have no
    counterpart."""
    if epilogue not in ("rs", "ar"):
        raise ValueError(f"unknown epilogue {epilogue!r} "
                         "(expected 'rs' or 'ar')")
    if x.dim() == 2:
        return _fused_one_rank(params, x, topk=topk, num_experts=num_experts,
                               block_m=block_m, norm_topk_prob=norm_topk_prob,
                               epilogue=epilogue)
    n, t_loc, d = x.shape
    if mesh_ctx is None or mesh_ctx.size(axis) != n:
        raise ValueError(f"x {tuple(x.shape)}: the ranks form needs a mesh "
                         f"whose {axis!r} axis has size {n}")
    topk_ids, topk_w = route(params.router, x.reshape(n * t_loc, d), topk,
                             norm_topk_prob=norm_topk_prob)
    block_m = suggested_block_m(t_loc, topk, num_experts, block_m)
    ids = topk_ids.view(n, t_loc, topk)
    x_s, te, row_src = (torch.stack(v) for v in zip(*(
        prepare_grouped_tokens(x[r], ids[r], num_experts, block_m)
        for r in range(n))))
    shards = param_specs(params, n)
    f_loc = shards["w_gate"].shape[2]
    ctx = create_ag_moe_context(mesh_ctx, num_experts=num_experts, axis=axis,
                                block_m=block_m)
    # The stacked maps are every rank's te_all; one gather serves the
    # gate/up GEMM's tiles ((n, tiles)) and the down projection's (flat).
    # The per-chunk used-tile counts let both skip each chunk's padded tail.
    used = tiles_used(row_src, block_m)
    h = ag_group_gemm(x_s, (shards["w_gate"], shards["w_up"]), te, ctx,
                      te_all=te, used=used)
    act = (F.silu(h[..., :f_loc].float()) * h[..., f_loc:].float()).to(
        x.dtype)                                       # (n, S_full, F)
    y_sorted = grouped_gemm_tiles(act, shards["w_down"], te.reshape(-1),
                                  used=used)
    y = _unsort(y_sorted, row_src, t_loc, topk)     # (n, n·t_loc, K, d)
    w_full = topk_w.contiguous().expand(n, *topk_w.shape)   # gathered, fp32
    if epilogue == "ar":
        return moe_reduce_ar(y, w_full, ctx=mesh_ctx, axis=axis)
    return moe_reduce_rs(y, w_full, ctx=mesh_ctx, axis=axis)


def _fused_one_rank(params: MoE, x: torch.Tensor, *, topk: int,
                    num_experts: int, block_m: int, norm_topk_prob: bool,
                    epilogue: str) -> torch.Tensor:
    """:func:`fwd_fused` at one rank."""
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
    y = _unsort(y_sorted[None], row_src[None], t, topk)[0]
    reduce = moe_reduce_ar if epilogue == "ar" else moe_reduce_rs
    return reduce(y, topk_w)


def _unsort(y_sorted: torch.Tensor, row_src: torch.Tensor, tokens: int,
            topk: int) -> torch.Tensor:
    """Every rank's sorted rows (n, n·S_loc, d), chunk c laid out by rank
    c's ``row_src`` (n, S_loc) over its ``tokens`` tokens, back to (token,
    k) order: (n, n·tokens, topk, d). Padding rows (``row_src`` -1) land
    in a spare row past the end, which is dropped."""
    n, s_loc = row_src.shape
    d = y_sorted.shape[-1]
    tk = tokens * topk
    base = (torch.arange(n, device=row_src.device) * tk).repeat_interleave(
        s_loc)
    src = row_src.reshape(-1).long()
    dst = torch.where(src >= 0, src + base, n * tk)
    y = y_sorted.new_zeros((n, n * tk + 1, d)).index_copy_(1, dst, y_sorted)
    return y[:, :n * tk].view(n, n * tokens, topk, d)
