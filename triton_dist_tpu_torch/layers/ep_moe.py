"""Expert-parallel MoE layer (counterpart of
``triton_dist_tpu/layers/ep_moe.py``: ``init``, ``param_specs``,
``route``, ``fwd``, ``fwd_2d``, ``fwd_fused``, ``fwd_decode`` with its
transports, ``resolve_transport`` and ``DECODE_TRANSPORTS``), and the MoE
weights and router the tensor-parallel regime (:mod:`~triton_dist_tpu_
torch.layers.tp_moe`) shares.

Over n simulated ranks (:mod:`~triton_dist_tpu_torch.parallel.mesh`; the
activations carry the rank as their leading dimension) rank r owns
experts ``[r·E/n, (r+1)·E/n)``: its shards are contiguous views of the one
weight at a rank stride of ``E/n`` experts (:func:`param_specs`), never a
copy; over an ``(outer, inner)`` mesh the ranks are outer-major, r =
o·n_in + i, as JAX's ``EP2DContext`` orders them. :func:`fwd` (prefill)
routes each rank's own rows, dispatches them to the experts' owners
(:func:`~triton_dist_tpu_torch.ops.ep_a2a.ep_dispatch`), runs every rank's
grouped SwiGLU over what it received (:func:`expert_swiglu`) and combines
back at the source (:func:`~triton_dist_tpu_torch.ops.ep_a2a.ep_combine`);
:func:`fwd_2d` does the same through the two-hop hierarchical dispatch
(:func:`~triton_dist_tpu_torch.ops.ep_a2a.ep_dispatch_2d`), and
:func:`fwd_fused` through the tile-fused kernels of
:mod:`~triton_dist_tpu_torch.ops.ep_fused` (rows 25 and 26: capacity per
(source, destination, expert), overflow dropped and counted).
:func:`fwd_decode` takes the replicated decode batch and one of JAX's
transports: ``"ar"`` (every rank's local experts over the whole batch,
then a sum over ranks), ``"ragged"`` (the exact-splits round trip),
``"ll"`` (the count-free fixed-slot exchange through the quantizing
all-to-all, row 23, at step parities ``2·layer`` and ``2·layer + 1``),
``"ll2d"`` (the same slots through the two-hop
:func:`~triton_dist_tpu_torch.ops.low_latency.ll_a2a_2d` over an
``EP2DContext``) or ``"auto"``.

JAX runs the experts' grouped SwiGLU as ``ragged_dot``; the port runs it
as row 17 (:func:`~triton_dist_tpu_torch.ops.group_gemm.
grouped_gemm_tiles`) in the row-tile layout of :func:`~triton_dist_tpu_
torch.ops.ag_moe.prepare_expert_rows`: one launch over every rank for
gate/up, one for down, each rank with its own tile map and count of used
tiles, no host read. Not ported yet: hot-expert replicas (the server sets
them, ROADMAP.md queue A item 8), ``tune_transport`` (the tune cache,
queue A item 4) and the shared expert (queue A item 6).

The JAX package stores ``router`` as ``(d, E)``, ``w_gate``/``w_up`` as
``(E, d, f)`` and ``w_down`` as ``(E, f, d)`` and multiplies ``x @ w``.
The port stores each as ``(out_features, in_features)``, the layout
``F.linear`` takes: ``router (E, d)``, ``w_gate``/``w_up (E, f, d)``,
``w_down (E, d, f)``
(:func:`~triton_dist_tpu_torch.models.convert.from_jax_params` transposes).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from triton_dist_tpu_torch.layers.tp_attn import empty_param
from triton_dist_tpu_torch.ops.ag_moe import (
    prepare_expert_rows, suggested_block_m, tiles_used)
from triton_dist_tpu_torch.ops.ep_a2a import (
    EP2DContext, EPContext, ep_combine, ep_combine_2d, ep_dispatch,
    ep_dispatch_2d)
from triton_dist_tpu_torch.ops.ep_fused import EPFusedContext, ep_moe_fused
from triton_dist_tpu_torch.ops.group_gemm import grouped_gemm_tiles
from triton_dist_tpu_torch.ops.low_latency import ll_a2a, ll_a2a_2d

DECODE_TRANSPORTS = ("ar", "ragged", "ll", "ll2d", "auto")
# The largest row tile of the decode transports' expert layout (a decode
# batch routes a few rows to each expert; suggested_block_m shrinks it).
DECODE_BLOCK_M = 64


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


def param_specs(params: MoE, n: int) -> Dict[str, torch.Tensor]:
    """The ranks' expert shards as JAX's ``param_specs`` cut them (experts
    sharded over the axis), as views of the one weight: ``router``
    replicated (E, d); ``w_gate``, ``w_up`` (n, E/n, f, d), ``w_down``
    (n, E/n, d, f), rank r's experts ``[r·E/n, (r+1)·E/n)``."""
    e = params.w_gate.shape[0]
    if e % n:
        raise ValueError(f"num_experts={e} not divisible by ep={n}")

    def shards(w):
        return w.view(n, e // n, *w.shape[1:])

    return {"router": params.router, "w_gate": shards(params.w_gate),
            "w_up": shards(params.w_up), "w_down": shards(params.w_down)}


def expert_swiglu(shards: Dict[str, torch.Tensor], rows: torch.Tensor,
                  expert_ids: torch.Tensor, *, block_m: int) -> torch.Tensor:
    """Every rank's grouped SwiGLU over the rows it received: rows (n, R,
    d), expert_ids (n, R) local expert or -1 (an empty row) → (n, R, d),
    zero on empty rows (JAX's ``sort_by_expert`` + ``grouped_swiglu`` +
    unsort). The rows are laid out expert-major in ``block_m`` tiles
    (:func:`~triton_dist_tpu_torch.ops.ag_moe.prepare_expert_rows`), then
    gate/up is one row 17 launch over both weights and every rank, SwiGLU
    in fp32 rounded to the rows' dtype, and down a second launch; each
    skips its rank's tiles past the last real row."""
    n, r_rows, d = rows.shape
    wg, wu, wd = shards["w_gate"], shards["w_up"], shards["w_down"]
    f = wg.shape[2]
    x_s, te, src = prepare_expert_rows(rows, expert_ids, wg.shape[1], block_m)
    used = tiles_used(src, block_m)[:, None]                 # (n, 1)
    h = grouped_gemm_tiles(x_s, (wg, wu), te, used=used)     # (n, S, 2f)
    act = (F.silu(h[..., :f].float()) * h[..., f:].float()).to(rows.dtype)
    y = grouped_gemm_tiles(act, wd, te, used=used)          # (n, S, d)
    base = torch.arange(n, device=rows.device)[:, None] * r_rows
    dst = torch.where(src >= 0, base + src, n * r_rows).reshape(-1)
    return rows.new_zeros((n * r_rows + 1, d)).index_copy_(
        0, dst, y.reshape(-1, d))[:-1].view(n, r_rows, d)


def _ranks(x: torch.Tensor, ctx):
    """(t, d) at one rank → (1, t, d); checks the rank count against the
    context's axis (both axes of an ``EP2DContext``)."""
    x = x[None] if x.dim() == 2 else x
    if ctx is None:
        return x
    axis = ((ctx.outer_axis, ctx.inner_axis) if isinstance(ctx, EP2DContext)
            else ctx.axis)
    if ctx.mesh.size(axis) != x.shape[0]:
        raise ValueError(f"x {tuple(x.shape)}: the EP context's {axis!r} "
                         f"axis has {ctx.mesh.size(axis)} ranks")
    return x


def _fwd_dispatched(params: MoE, x: torch.Tensor, ctx, dispatch, combine,
                    *, topk: int, norm_topk_prob: bool,
                    block_m: int) -> torch.Tensor:
    """Route every rank's own rows, ``dispatch`` them to the experts'
    owners, run every rank's :func:`expert_swiglu` over what it received
    (row tile ``block_m``, capped by ``suggested_block_m`` for the t·K rows
    a rank sends) and ``combine`` back at the source with the top-k
    weights in fp32."""
    xr = _ranks(x, ctx)
    n, t, d = xr.shape
    ids, w = route(params.router, xr.reshape(n * t, d), topk,
                   norm_topk_prob=norm_topk_prob)
    ids, w = ids.view(n, t, topk), w.view(n, t, topk)
    recv_tok, recv_exp, state = dispatch(xr, ids, ctx)
    y = expert_swiglu(param_specs(params, n), recv_tok, recv_exp,
                      block_m=suggested_block_m(t * topk, 1,
                                                ctx.experts_per_rank,
                                                block_m))
    out = combine(y, state, w, ctx)
    return out[0] if x.dim() == 2 else out


def fwd(params: MoE, x: torch.Tensor, ep_ctx: EPContext, *, topk: int,
        norm_topk_prob: bool = True, block_m: int = 256) -> torch.Tensor:
    """Prefill-path EP MoE: x (n, t, d), every rank's own rows (at one rank
    (t, d)) → the same shape, through :func:`ep_dispatch` and
    :func:`ep_combine`."""
    return _fwd_dispatched(params, x, ep_ctx, ep_dispatch, ep_combine,
                           topk=topk, norm_topk_prob=norm_topk_prob,
                           block_m=block_m)


def fwd_2d(params: MoE, x: torch.Tensor, ep2d_ctx: EP2DContext, *,
           topk: int, norm_topk_prob: bool = True,
           block_m: int = 256) -> torch.Tensor:
    """Hierarchical EP forward: :func:`fwd` with the dispatch and combine
    riding the two-hop schedule (:func:`~triton_dist_tpu_torch.ops.ep_a2a.
    ep_dispatch_2d`: inner hop first, one aggregated outer exchange). x
    (R, t, d), every rank's own rows → the same shape."""
    return _fwd_dispatched(params, x, ep2d_ctx, ep_dispatch_2d,
                           ep_combine_2d, topk=topk,
                           norm_topk_prob=norm_topk_prob, block_m=block_m)


def fwd_fused(params: MoE, x: torch.Tensor, ep_ctx: EPFusedContext, *,
              topk: int, norm_topk_prob: bool = True):
    """Mega-EP forward: the dispatch fused into the up-projection grouped
    GEMM and the down projection fused into the combine
    (:func:`~triton_dist_tpu_torch.ops.ep_fused.ep_moe_fused`, rows 25 and
    26 on a CUDA tensor). x (n, t, d), every rank's own rows (at one rank
    (t, d)). Returns ``(out of x's shape, num_dropped (n,) int32)``, the
    assignments past the context's capacity per rank."""
    xr = x[None] if x.dim() == 2 else x
    n, t, d = xr.shape
    ids, w = route(params.router, xr.reshape(n * t, d), topk,
                   norm_topk_prob=norm_topk_prob)
    sh = param_specs(params, n)
    out, dropped = ep_moe_fused(xr, ids.view(n, t, topk), w.view(n, t, topk),
                                sh["w_gate"], sh["w_up"], sh["w_down"],
                                ep_ctx)
    return (out[0], dropped[0]) if x.dim() == 2 else (out, dropped)


def resolve_transport(transport: str, *, ctx, batch: int, hidden: int,
                      dtype, topk: int) -> str:
    """JAX's host-side resolution of the decode ``transport`` knob:
    explicit values pass through; ``"auto"`` is ``"ll2d"`` on a
    hierarchical :class:`EP2DContext`, ``"ll"`` on a flat
    :class:`EPContext` and ``"ar"`` without one. JAX first looks up a
    tuned winner for (mesh, batch, hidden, dtype); the port has no tune
    cache yet (``tune.py``, ROADMAP.md queue A item 4), so ``"auto"`` takes
    JAX's untuned default."""
    del batch, hidden, dtype, topk          # the tune cache's key
    if transport != "auto":
        return transport
    if isinstance(ctx, EP2DContext):
        return "ll2d"
    if ctx is None or not isinstance(ctx, EPContext):
        return "ar"
    return "ll"


def fwd_decode(params: MoE, x: torch.Tensor, *, topk: int, axis="ep",
               norm_topk_prob: bool = True, transport: str = "ar",
               ep_ctx=None, replicas=None, layer: int = 0) -> torch.Tensor:
    """Replicated-token EP decode: x (n, B, d), the same batch on every
    rank (at one rank (B, d)) → the same on every rank. ``transport`` is
    JAX's knob (module docstring); ``"ragged"`` and ``"ll"`` need a flat
    ``ep_ctx``, ``"ll2d"`` an :class:`EP2DContext`; ``layer`` keys the
    step parities (``2·layer``, ``2·layer + 1``). ``axis`` names the
    ranks' axis, one or an ``(outer, inner)`` pair (outer-major ranks).
    ``replicas`` raise (ROADMAP.md queue A item 8). JAX's ``counts``
    (per-expert load telemetry for the server) waits with
    ``with_expert_counts`` (queue A item 5)."""
    del axis              # the ranks are x's leading dimension
    xr = _ranks(x, ep_ctx)
    n, b, d = xr.shape
    # Every rank routes the same rows: route rank 0's copy once.
    ids, w = route(params.router, xr[0], topk, norm_topk_prob=norm_topk_prob)
    if transport == "auto":
        transport = resolve_transport("auto", ctx=ep_ctx, batch=b, hidden=d,
                                      dtype=x.dtype, topk=topk)
    if transport not in ("ar", "ragged", "ll", "ll2d"):
        raise ValueError(f"transport must be one of {DECODE_TRANSPORTS}, "
                         f"got {transport!r}")
    if transport == "ll2d":
        if not isinstance(ep_ctx, EP2DContext):
            raise ValueError(
                "transport='ll2d' needs a hierarchical EP2DContext "
                "(create_ep2d_context) — flat meshes ride 'll'")
        if replicas is not None:
            raise ValueError(
                "hot-expert replication rides the flat 'll' transport; "
                "transport='ll2d' does not consult replicas")
        out = _fwd_decode_slots(params, xr, ids, w, _ll2d_exchange(ep_ctx),
                                layer=layer)
    elif transport == "ar":
        out = _fwd_decode_ar(params, xr, ids, w)
    else:
        if ep_ctx is None or not isinstance(ep_ctx, EPContext):
            raise ValueError(
                f"transport={transport!r} needs a flat EPContext "
                "(hierarchical 2D meshes ride transport='ll2d')")
        if transport == "ragged":
            out = _fwd_decode_ragged(params, xr, ids, w, ctx=ep_ctx)
        else:
            if replicas is not None:
                raise ValueError(
                    "hot-expert replicas on the 'll' transport are not "
                    "ported yet: the server sets them (ROADMAP.md queue A "
                    "item 8)")
            out = _fwd_decode_slots(params, xr, ids, w, _ll_exchange(ep_ctx),
                                    layer=layer)
    return out[0] if x.dim() == 2 else out


def _fwd_decode_ar(params: MoE, x: torch.Tensor, ids: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """``"ar"``: every rank runs each of its local experts over the whole
    batch (one batched product over the (rank, expert) pairs: the weights'
    views, no copy), weights each expert's output by the combine mass the
    batch routed to it, and the ranks' fp32 partials are summed in rank
    order (JAX's psum)."""
    n, b, d = x.shape
    sh = param_specs(params, n)
    e_loc, f = sh["w_gate"].shape[1:3]
    ge = (torch.arange(n, device=x.device)[:, None] * e_loc
          + torch.arange(e_loc, device=x.device))              # (n, e_loc)
    sel = ids[None, :, :, None] == ge[:, None, None, :]        # (n, B, K, e)
    w_be = torch.einsum("bk,nbke->nbe", w.float(), sel.float())
    xe = x[:, None].expand(n, e_loc, b, d).reshape(n * e_loc, b, d)
    g = torch.bmm(xe, sh["w_gate"].reshape(n * e_loc, f, d).transpose(1, 2))
    u = torch.bmm(xe, sh["w_up"].reshape(n * e_loc, f, d).transpose(1, 2))
    act = (F.silu(g.float()) * u.float()).to(x.dtype)
    y = torch.bmm(act, sh["w_down"].reshape(n * e_loc, d, f).transpose(1, 2))
    out = torch.einsum("nebd,nbe->nbd", y.view(n, e_loc, b, d).float(), w_be)
    return out.sum(0).to(x.dtype).expand(n, b, d)


def _fwd_decode_ragged(params: MoE, x: torch.Tensor, ids: torch.Tensor,
                       w: torch.Tensor, *, ctx: EPContext) -> torch.Tensor:
    """``"ragged"``: every rank dispatches the (replicated) batch's
    assignments, owners run their grouped SwiGLU, the combine returns each
    rank its own copies: the output is replicated without a reduce."""
    n, b, _ = x.shape
    k = ids.shape[1]
    ids_n = ids.expand(n, b, k).contiguous()
    recv_tok, recv_exp, state = ep_dispatch(x, ids_n, ctx)
    y = expert_swiglu(param_specs(params, n), recv_tok, recv_exp,
                      block_m=suggested_block_m(b * k, 1,
                                                ctx.experts_per_rank,
                                                DECODE_BLOCK_M))
    return ep_combine(y, state, w.expand(n, b, k), ctx)


def _ll_exchange(ctx: EPContext):
    """The flat ``"ll"`` exchange: (n, n, B·K, d) slots → received, row 23
    (int8 codes unless the context's ``wire_dtype`` picks fp8)."""
    wire = ctx.wire_dtype if ctx.wire_dtype is not None else torch.int8
    return lambda send, step: ll_a2a(send, ctx=ctx.mesh, axis=ctx.axis,
                                     step=step, wire_dtype=wire)


def _ll2d_exchange(ctx: EP2DContext):
    """The ``"ll2d"`` exchange: the same slots over the two hops of
    :func:`~triton_dist_tpu_torch.ops.low_latency.ll_a2a_2d`, quantized
    once per hop."""
    wire = ctx.wire_dtype if ctx.wire_dtype is not None else torch.int8
    return lambda send, step: ll_a2a_2d(
        send, ctx=ctx.mesh, outer_axis=ctx.outer_axis,
        inner_axis=ctx.inner_axis, step=step, wire_dtype=wire, impl=ctx.impl)


def _fwd_decode_slots(params: MoE, x: torch.Tensor, ids: torch.Tensor,
                      w: torch.Tensor, exchange, *,
                      layer: int = 0) -> torch.Tensor:
    """``"ll"`` / ``"ll2d"``: the count-free fixed-slot exchange. Assignment
    ``j = t·K + k`` owns slot j of a (n, B·K, d) wire buffer: its owner's
    chunk holds the token there, every other chunk a zero row. The
    ``exchange`` runs at step ``2·layer``; each rank takes the chunk
    addressed through itself (every sender staged the same slots), runs its
    grouped SwiGLU on its own slots, and broadcasts its rows back through
    the same exchange at step ``2·layer + 1``; each assignment's output is
    read from its owner's chunk and combined in fp32."""
    n, b, d = x.shape
    k = ids.shape[1]
    sh = param_specs(params, n)
    e_loc = sh["w_gate"].shape[1]
    flat_e = ids.reshape(-1).long()                           # (BK,)
    dest = flat_e // e_loc
    slots = torch.arange(b * k, device=x.device)
    send = x.new_zeros((n, n, b * k, d))
    send[:, dest, slots] = x.repeat_interleave(k, dim=1)
    recv = exchange(send, 2 * layer)                          # (n, n, BK, d)
    ranks = torch.arange(n, device=x.device)
    tok = recv[ranks, ranks]                                  # (n, BK, d)
    mine = dest[None] == ranks[:, None]
    loc = torch.where(mine, (flat_e % e_loc)[None], -1).to(torch.int32)
    y = expert_swiglu(sh, tok, loc,
                      block_m=suggested_block_m(b * k, 1, e_loc,
                                                DECODE_BLOCK_M))
    back = exchange(y[:, None].expand(n, n, b * k, d).contiguous(),
                    2 * layer + 1)
    gathered = back[ranks[:, None], dest[None], slots[None]]  # (n, BK, d)
    return torch.einsum("nbkd,bk->nbd", gathered.view(n, b, k, d).float(),
                        w.float()).to(x.dtype)
