"""Expert-parallel dispatch/combine over simulated ranks (counterpart of
``triton_dist_tpu/ops/ep_a2a.py``: ``EPContext``, ``create_ep_context``,
``DispatchState``, ``RaggedDispatchState``, ``ExchangeState``,
``ragged_exchange``, ``ragged_return``, ``ep_dispatch``, ``ep_combine``,
``ep_moe_ref`` and the hierarchical ``EP2DContext``,
``create_ep2d_context``, ``Dispatch2DState``, ``ep_dispatch_2d`` and
``ep_combine_2d``).

The ranks are the leading dimension of every operand
(:mod:`~triton_dist_tpu_torch.parallel.mesh`): ``tokens`` (n, T, d) and
``topk_ids`` (n, T, K) stack each rank's own rows, and every state field
gains the same leading dimension. Rank r owns experts ``[r·E/n,
(r+1)·E/n)``. The index logic is JAX's, step for step: the stable sort by
destination (``perm``), the (n, n) counts matrices before and after the
receive-envelope clamp, which sorted rows traveled (``sent_sorted``), the
capped mode's slots and drops.

Two modes, as in JAX:

- **Drop-free** (``capacity=None``, the default): one
  :func:`ragged_exchange` hop keyed by destination rank into a receive
  buffer of ``recv_capacity`` rows a rank (default n·T·K, the provable
  worst case); the exact counts travel with the rows. JAX's hop is
  ``lax.ragged_all_to_all`` (an XLA collective); the port's is the ragged
  form of row 18 (:func:`~triton_dist_tpu_torch.ops.all_to_all.
  ragged_all_to_all`) plus index ops on the device.
- **Capped** (``capacity=C``): per-(source, destination) slots of C rows,
  overflow dropped with zero weight and counted, over the dense row 18
  (:func:`~triton_dist_tpu_torch.ops.all_to_all.all_to_all`), or with
  ``wire_dtype`` and ``impl="pallas"`` the quantized row 23
  (:func:`~triton_dist_tpu_torch.ops.low_latency.ll_a2a`).

``impl="xla"`` keeps JAX's meaning, the transport's plain composition
(``all_to_all_ref`` / the ragged emulation) even on a CUDA tensor; the
default ``"pallas"`` launches the kernels there. On a CPU tensor both are
the plain versions.

The hierarchical half (``EP2DContext``, ``create_ep2d_context``,
``Dispatch2DState``, ``ep_dispatch_2d``, ``ep_combine_2d``) runs over an
``(outer, inner)`` mesh such as ``make_mesh(dp=2, tp=2)``, rank r = o·n_in
+ i owning experts ``[r·E/n, (r+1)·E/n)``: the dispatch is two drop-free
hops, the inner one landing each assignment on the member of its group
whose inner index matches the owner's, then one outer hop per group. Each
hop is one ragged row 18 launch over every rank (a group's chunks to
another group are empty), each group's rows in JAX's order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.ops.all_to_all import (
    all_to_all, all_to_all_ref, ragged_all_to_all, ragged_all_to_all_ref)
from triton_dist_tpu_torch.ops.low_latency import (
    dequantize_rows, ll_a2a, quantize_rows)
from triton_dist_tpu_torch.parallel.mesh import MeshContext


@dataclasses.dataclass(frozen=True)
class EPContext:
    """JAX's ``EPContext``: the mesh, its axis (the port's ranks run on
    ``"tp"``), the expert count, top-k, the capped mode's ``capacity``,
    the drop-free receive envelope ``recv_capacity`` (rows a rank), the
    transport ``impl`` and the on-wire ``wire_dtype`` (torch.int8 or
    torch.float8_e4m3fn; None: full precision)."""
    mesh: MeshContext
    axis: str = "ep"
    num_experts: int = 8
    topk: int = 2
    capacity: Optional[int] = None
    recv_capacity: Optional[int] = None
    impl: str = "pallas"
    wire_dtype: Optional[torch.dtype] = None

    @property
    def experts_per_rank(self) -> int:
        return self.num_experts // self.mesh.size(self.axis)


def create_ep_context(mesh: MeshContext, *, num_experts: int, topk: int,
                      capacity: Optional[int] = None, axis: str = "ep",
                      impl: str = "pallas", wire_dtype=None,
                      recv_capacity: Optional[int] = None) -> EPContext:
    """Build the EP dispatch/combine context (JAX's checks)."""
    if num_experts % mesh.size(axis):
        raise ValueError(
            f"num_experts={num_experts} not divisible by ep={mesh.size(axis)}")
    if impl not in ("pallas", "xla"):
        raise ValueError(f"impl={impl!r}: 'pallas' (the kernels) or 'xla' "
                         "(the plain composition)")
    return EPContext(mesh=mesh, axis=axis, num_experts=num_experts,
                     topk=topk, capacity=capacity, impl=impl,
                     wire_dtype=wire_dtype, recv_capacity=recv_capacity)


@dataclasses.dataclass
class DispatchState:
    """Capped mode's routing metadata, kept at the source (n, T, K):
    destination rank, slot, sent (False: dropped by overflow), and the
    overflow count per rank (n,)."""
    slot_rank: torch.Tensor
    slot_index: torch.Tensor
    valid: torch.Tensor
    num_dropped: torch.Tensor = None


@dataclasses.dataclass
class ExchangeState:
    """One ragged hop: the sort permutation (n, N), the counts that
    traveled and the pre-clamp counts (n, n) ``[source, destination]``
    (the same on every rank in JAX, one copy here), and which sorted rows
    traveled (n, N)."""
    perm: torch.Tensor
    counts_mat: torch.Tensor
    orig_counts_mat: torch.Tensor
    sent_sorted: torch.Tensor


@dataclasses.dataclass
class RaggedDispatchState:
    """Drop-free mode's routing metadata: the hop, the sent status per
    assignment (n, T, K), and the assignments cut by the envelope per rank
    (n,)."""
    exchange: ExchangeState
    valid: torch.Tensor
    num_dropped: torch.Tensor = None


def _excl_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim) - x


def _rows(a: torch.Tensor) -> torch.Tensor:
    """A payload as rows the hop moves: a 2-D (n, N) one as (n, N, 1), fp8
    codes as their bytes (uint8: PyTorch has few ops on fp8 tensors)."""
    a = a[..., None] if a.dim() == 2 else a
    return a.view(torch.uint8) if a.element_size() == 1 and (
        a.dtype.is_floating_point) else a


def _unrows(r: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_rows` for a result of ``like``'s kind."""
    r = r.view(like.dtype) if r.dtype != like.dtype else r
    return r[..., 0] if like.dim() == 2 else r


def _hop(operand, out, in_off, sizes, out_off, ctx, axis, impl):
    if impl == "xla" or ctx is None:
        return ragged_all_to_all_ref(operand, out, in_off, sizes, out_off)
    return ragged_all_to_all(operand, out, in_off, sizes, out_off, ctx=ctx,
                             axis=axis)


def exchange_plan(dst: torch.Tensor, recv_rows: Optional[int] = None):
    """The index half of :func:`ragged_exchange`: ``dst`` (n, N) int32
    destination rank or -1 → ``(state, mats)``: the hop's
    :class:`ExchangeState` and the three (n, n) int32 matrices
    [source, destination] of its ragged all-to-all (each chunk's first row
    among the source's sorted rows, its rows after the envelope clamp, its
    first row at the destination). Device ops of fixed shape."""
    n, n_rows = dst.shape
    dev = dst.device
    if recv_rows is None:
        recv_rows = n * n_rows
    key = torch.where(dst < 0, n, dst).long()
    perm = torch.argsort(key, dim=1, stable=True)
    key_sorted = torch.gather(key, 1, perm)
    orig = torch.zeros((n, n + 1), dtype=torch.int32, device=dev).scatter_add_(
        1, key_sorted, torch.ones_like(key_sorted, dtype=torch.int32))[:, :n]
    counts_mat = orig
    in_off = _excl_cumsum(orig, 1)
    if recv_rows < n * n_rows:
        # Receives pack by source order: destination d accepts from source
        # s at most the room left after sources 0..s-1.
        prefix = _excl_cumsum(counts_mat, 0)
        counts_mat = torch.clamp(torch.minimum(counts_mat,
                                               recv_rows - prefix), min=0)
    j = torch.arange(n_rows, device=dev).expand(n, n_rows).contiguous()
    seg = torch.clamp(torch.searchsorted(in_off.long().contiguous(), j,
                                         right=True) - 1, 0, n - 1)
    sent_sorted = (key_sorted < n) & (
        j - torch.gather(in_off, 1, seg) < torch.gather(counts_mat, 1, seg))
    mats = tuple(m.to(torch.int32).contiguous() for m in (
        in_off, counts_mat, _excl_cumsum(counts_mat, 0)))
    return ExchangeState(perm=perm, counts_mat=counts_mat,
                         orig_counts_mat=orig, sent_sorted=sent_sorted), mats


def ragged_exchange(arrays, dst: torch.Tensor, fills=None,
                    recv_rows: Optional[int] = None, *,
                    ctx: Optional[MeshContext] = None, axis: str = "ep",
                    impl: str = "pallas"):
    """Drop-free exchange of rows by destination rank (JAX's
    ``ragged_exchange``; the ranks are ``dst``'s leading dimension).

    ``arrays``: (n, N, ...) row-aligned payloads; ``dst`` (n, N) int32
    destination rank, or -1 for a row that must not travel (it sorts to
    the tail and is not counted). Returns ``(recv_arrays, state)``: each
    received array (n, R, ...) holds the real rows packed at the front in
    source-rank order, the rest ``fills[i]``. ``recv_rows`` (default n·N)
    is R; below it every rank clamps its sends so each destination's rows
    fit (tail sources cut first), and the cut rows show in
    ``state.sent_sorted``. The hop is the ragged row 18 on ``ctx``'s mesh
    (``impl="pallas"``) or its plain version (``impl="xla"``, or no
    ``ctx``)."""
    n, n_rows = dst.shape
    recv_rows = n * n_rows if recv_rows is None else recv_rows
    state, mats = exchange_plan(dst, recv_rows)
    ranks = torch.arange(n, device=dst.device)[:, None]
    recv = []
    for arr, fill in zip(arrays, fills or (0,) * len(arrays)):
        a = _rows(arr)[ranks, state.perm]
        out = torch.full((n, recv_rows, *a.shape[2:]), fill, dtype=a.dtype,
                         device=dst.device)
        recv.append(_unrows(_hop(a, out, *mats, ctx, axis, impl), arr))
    return tuple(recv), state


def ragged_return(array: torch.Tensor, state: ExchangeState, *,
                  out_rows: int, fill=0, ctx: Optional[MeshContext] = None,
                  axis: str = "ep", impl: str = "pallas") -> torch.Tensor:
    """Reverse a :func:`ragged_exchange` hop (JAX's ``ragged_return``):
    ``array`` (n, R, ...) in received order travels back to its sources
    and is unsorted to the original row order, (n, out_rows, ...). Rows
    that never traveled come back as ``fill``."""
    counts_mat = state.counts_mat
    n = counts_mat.shape[0]
    # Sender r (the rows' owner) returns to source s the rows it received
    # from s, which land at s's ORIGINAL sorted-segment offset for r.
    mats = (_excl_cumsum(counts_mat, 0).t().to(torch.int32).contiguous(),
            counts_mat.t().to(torch.int32).contiguous(),
            _excl_cumsum(state.orig_counts_mat, 1).t().to(torch.int32)
            .contiguous())
    a = _rows(array)
    out = torch.full((n, out_rows, *a.shape[2:]), fill, dtype=a.dtype,
                     device=a.device)
    back = _hop(a, out, *mats, ctx, axis, impl)
    mask = state.sent_sorted.view(*state.sent_sorted.shape,
                                  *(1,) * (back.dim() - 2))
    unsorted = torch.full_like(back, fill)
    unsorted[torch.arange(n, device=a.device)[:, None], state.perm] = \
        torch.where(mask, back, unsorted)
    return _unrows(unsorted, array)


def _ep_dispatch_dropfree(tokens, topk_ids, ctx: EPContext):
    """Exact-splits dispatch: one :func:`ragged_exchange` hop keyed by
    destination rank, into ``ctx.recv_capacity`` rows a rank (default
    n·T·K: nothing can drop)."""
    n, t, d = tokens.shape
    k = topk_ids.shape[-1]
    e_loc = ctx.experts_per_rank
    dst_rank = (topk_ids // e_loc).reshape(n, t * k).to(torch.int32)
    local_exp = (topk_ids % e_loc).reshape(n, t * k).to(torch.int32)
    rep_tok = tokens.repeat_interleave(k, dim=1)              # (n, TK, d)
    kw = dict(recv_rows=ctx.recv_capacity, ctx=ctx.mesh, axis=ctx.axis,
              impl=ctx.impl)
    if ctx.wire_dtype is not None:
        q, scale = quantize_rows(rep_tok, ctx.wire_dtype)
        (rq, rs, recv_exp), st = ragged_exchange((q, scale, local_exp),
                                                 dst_rank, (0, 0, -1), **kw)
        recv_tok = dequantize_rows(rq, rs, tokens.dtype)
    else:
        (recv_tok, recv_exp), st = ragged_exchange((rep_tok, local_exp),
                                                   dst_rank, (0, -1), **kw)
    valid = torch.zeros((n, t * k), dtype=torch.bool,
                        device=tokens.device).scatter_(1, st.perm,
                                                       st.sent_sorted)
    state = RaggedDispatchState(
        exchange=st, valid=valid.view(n, t, k),
        num_dropped=(~valid).sum(1).to(torch.int32))
    return recv_tok, recv_exp, state


def _weighted(gathered, w, dtype):
    return torch.einsum("ntkd,ntk->ntd", gathered.float(), w.float()).to(dtype)


def _ep_combine_dropfree(expert_out, state: RaggedDispatchState,
                         topk_weights, ctx: EPContext):
    """Reverse the ragged route (:func:`ragged_return`) and apply the top-k
    weights at the source, in fp32."""
    n, t, k = topk_weights.shape
    st = state.exchange
    kw = dict(out_rows=t * k, ctx=ctx.mesh, axis=ctx.axis, impl=ctx.impl)
    if ctx.wire_dtype is not None:
        q, scale = quantize_rows(expert_out, ctx.wire_dtype)
        back = dequantize_rows(ragged_return(q, st, **kw),
                               ragged_return(scale, st, **kw),
                               expert_out.dtype)
    else:
        back = ragged_return(expert_out, st, **kw)
    return _weighted(back.view(n, t, k, -1), topk_weights, expert_out.dtype)


def _transport(ctx: EPContext, x):
    if ctx.impl == "xla":
        return all_to_all_ref(x)
    return all_to_all(x, ctx=ctx.mesh, axis=ctx.axis)


def _quant_transport(ctx: EPContext, x, step=0):
    """Token transport with optional on-wire quantization: with
    ``wire_dtype`` and ``impl="pallas"`` the quantizing row 23
    (:func:`ll_a2a`), with ``impl="xla"`` the codes and scales around the
    plain transport."""
    if ctx.wire_dtype is None:
        return _transport(ctx, x)
    if ctx.impl == "pallas":
        return ll_a2a(x, ctx=ctx.mesh, axis=ctx.axis, step=step,
                      wire_dtype=ctx.wire_dtype)
    q, scale = quantize_rows(x, ctx.wire_dtype)
    return dequantize_rows(_transport(ctx, q), _transport(ctx, scale),
                           x.dtype)


def ep_dispatch(tokens: torch.Tensor, topk_ids: torch.Tensor,
                ctx: EPContext):
    """Route tokens to the ranks owning their top-k experts.

    tokens (n, T, d); topk_ids (n, T, K) global expert ids. Returns
    ``(recv_tokens (n, R, d), recv_expert (n, R) local expert id or -1 for
    an empty slot, state)``; R = n·T·K drop-free (or ``recv_capacity``),
    n·C capped."""
    if ctx.capacity is None:
        return _ep_dispatch_dropfree(tokens, topk_ids, ctx)
    n, t, d = tokens.shape
    k = topk_ids.shape[-1]
    cap = ctx.capacity
    e_loc = ctx.experts_per_rank
    dev = tokens.device
    dst_rank = (topk_ids // e_loc).long()                  # (n, T, K)
    flat_rank = dst_rank.reshape(n, t * k)
    # Slot within each destination: the running count of earlier (token,
    # k) pairs headed to the same rank.
    pos = torch.cumsum(F.one_hot(flat_rank, n), dim=1) - 1   # (n, TK, n)
    slot = torch.gather(pos, 2, flat_rank[..., None])[..., 0]
    valid = slot < cap
    # Overflow scatters into a spare slot past the end, then dropped.
    s_idx = torch.where(valid, slot, cap)
    rows = (torch.arange(n, device=dev)[:, None] * n + flat_rank) * (
        cap + 1) + s_idx
    send_tok = tokens.new_zeros((n * n * (cap + 1), d)).index_copy_(
        0, rows.reshape(-1), tokens.repeat_interleave(k, dim=1)
        .reshape(n * t * k, d)).view(n, n, cap + 1, d)[:, :, :cap]
    send_exp = torch.full((n * n * (cap + 1),), -1, dtype=torch.int32,
                          device=dev).index_copy_(
        0, rows.reshape(-1),
        (topk_ids % e_loc).reshape(-1).to(torch.int32)).view(
        n, n, cap + 1)[:, :, :cap]
    recv_tok = _quant_transport(ctx, send_tok.contiguous(), step=0)
    recv_exp = _transport(ctx, send_exp.contiguous()[..., None])[..., 0]
    state = DispatchState(
        slot_rank=dst_rank.to(torch.int32),
        slot_index=slot.view(n, t, k).to(torch.int32),
        valid=valid.view(n, t, k),
        num_dropped=(~valid).sum(1).to(torch.int32))
    return (recv_tok.reshape(n, n * cap, d), recv_exp.reshape(n, n * cap),
            state)


def ep_combine(expert_out: torch.Tensor, state, topk_weights: torch.Tensor,
               ctx: EPContext) -> torch.Tensor:
    """Return expert outputs (n, R, d), in :func:`ep_dispatch`'s received
    order, to their source ranks and reduce with the top-k weights (n, T,
    K) in fp32. Returns (n, T, d)."""
    if isinstance(state, RaggedDispatchState):
        return _ep_combine_dropfree(expert_out, state, topk_weights, ctx)
    n = expert_out.shape[0]
    cap = ctx.capacity
    d = expert_out.shape[-1]
    back = _quant_transport(ctx, expert_out.reshape(n, n, cap, d),
                            step=1)       # (n, n, C, d): opposite parity
    # back[r][p, s]: my token's output computed on rank p at slot s (the
    # slots were assigned here).
    sr = torch.where(state.valid, state.slot_rank, 0).long()
    si = torch.where(state.valid, state.slot_index, 0).long()
    ranks = torch.arange(n, device=expert_out.device).view(n, 1, 1)
    gathered = back[ranks, sr, si]                          # (n, T, K, d)
    w = torch.where(state.valid, topk_weights.float(), 0.0)
    return _weighted(gathered, w, expert_out.dtype)


def ep_moe_ref(tokens: torch.Tensor, topk_ids: torch.Tensor,
               topk_weights: torch.Tensor, expert_fn,
               num_experts: int) -> torch.Tensor:
    """Dense oracle (one rank's rows): every token through each of its
    top-k experts (``expert_fn(tokens, e)`` → (T, d)), combined in fp32."""
    t, d = tokens.shape
    all_out = torch.stack([expert_fn(tokens, e)
                           for e in range(num_experts)])   # (E, T, d)
    tok = torch.arange(t, device=tokens.device)[:, None].expand(topk_ids.shape)
    sel = all_out[topk_ids.long(), tok]                     # (T, K, d)
    return torch.einsum("tkd,tk->td", sel.float(),
                        topk_weights.float()).to(tokens.dtype)


@dataclasses.dataclass(frozen=True)
class EP2DContext:
    """JAX's hierarchical EP geometry over an ``(outer, inner)`` mesh:
    expert e lives on rank ``e // experts_per_rank``, rank = o·n_in + i.
    ``wire_dtype`` (None: int8) and ``impl`` feed the ``"ll2d"`` decode
    transport (:func:`~triton_dist_tpu_torch.ops.low_latency.ll_a2a_2d`:
    ``"kernel"``, row 23, or ``"xla"``, the same wire payload through the
    plain transport). The prefill's ragged hops always take row 18."""
    mesh: MeshContext
    outer_axis: str = "dcn"
    inner_axis: str = "ici"
    num_experts: int = 8
    topk: int = 2
    wire_dtype: Optional[torch.dtype] = None
    impl: str = "kernel"

    @property
    def experts_per_rank(self) -> int:
        return self.num_experts // self.mesh.size((self.outer_axis,
                                                   self.inner_axis))


def create_ep2d_context(mesh: MeshContext, *, num_experts: int, topk: int,
                        outer_axis: str = "dcn", inner_axis: str = "ici",
                        wire_dtype=None, impl: str = "kernel") -> EP2DContext:
    """Build the hierarchical EP context (JAX's checks; the pair must be two
    axes of ``mesh`` in its order spanning all its ranks)."""
    tp_gemm.check_axis("create_ep2d_context", mesh, (outer_axis, inner_axis))
    n = mesh.size((outer_axis, inner_axis))
    if num_experts % n:
        raise ValueError(f"num_experts={num_experts} not divisible by "
                         f"{outer_axis}x{inner_axis}={n}")
    return EP2DContext(mesh=mesh, outer_axis=outer_axis,
                       inner_axis=inner_axis, num_experts=num_experts,
                       topk=topk, wire_dtype=wire_dtype, impl=impl)


@dataclasses.dataclass
class Dispatch2DState:
    """Reverse-route metadata: one :class:`ExchangeState` per hop (every
    rank's, (R, R) counts whose group blocks are JAX's (n, n) ones) and the
    rows each hop started from."""
    inner: ExchangeState
    outer: ExchangeState
    inner_rows: int
    outer_rows: int


def _axis_peers(mesh: MeshContext, axis: str, pos: torch.Tensor):
    """(R, N) positions along ``axis`` → the flat ranks there, each row's
    rank r keeping its other coordinates (-1 stays -1)."""
    n, st = mesh.size(axis), mesh.stride(axis)
    r = torch.arange(pos.shape[0], device=pos.device)[:, None]
    return torch.where(pos < 0, -1, r + (pos - r // st % n) * st).to(
        torch.int32)


def _hops_kw(ctx: EP2DContext) -> dict:
    return dict(ctx=ctx.mesh, axis=(ctx.outer_axis, ctx.inner_axis))


def ep_dispatch_2d(tokens: torch.Tensor, topk_ids: torch.Tensor,
                   ctx: EP2DContext):
    """Two-hop drop-free dispatch: (o, i) → (o, i') over the inner axis,
    then (o, i') → (o', i') over the outer one. tokens (R, T, d), topk_ids
    (R, T, K) global expert ids. Returns ``(recv_tokens (R, R·T·K, d),
    recv_expert (R, R·T·K) local expert or -1, state)``."""
    mesh = ctx.mesh
    r_all, t, _ = tokens.shape
    k = topk_ids.shape[-1]
    n_in = mesh.size(ctx.inner_axis)
    owner = (topk_ids // ctx.experts_per_rank).reshape(r_all, t * k)
    local = (topk_ids % ctx.experts_per_rank).reshape(r_all, t * k).to(
        torch.int32)
    kw = _hops_kw(ctx)
    (tok1, dcn1, exp1), st_inner = ragged_exchange(
        (tokens.repeat_interleave(k, dim=1), (owner // n_in).to(torch.int32),
         local), _axis_peers(mesh, ctx.inner_axis, owner % n_in),
        (0, -1, -1), recv_rows=n_in * t * k, **kw)
    (tok2, exp2), st_outer = ragged_exchange(
        (tok1, exp1), _axis_peers(mesh, ctx.outer_axis, dcn1), (0, -1),
        recv_rows=mesh.size(ctx.outer_axis) * tok1.shape[1], **kw)
    return tok2, exp2, Dispatch2DState(inner=st_inner, outer=st_outer,
                                       inner_rows=t * k,
                                       outer_rows=tok1.shape[1])


def ep_combine_2d(expert_out: torch.Tensor, state: Dispatch2DState,
                  topk_weights: torch.Tensor,
                  ctx: EP2DContext) -> torch.Tensor:
    """Reverse both hops and reduce with the top-k weights (R, T, K) at the
    source in fp32. expert_out (R, R·T·K, d): rows aligned with
    :func:`ep_dispatch_2d`'s received tokens. Returns (R, T, d)."""
    n, t, k = topk_weights.shape
    kw = _hops_kw(ctx)
    back1 = ragged_return(expert_out, state.outer,
                          out_rows=state.outer_rows, **kw)
    back0 = ragged_return(back1, state.inner, out_rows=state.inner_rows,
                          **kw)
    return _weighted(back0.view(n, t, k, -1), topk_weights, expert_out.dtype)
