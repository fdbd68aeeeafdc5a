"""Tile-fused expert-parallel MoE (counterpart of
``triton_dist_tpu/ops/ep_fused.py``: ``EPFusedContext``,
``create_ep_fused_context``, ``RouteState``, ``ep_route``,
``ep_dispatch_gemm``, ``ep_gemm_combine`` and ``ep_moe_fused``).

The reference's Mega-EP pairing: the dispatch all-to-all fused into the
expert up-projection (an expert's tiles start as its tokens arrive) and
the down projection fused into the combine all-to-all (tiles go home as
they are produced). Tokens are packed per (destination rank, local
expert) with ``capacity_per_expert`` slots for each (source, destination,
expert) triple, so a receiving tile knows its expert from its place;
assignments past the capacity are dropped with zero weight and counted
(``RouteState.num_dropped``).

The ranks are the leading dimension of every operand
(:mod:`~triton_dist_tpu_torch.parallel.mesh`): ``tokens`` (n, T, d),
``topk_ids`` (n, T, K), and each of JAX's per-rank arrays gains it: the
send layout (n_src, n_dst, E_loc, C, d), the up-projection ``h``
(n_owner, n_src, E_loc, C, F) (``h[o][s][e]``: rank o's product of the
tokens rank s placed at expert e), the combine buffer (n_src, n_owner,
E_loc, C, d). Rank r owns experts ``[r·E/n, (r+1)·E/n)``; its weights are
views of the one weight stored ``(out, in)`` as everywhere in the port:
``w_gate``/``w_up`` (n, E_loc, f, d), ``w_down`` (n, E_loc, d, f)
(:func:`~triton_dist_tpu_torch.layers.ep_moe.param_specs`).

On a CUDA tensor each fused op is one cooperative launch over every rank
(``csrc/ep_fused.cu``): ``ep_dispatch_gemm_kernel`` (row 25, replacing
``_dispatch_gemm_kernel`` :137) puts every (destination, expert) chunk,
with its count of filled slots, into the owner's receive buffer and
raises one flag per (source, expert); each (owner, source, expert, column
tile) GEMM item waits for its flag. It reads the gate and up shards as
one B operand, so JAX's concatenated ``w_gu`` has no counterpart.
``ep_gemm_combine_kernel`` (row 26, replacing ``_gemm_combine_kernel``
:255) computes each (owner, source, expert, d tile) block of the down
projection and stores it straight into the source's combine buffer with
one flag; every source then waits for all of its blocks. Both kernels
skip the rows past each capacity's filled slots (JAX's zero rows) and
store the zeros the product gives. On a CPU tensor the plain versions
(:func:`dispatch_gemm_ref`, :func:`gemm_combine_ref`) compute the same
products over every slot.

Each down-projected block is rounded to the activations' dtype before the
weighted gather at the source (JAX keeps that buffer in fp32); the port's
drop-free EP layer rounds its expert outputs at the same place
(:func:`~triton_dist_tpu_torch.layers.ep_moe.expert_swiglu`). The gather
and the top-k weights stay plain PyTorch, as they stay XLA outside the
Pallas call in JAX; so does the SwiGLU between the two kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.ops.group_gemm import Weights, _bmm_f32, as_weights
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

FAULTS = {"slot_shifted": 1, "lost_signal": 2, "wrong_source": 3}
ROW_BLOCK = 64       # csrc/ep_fused.cu EpTile: capacity rows an item
COL_BLOCK = 128      # output columns an item

_SYNC = [ctypes.c_void_p] * 2 + [ctypes.c_uint64] * 2 + [ctypes.c_int]
# ``DISPATCH_KERNEL.launches`` / ``COMBINE_KERNEL.launches`` count
# launches of the two CUDA kernels.
DISPATCH_KERNEL = CudaKernel("ep_fused.cu", "tdt_ep_dispatch_gemm",
                             [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 6
                             + [ctypes.c_int] * 6 + _SYNC)
COMBINE_KERNEL = CudaKernel("ep_fused.cu", "tdt_ep_gemm_combine",
                            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                            + [ctypes.c_int] * 5 + _SYNC)


@dataclasses.dataclass(frozen=True)
class EPFusedContext:
    """JAX's ``EPFusedContext``: the mesh and its axis, the expert count,
    top-k, and the slots of each (source, destination, local expert)
    triple. JAX's VMEM tile knobs ``block_f``/``block_d`` have no
    counterpart: the CUDA kernels pick their own tiles."""
    mesh: MeshContext
    axis: str = "ep"
    num_experts: int = 8
    topk: int = 2
    capacity_per_expert: int = 64

    @property
    def experts_per_rank(self) -> int:
        return self.num_experts // self.mesh.size(self.axis)


def create_ep_fused_context(mesh: MeshContext, *, num_experts: int,
                            topk: int, capacity_per_expert: int,
                            axis: str = "ep") -> EPFusedContext:
    if num_experts % mesh.size(axis):
        raise ValueError(f"num_experts={num_experts} not divisible by "
                         f"ep={mesh.size(axis)}")
    return EPFusedContext(mesh=mesh, axis=axis, num_experts=num_experts,
                          topk=topk, capacity_per_expert=capacity_per_expert)


@dataclasses.dataclass
class RouteState:
    """Source-side routing metadata (n, T, K), as JAX's: destination rank,
    local expert there, slot within that capacity (the running count,
    past the capacity for a dropped assignment), sent, and the dropped
    assignments per rank (n,). The port adds ``counts`` (n_src, n_dst,
    E_loc), the filled slots of each capacity, which travel with the
    tokens, and ``recv_counts`` (n_owner, n_src, E_loc), what each owner
    received (set by :func:`ep_dispatch_gemm`)."""
    slot_rank: torch.Tensor
    slot_expert: torch.Tensor
    slot_index: torch.Tensor
    valid: torch.Tensor
    num_dropped: torch.Tensor
    counts: Optional[torch.Tensor] = None
    recv_counts: Optional[torch.Tensor] = None


def _ranks(ctx: EPFusedContext, x: torch.Tensor) -> int:
    n = ctx.mesh.size(ctx.axis)
    if x.shape[0] != n:
        raise ValueError(f"leading dim {x.shape[0]} != the {ctx.axis!r} "
                         f"axis size {n}")
    return n


def ep_route(tokens: torch.Tensor, topk_ids: torch.Tensor,
             ctx: EPFusedContext) -> Tuple[torch.Tensor, RouteState]:
    """Pack every rank's tokens (n, T, d) into the send layout (n_src,
    n_dst, E_loc, C, d) by their top-k ids (n, T, K). A slot is the running
    count of earlier (token, k) assignments of the same rank to the same
    expert (JAX's one-hot cumsum), so a capacity's filled slots are its
    first ``counts`` rows and the rest stay zero. Device ops of fixed
    shape, no host read. Returns ``(send, state)``."""
    n = _ranks(ctx, tokens)
    _, t, d = tokens.shape
    k = topk_ids.shape[-1]
    e_loc, cap = ctx.experts_per_rank, ctx.capacity_per_expert
    dev = tokens.device
    group = topk_ids.reshape(n, t * k).long()       # dst_rank·E_loc + local
    one_hot = F.one_hot(group, ctx.num_experts)     # (n, TK, E)
    slot = torch.gather(one_hot.cumsum(1) - 1, 2, group[..., None])[..., 0]
    counts = one_hot.sum(1).clamp(max=cap).to(torch.int32).view(n, n, e_loc)
    valid = slot < cap
    # Overflow lands in one spare row past the end, then dropped.
    spare = n * n * e_loc * cap
    rows = torch.where(valid, (torch.arange(n, device=dev)[:, None]
                               * ctx.num_experts + group) * cap + slot, spare)
    send = tokens.new_zeros((spare + 1, d)).index_copy_(
        0, rows.reshape(-1),
        tokens.repeat_interleave(k, dim=1).reshape(n * t * k, d))
    state = RouteState(
        slot_rank=(topk_ids // e_loc).to(torch.int32),
        slot_expert=(topk_ids % e_loc).to(torch.int32),
        slot_index=slot.view(n, t, k).to(torch.int32),
        valid=valid.view(n, t, k),
        num_dropped=(~valid).sum(1).to(torch.int32),
        counts=counts)
    return send[:spare].view(n, n, e_loc, cap, d), state


def _expert_products(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (n, n_src, E_loc, C, K) · w (n, E_loc, N, K)ᵀ per (rank, expert),
    fp32 sums rounded to a's dtype → (n, n_src, E_loc, C, N)."""
    n, n_src, e_loc, c, kk = a.shape
    lhs = a.permute(0, 2, 1, 3, 4).reshape(n * e_loc, n_src * c, kk)
    out = _bmm_f32(lhs, w.reshape(n * e_loc, -1, kk).transpose(1, 2))
    return out.view(n, e_loc, n_src, c, -1).permute(0, 2, 1, 3, 4).to(
        a.dtype, memory_format=torch.contiguous_format)


def _gate_up(w: Weights) -> torch.Tensor:
    ws = as_weights(w, ranks=True)
    return ws[0] if len(ws) == 1 else torch.cat(ws, dim=2)


def dispatch_gemm_ref(send: torch.Tensor, w: Weights):
    """Plain version of :func:`dispatch_gemm`: the received tokens are the
    send layout with its two rank dimensions swapped, and every slot's
    product with its expert's weight (one (n, E_loc, F, d) weight, or the
    gate and up pair read as one) in fp32, rounded once."""
    recv = send.transpose(0, 1).contiguous()
    return _expert_products(recv, _gate_up(w)), recv


def dispatch_gemm(send: torch.Tensor, counts: torch.Tensor, w: Weights,
                  ctx: EPFusedContext, *, fault: int = 0,
                  timeout_s: float = shmem.TIMEOUT_S, check: bool = False):
    """The fused dispatch and up-projection over every rank: ``send``
    (n_src, n_dst, E_loc, C, d) from :func:`ep_route`, ``counts`` (n_src,
    n_dst, E_loc) its filled slots, ``w`` each rank's expert weights (n,
    E_loc, F, d) or the (gate, up) pair. Returns ``(h (n_owner, n_src,
    E_loc, C, F), recv (n_owner, n_src, E_loc, C, d), recv_counts (n_owner,
    n_src, E_loc))``. On a CUDA tensor one launch of
    ``ep_dispatch_gemm_kernel``; on a CPU tensor :func:`dispatch_gemm_ref`.
    ``fault`` (a value of :data:`FAULTS`), ``timeout_s`` and ``check`` as
    in :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    n = _ranks(ctx, send)
    ws_ = as_weights(w, ranks=True)
    if send.device.type == "cpu":
        h, recv = dispatch_gemm_ref(send, ws_)
        return h, recv, counts.transpose(0, 1).contiguous()
    _, _, e_loc, cap, d = send.shape
    tp_gemm.check_cuda("ep_dispatch_gemm", send, *ws_)
    if not send.is_contiguous() or ws_[0].shape[:2] != (n, e_loc):
        raise ValueError("ep_dispatch_gemm: send must be contiguous and the "
                         f"weights (n={n}, E_loc={e_loc}, F, d)")
    if (counts.dtype != torch.int32 or not counts.is_contiguous()
            or tuple(counts.shape) != (n, n, e_loc)):
        raise ValueError(f"counts must be contiguous int32 {(n, n, e_loc)}")
    dev = send.device
    f0 = ws_[0].shape[2]
    f1 = ws_[1].shape[2] if len(ws_) == 2 else 0
    wu = ws_[1] if f1 else ws_[0]
    h = send.new_empty((n, n, e_loc, cap, f0 + f1))
    recv = torch.empty_like(send)
    recv_counts = torch.empty_like(counts)
    ws = shmem.workspace("ep_dispatch_gemm", (e_loc,), n=n, device=dev,
                         n_flags=n * n * e_loc)

    def describe(rank, step, slot):
        return (f"ep_dispatch_gemm: rank {rank} waited for rank {step}'s "
                f"tokens of its local expert {slot % e_loc} (flag slot "
                f"{slot}) past {timeout_s} s")

    tp_gemm.launch(DISPATCH_KERNEL, ws, describe, send.data_ptr(),
                   counts.data_ptr(), ws_[0].data_ptr(), wu.data_ptr(),
                   recv.data_ptr(), recv_counts.data_ptr(), h.data_ptr(),
                   *ws_[0].stride()[:3], *wu.stride()[:3], n, e_loc, cap, d,
                   f0, f1, device=dev, timeout_s=timeout_s, fault=fault,
                   check=check)
    return h, recv, recv_counts


def gemm_combine_ref(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gemm_combine`: every slot's down projection
    in fp32, rounded once, returned to its source: (n_src, n_owner, E_loc,
    C, d)."""
    return _expert_products(y, w).transpose(0, 1).contiguous()


def gemm_combine(y: torch.Tensor, recv_counts: torch.Tensor,
                 w: torch.Tensor, ctx: EPFusedContext, *, fault: int = 0,
                 timeout_s: float = shmem.TIMEOUT_S,
                 check: bool = False) -> torch.Tensor:
    """The fused down projection and combine over every rank: ``y``
    (n_owner, n_src, E_loc, C, F) the activated rows, ``recv_counts``
    their filled slots, ``w`` each rank's down weights (n, E_loc, d, F).
    Returns the combine buffer (n_src, n_owner, E_loc, C, d): block
    ``[s][o][e]`` is rank o's output for the tokens rank s placed at its
    expert e. On a CUDA tensor one launch of ``ep_gemm_combine_kernel``; on
    a CPU tensor :func:`gemm_combine_ref`. ``fault``, ``timeout_s`` and
    ``check`` as in :func:`dispatch_gemm`."""
    n = _ranks(ctx, y)
    if y.device.type == "cpu":
        return gemm_combine_ref(y, w)
    _, _, e_loc, cap, f = y.shape
    d = w.shape[2]
    tp_gemm.check_cuda("ep_gemm_combine", y, w)
    if (not y.is_contiguous() or tuple(w.shape) != (n, e_loc, d, f)
            or tuple(recv_counts.shape) != (n, n, e_loc)
            or recv_counts.dtype != torch.int32
            or not recv_counts.is_contiguous()):
        raise ValueError(f"ep_gemm_combine: y {tuple(y.shape)} contiguous, w "
                         f"{(n, e_loc, d, f)}, recv_counts {(n, n, e_loc)} "
                         "int32")
    dev = y.device
    n_rb = -(-cap // ROW_BLOCK)
    n_cb = -(-d // COL_BLOCK)
    # A planted fault leaves a block unwritten: zeros keep it visible.
    comb = (torch.zeros if fault else torch.empty)(
        (n, n, e_loc, cap, d), dtype=y.dtype, device=dev)
    ws = shmem.workspace("ep_gemm_combine", (e_loc, n_cb, n_rb), n=n,
                         device=dev, n_flags=n * n * e_loc * n_cb * n_rb)

    def describe(rank, step, slot):
        owner = slot // (e_loc * n_cb * n_rb) % n
        e = slot // (n_cb * n_rb) % e_loc
        return (f"ep_gemm_combine: rank {rank} waited for rank {owner}'s "
                f"block of its local expert {e}, d tile "
                f"{slot // n_rb % n_cb} (flag slot {slot}) past "
                f"{timeout_s} s")

    tp_gemm.launch(COMBINE_KERNEL, ws, describe, y.data_ptr(),
                   recv_counts.data_ptr(), w.data_ptr(), comb.data_ptr(),
                   *w.stride()[:3], n, e_loc, cap, f, d, device=dev,
                   timeout_s=timeout_s, fault=fault, check=check)
    return comb


def ep_dispatch_gemm(tokens: torch.Tensor, topk_ids: torch.Tensor,
                     w: Weights, ctx: EPFusedContext, **launch):
    """Fused dispatch all-to-all + up-projection grouped GEMM: tokens (n,
    T, d), topk_ids (n, T, K), ``w`` each rank's up-projection (n, E_loc,
    F, d), or the gate and up pair (JAX's concatenated gate|up). Returns
    ``(h (n_owner, n_src, E_loc, C, F), state)``; ``launch``: ``fault``,
    ``timeout_s``, ``check`` of :func:`dispatch_gemm`."""
    send, state = ep_route(tokens, topk_ids, ctx)
    h, _, state.recv_counts = dispatch_gemm(send, state.counts, w, ctx,
                                            **launch)
    return h, state


def combine_gather(comb: torch.Tensor, state: RouteState,
                   topk_weights: torch.Tensor) -> torch.Tensor:
    """The source's weighted gather (JAX :369-375): each valid assignment's
    row of the combine buffer (n_src, n_owner, E_loc, C, d), weighted by
    its top-k weight in fp32, dropped ones by zero → (n, T, d)."""
    n = comb.shape[0]
    v = state.valid
    src = torch.arange(n, device=comb.device).view(n, 1, 1)
    gathered = comb[src, torch.where(v, state.slot_rank, 0).long(),
                    torch.where(v, state.slot_expert, 0).long(),
                    torch.where(v, state.slot_index, 0).long()]
    wts = torch.where(v, topk_weights.float(), 0.0)
    return torch.einsum("ntkd,ntk->ntd", gathered.float(),
                        wts).to(comb.dtype)


def ep_gemm_combine(y: torch.Tensor, w: torch.Tensor, state: RouteState,
                    topk_weights: torch.Tensor, ctx: EPFusedContext,
                    **launch) -> torch.Tensor:
    """Fused down-projection grouped GEMM + combine all-to-all: ``y``
    (n_owner, n_src, E_loc, C, F) the activated expert rows in dispatch
    order, ``w`` (n, E_loc, d, F). Returns (n, T, d) with the top-k weights
    (n, T, K) applied at the source (weights never travel)."""
    counts = (state.recv_counts if state.recv_counts is not None
              else state.counts.transpose(0, 1).contiguous())
    comb = gemm_combine(y.contiguous(), counts, w, ctx, **launch)
    return combine_gather(comb, state, topk_weights)


def ep_moe_fused(x: torch.Tensor, topk_ids: torch.Tensor,
                 topk_weights: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor,
                 ctx: EPFusedContext):
    """The fused EP MoE forward: dispatch + up GEMM → SwiGLU (fp32, rounded
    to x's dtype) → down GEMM + combine. x (n, T, d); ``w_gate``/``w_up``
    (n, E_loc, f, d), ``w_down`` (n, E_loc, d, f), every rank's experts.
    Returns ``((n, T, d), num_dropped (n,))``."""
    f = w_gate.shape[2]
    h, state = ep_dispatch_gemm(x, topk_ids, (w_gate, w_up), ctx)
    act = (F.silu(h[..., :f].float()) * h[..., f:].float()).to(x.dtype)
    out = ep_gemm_combine(act, w_down, state, topk_weights, ctx)
    return out, state.num_dropped
