"""Pipeline-parallel communication and schedules over simulated ranks
(counterpart of ``triton_dist_tpu/layers/pp_comm.py``: ``send_next``,
``gpipe_forward`` and ``pipeline_forward``).

JAX runs the schedule inside ``shard_map`` over a ``pp`` mesh axis, one
program per stage. The port stacks the stages (:mod:`~triton_dist_tpu_torch.
parallel.mesh`, ``make_mesh(pp=S)``): every per-rank value carries the
ranks as its leading dimension, so **``stage_fn`` takes and returns the
stacked carry** ``(R, mb, ...)`` and must pass each rank's slice through
that rank's own stage only (rank r at position ``ctx.rank(axis, r)``
along the axis runs stage ``ctx.rank(axis, r)``; close over the stages'
parameters, as JAX's rank-local ``stage_fn`` closes over its pp-sharded
shard). It runs once a tick, so each rank does only its own stage's work.
The replicated inputs are given once, without a rank dimension:
``gpipe_forward``'s microbatches ``(M, mb, ...)`` (only each group's stage
0 reads them) and ``pipeline_forward``'s ``x``. The results are stacked:
``(R, M, mb, ...)``, every rank's copy.

- :func:`send_next`: the stage boundary, one shift along the axis (the last
  stage's output wraps to stage 0, which ignores it): ``impl="pallas"``
  is one launch of row 32 (:func:`~triton_dist_tpu_torch.ops.p2p.
  p2p_put`), over the leading dimension as one axis where ``ctx`` is
  ``None``; ``impl="xla"`` the plain permutation (one ``roll`` of the
  stacked ranks), as JAX takes ``lax.ppermute`` there. JAX's ``ctx=None``
  takes ``lax.ppermute`` too: the port launches the kernel it was asked
  for, and takes the plain version only for a CPU tensor, as every op.
- :func:`gpipe_forward`: the microbatched GPipe schedule, ``M + S - 1``
  lockstep ticks (a Python loop for JAX's ``lax.scan``, with no host
  synchronisation in it); stage 0 reads microbatch t at tick t (clipped
  past M), microbatch i leaves the last stage at tick i + S - 1.
  ``collect="broadcast"`` is JAX's where-masked psum of the last stage's
  outputs (plain torch, as JAX computes it outside any Pallas kernel);
  ``"last"`` returns every rank's raw outputs of those ticks. ``remat``
  wraps the stage in ``torch.utils.checkpoint``, which matters only under
  autograd, and autograd runs on ``impl="xla"`` alone: row 32's VJP waits
  for the training slice, so ``p2p_put`` on a tensor that requires grad
  raises.
- :func:`pipeline_forward`: the unbatched relay, every rank computing every
  stage and ``where``-masking (bring-up and oracle only, as in JAX).

The port needs ``ctx`` for the two schedules (it says how many stacked
ranks there are); JAX's may omit it.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.ops.p2p import p2p_put
from triton_dist_tpu_torch.parallel.mesh import make_mesh

IMPLS = ("pallas", "xla")
COLLECTS = ("broadcast", "last")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown pipeline boundary impl {impl!r} "
                         f"(one of {IMPLS})")


def send_next(x: torch.Tensor, *, axis: str = "pp", ctx=None,
              impl: str = "pallas") -> torch.Tensor:
    """Shift the stacked activations ``x`` (R, ...) one stage forward along
    ``axis`` (without ``ctx``, along the leading dimension itself)."""
    _check_impl(impl)
    if ctx is None:
        if impl == "xla":
            return x.roll(1, 0)
        ctx, axis = make_mesh(pp=x.shape[0], device=x.device), "pp"
    n, st = tp_gemm.axis_groups(x, ctx, axis)
    if impl == "xla":
        return tp_gemm.group_view(x, n, st).roll(1, 1).reshape(x.shape)
    return p2p_put(x, [(i, (i + 1) % n) for i in range(n)], ctx=ctx,
                   axis=axis)


def _positions(ctx, axis: str, like: torch.Tensor, dims: int) -> torch.Tensor:
    """Every rank's position along ``axis``, shaped (R, 1, ...) with
    ``dims`` trailing ones, made on the device (no host copy)."""
    n, st = ctx.size(axis), ctx.stride(axis)
    pos = torch.arange(ctx.n_ranks, device=like.device) // st % n
    return pos.view(-1, *([1] * dims))


def _need_ctx(ctx, name: str) -> None:
    if ctx is None:
        raise ValueError(f"{name}: the port stacks the stages on one device; "
                         "pass ctx, the mesh (make_mesh(pp=S)), so the "
                         "schedule knows how many ranks there are")


def _masked_sum(h: torch.Tensor, keep: torch.Tensor, ctx,
                axis: str) -> torch.Tensor:
    """JAX's ``psum`` of the last stage's values over ``axis``: every rank
    of a group ends with the group's sum, (R, ...). ``where``, not a
    product with the mask: the ranks masked out may hold a NaN (GPipe's
    warm-up and drain ticks run the stage on garbage carries), which must
    not poison the sum."""
    n, st = ctx.size(axis), ctx.stride(axis)
    masked = torch.where(keep, h, torch.zeros((), dtype=h.dtype,
                                              device=h.device))
    v = tp_gemm.group_view(masked, n, st)
    return v.sum(1, keepdim=True).expand(v.shape).reshape(h.shape)


def gpipe_forward(stage_fn: Callable, x_mb: torch.Tensor, *,
                  axis: str = "pp", ctx=None, impl: str = "xla",
                  collect: str = "broadcast",
                  remat: bool = False) -> torch.Tensor:
    """Microbatched GPipe schedule. ``stage_fn``: (R, mb, ...) → (R, mb,
    ...), each rank's slice through its own stage. ``x_mb``: (M, mb, ...)
    microbatches. ``collect="broadcast"`` returns (R, M, mb, ...), every
    rank's copy of the last stage's outputs; ``"last"`` each rank's own
    outputs of ticks S - 1 .. M + S - 2."""
    _need_ctx(ctx, "gpipe_forward")
    _check_impl(impl)
    if collect not in COLLECTS:
        raise ValueError(f"unknown collect {collect!r} (one of {COLLECTS})")
    n, m = ctx.size(axis), x_mb.shape[0]
    pos = _positions(ctx, axis, x_mb, x_mb.dim() - 1)
    fn = ((lambda h: checkpoint(stage_fn, h, use_reentrant=False))
          if remat else stage_fn)
    h = x_mb.new_zeros((ctx.n_ranks, *x_mb.shape[1:]))
    ys = []
    for t in range(m + n - 1):
        # Receive the upstream stage's last output; stage 0 feeds the next
        # microbatch instead (ticks past M feed a dummy that never reaches
        # the output window).
        h_in = send_next(h, axis=axis, ctx=ctx, impl=impl)
        h_in = torch.where(pos == 0, x_mb[min(t, m - 1)].to(h.dtype), h_in)
        h_out = fn(h_in)
        h = h_out.to(h.dtype)
        ys.append(h_out)
    outs = torch.stack(ys[n - 1:], dim=1)          # (R, M, mb, ...)
    if collect == "last":
        return outs
    return _masked_sum(outs, pos.unsqueeze(-1) == n - 1, ctx, axis)


def pipeline_forward(stage_fn: Callable, x: torch.Tensor, *,
                     num_stages: int, axis: str = "pp", ctx=None,
                     impl: str = "xla") -> torch.Tensor:
    """Unbatched stage relay: ``stage_fn(stage, h)`` on the stacked (R,
    ...) activations, every rank computing every stage and keeping it only
    at position ``stage``; ``x`` (...) is the input, given once. Returns
    (R, ...), every rank's copy of the last stage's output. S-fold
    redundant compute: bring-up and oracle only."""
    _need_ctx(ctx, "pipeline_forward")
    _check_impl(impl)
    pos = _positions(ctx, axis, x, x.dim())
    h = x.expand(ctx.n_ranks, *x.shape)
    for stage in range(num_stages):
        h = torch.where(pos == stage, stage_fn(stage, h), h)
        if stage < num_stages - 1:
            h = send_next(h, axis=axis, ctx=ctx, impl=impl)
    return _masked_sum(h, pos == num_stages - 1, ctx, axis)
