"""Ulysses sequence parallelism: the head <-> sequence resharding
all-to-alls (counterpart of ``triton_dist_tpu/ops/ulysses.py``:
``pre_attn_a2a``, ``post_attn_a2a`` and ``ulysses_attn``).

The ranks are the leading dimension (:mod:`~triton_dist_tpu_torch.
parallel.mesh`). Before attention the activations are sequence-sharded,
``(n, S_loc, H, hd)``: rank r holds positions ``[r·S_loc, (r+1)·S_loc)``
with every head. :func:`pre_attn_a2a` returns ``(n, S, H/n, hd)``: rank r
holds the whole sequence (source-major, so in position order) of its heads
``[r·H/n, (r+1)·H/n)``; :func:`post_attn_a2a` reverses it.

The transport is row 18, the direct-put all-to-all
(:func:`~triton_dist_tpu_torch.ops.all_to_all.all_to_all`, one launch of
``all_to_all_kernel`` on a CUDA tensor); ``impl="xla"`` or no ``ctx``
takes :func:`~triton_dist_tpu_torch.ops.all_to_all.all_to_all_ref`, JAX's
``lax.all_to_all`` oracle. The fused forms, with the projections inside
the exchange, are :mod:`~triton_dist_tpu_torch.ops.ulysses_fused`.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.ops.all_to_all import all_to_all, all_to_all_ref
from triton_dist_tpu_torch.parallel.mesh import MeshContext


def _ranks(x: torch.Tensor, ctx, axis: str, op: str) -> int:
    if ctx is None:
        return x.shape[0]
    tp_gemm.check_axis(op, ctx, axis)
    n = ctx.size(axis)
    if x.shape[0] != n:
        raise ValueError(f"{op}: leading dim {x.shape[0]} != the {axis!r} "
                         f"axis size {n}")
    return n


def _transport(x: torch.Tensor, ctx, axis: str, impl: str) -> torch.Tensor:
    """(n_src, n_dst, C, ...) → (n_dst, n_src, C, ...)."""
    if impl == "xla" or ctx is None:
        return all_to_all_ref(x)
    return all_to_all(x, ctx=ctx, axis=axis)


def pre_attn_a2a(x: torch.Tensor, *, axis: str = "sp",
                 ctx: MeshContext = None, impl: str = "pallas") -> torch.Tensor:
    """(n, S_loc, H, hd) → (n, n·S_loc, H/n, hd)."""
    n = _ranks(x, ctx, axis, "pre_attn_a2a")
    _, s_loc, h, hd = x.shape
    if h % n:
        raise ValueError(f"heads {h} not divisible by sp={n}")
    h_loc = h // n
    # chunk r = the heads rank r owns.
    x = x.reshape(n, s_loc, n, h_loc, hd).transpose(1, 2).contiguous()
    out = _transport(x, ctx, axis, impl)  # (n, n_src, S_loc, h_loc, hd)
    return out.reshape(n, n * s_loc, h_loc, hd)


def post_attn_a2a(x: torch.Tensor, *, axis: str = "sp",
                  ctx: MeshContext = None,
                  impl: str = "pallas") -> torch.Tensor:
    """(n, S, H_loc, hd) → (n, S/n, n·H_loc, hd), the inverse of
    :func:`pre_attn_a2a`."""
    n = _ranks(x, ctx, axis, "post_attn_a2a")
    _, s, h_loc, hd = x.shape
    if s % n:
        raise ValueError(f"sequence {s} not divisible by sp={n}")
    s_loc = s // n
    x = x.reshape(n, n, s_loc, h_loc, hd)  # chunk r = rank r's seq slice
    out = _transport(x.contiguous(), ctx, axis, impl)  # by head owner
    return out.transpose(1, 2).reshape(n, s_loc, n * h_loc, hd)


def ulysses_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 axis: str = "sp", ctx: MeshContext = None,
                 impl: str = "pallas", causal: bool = True) -> torch.Tensor:
    """Ulysses attention on sequence-sharded q (n, S_loc, H, hd) and k/v
    (n, S_loc, KV, hd) → (n, S_loc, H, hd): the three head reshards, one
    attention over every rank's heads with the ranks as its batch
    (:func:`~triton_dist_tpu_torch.layers.tp_attn.sdpa`: the flash-attention
    kernel on a CUDA tensor when causal), the reshard back. The
    projections stay in the caller."""
    from triton_dist_tpu_torch.layers.tp_attn import sdpa

    qh = pre_attn_a2a(q, axis=axis, ctx=ctx, impl=impl)
    kh = pre_attn_a2a(k, axis=axis, ctx=ctx, impl=impl)
    vh = pre_attn_a2a(v, axis=axis, ctx=ctx, impl=impl)
    o = sdpa(qh, kh, vh, causal=causal)
    return post_attn_a2a(o, axis=axis, ctx=ctx, impl=impl)
