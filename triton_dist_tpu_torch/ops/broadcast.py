"""Broadcast over simulated ranks (counterpart of
``triton_dist_tpu/ops/broadcast.py``: ``broadcast_ref``, ``broadcast`` and
``broadcast_host``).

``x`` (R, ...) stacks every rank's buffer (:mod:`~triton_dist_tpu_torch.
parallel.mesh`); along ``axis`` every rank of a group ends with the buffer
of the group's rank at position ``root``. At one rank along the axis it
returns ``x``, as JAX does, and a root outside the axis raises with JAX's
message. On a CUDA tensor the op is one cooperative launch of row 32's
``p2p_kernel`` (``csrc/p2p.cu``) with an edge from the root to every
position, its own included (row 33): the root copies its buffer into its
own output and puts it into every peer's, signalling each, and every rank
waits for its pieces; on a CPU tensor :func:`broadcast_ref`.
The buffers may be of any element type and byte count. JAX's
``resilience.policy`` fallback has no counterpart (the port has no
``resilience/`` yet, ROADMAP.md queue A item 7, and no silent fallback).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops import p2p, tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

FAULTS = p2p.FAULTS

# ``KERNEL.launches`` counts the launches of ``p2p_kernel`` made for the
# broadcast (row 33), apart from :func:`~triton_dist_tpu_torch.ops.p2p.
# p2p_put`'s (row 32).
KERNEL = CudaKernel("p2p.cu", "tdt_p2p_put", p2p.ARGTYPES)


def check_root(root: int, n: int) -> int:
    """JAX's root check (:59-60)."""
    if not 0 <= int(root) < n:
        raise ValueError(f"root={root} out of range for axis size {n}")
    return int(root)


def broadcast_ref(x: torch.Tensor, root: int = 0, *, ctx: MeshContext,
                  axis: str = "tp") -> torch.Tensor:
    """Plain version: every rank of a group takes a copy of the root's
    buffer."""
    n, st = tp_gemm.axis_groups(x, ctx, axis)
    root = check_root(root, n)
    v = tp_gemm.group_view(x, n, st)
    return v[:, root:root + 1].expand(v.shape).contiguous().view(x.shape)


def broadcast(x: torch.Tensor, root: int = 0, *, ctx: MeshContext,
              axis: str = "tp", fault: int = 0,
              timeout_s: float = shmem.TIMEOUT_S,
              check: bool = False) -> torch.Tensor:
    """Every rank's copy of the root's ``x`` (R, ...) along ``axis`` → (R,
    ...). ``fault`` (a value of :data:`FAULTS`), ``timeout_s`` and
    ``check`` as in :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    n, st = tp_gemm.axis_groups(x, ctx, axis)
    root = check_root(root, n)
    if n == 1:
        return x
    if x.device.type == "cpu":
        return broadcast_ref(x, root, ctx=ctx, axis=axis)
    return p2p.put_table(KERNEL, "broadcast", x, [root] * n, ctx=ctx,
                         axis=axis, what="broadcast",
                         source="the root, rank", fault=fault,
                         timeout_s=timeout_s, check=check)


def broadcast_host(x: torch.Tensor, root: int = 0, *, mesh: MeshContext,
                   axis: str = "tp") -> torch.Tensor:
    """JAX's host-level :func:`broadcast`: on stacked ranks the op itself,
    taking the mesh."""
    return broadcast(x, root, ctx=mesh, axis=axis)
