"""All-gather over simulated ranks (counterpart of
``triton_dist_tpu/ops/allgather.py``: ``all_gather_ref``, ``all_gather``
and ``all_gather_2d``).

The ranks are the leading dimension (:mod:`~triton_dist_tpu_torch.parallel.
mesh`): ``x`` (R, c, ...) stacks every rank's per-shard (c, ...), R being
every rank of the mesh. An op over one ``axis`` of size n runs in each
group of ranks that share their other coordinates, as JAX's collective
over one mesh axis does: rank r ends with its group's chunks in position
order, (R, n·c, ...). At one rank along the axis it returns ``x``, as
JAX does. On a CUDA tensor ``mode="ring"`` (row 1) is one cooperative
launch of ``all_gather_kernel`` (``csrc/collectives.cu``), every rank's
thread blocks running the JAX ring's puts, signals and arrival waits, and
``mode="full_mesh"`` (row 2) one launch of ``full_mesh_kernel``: each
rank copies its chunk into its own slot, puts it into its slot of each of
its n - 1 peers and waits for n - 1 arrivals, the ring's output bit for
bit. On a CPU tensor both take :func:`all_gather_ref`. The rows may be of
any element type: the kernels move bytes (the full mesh any byte count).

``all_gather_2d`` (row 3) raises: no engine path reaches it, and it is
ROADMAP.md queue B. JAX's ``force_kernel`` (its one-chip lowering check)
has no counterpart.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

MODES = ("ring", "full_mesh")
FAULTS = {"wrong_chunk": 1, "lost_signal": 2}

# ``KERNEL.launches`` counts launches of the ring kernel,
# ``KERNEL_FULL_MESH.launches`` those of the full-mesh one.
_ARGTYPES = tp_gemm.COLLECTIVE_ARGTYPES[:2] + tp_gemm.COLLECTIVE_ARGTYPES[3:]
KERNEL = CudaKernel("collectives.cu", "tdt_all_gather_ring", _ARGTYPES)
KERNEL_FULL_MESH = CudaKernel("collectives.cu", "tdt_all_gather_full_mesh",
                              _ARGTYPES)


def all_gather_ref(x: torch.Tensor, *, ctx: MeshContext,
                   axis: str = "tp") -> torch.Tensor:
    """Plain version: (R, c, ...) → (R, n·c, ...), rank r's group's chunks
    in position order."""
    n, st = tp_gemm.axis_groups(x, ctx, axis)
    v = tp_gemm.group_view(x, n, st)               # (A, n, st, c, ...)
    rest = tuple(x.shape[2:])
    g = v.movedim(1, 2).reshape(v.shape[0], st, n * x.shape[1], *rest)
    out = g.unsqueeze(1).expand(v.shape[0], n, st, n * x.shape[1], *rest)
    return out.reshape(x.shape[0], n * x.shape[1], *rest)


def all_gather(x: torch.Tensor, *, ctx: MeshContext, axis: str = "tp",
               mode: str = "ring", fault: int = 0,
               timeout_s: float = shmem.TIMEOUT_S,
               check: bool = False) -> torch.Tensor:
    """Every rank's all-gather of ``x`` (R, c, ...) along ``axis`` → (R,
    n·c, ...). ``fault`` (a value of :data:`FAULTS`), ``timeout_s`` and
    ``check`` as in :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    if mode not in MODES:
        raise ValueError(f"unknown all_gather mode {mode!r}")
    n, st = tp_gemm.axis_groups(x, ctx, axis)
    if n == 1:
        return x
    if x.device.type == "cpu":
        return all_gather_ref(x, ctx=ctx, axis=axis)
    c_bytes = x[0].numel() * x.element_size()
    out = (torch.zeros if fault else torch.empty)(
        (x.shape[0], n * x.shape[1], *x.shape[2:]), dtype=x.dtype,
        device=x.device)
    where = tp_gemm.hop_name(ctx, axis)

    if mode == "full_mesh":
        def describe(rank, step, slot, n_pc):
            src = ctx.device_id(axis, slot // n_pc % n, rank)
            return (f"all_gather full_mesh over {where}: rank {rank} waited "
                    f"for piece {slot % n_pc} of the chunk from rank {src} "
                    f"(flag slot {slot}) past {timeout_s} s")

        tp_gemm.launch_collective(KERNEL_FULL_MESH, x, out,
                                  chunk_bytes=c_bytes, n=n, st=st,
                                  flags_per_rank=n, slots=0, ctx=ctx,
                                  describe=describe, fault=fault,
                                  timeout_s=timeout_s, check=check,
                                  any_bytes=True)
        return out

    def describe(rank, step, slot, n_pc):
        return (f"all_gather ring over {where}: rank {rank} waited at ring "
                f"step {step} for piece {slot % n_pc} of the chunk from its "
                f"left neighbour (flag slot {slot}) past {timeout_s} s")

    tp_gemm.launch_collective(KERNEL, x, out, chunk_bytes=c_bytes, n=n,
                              st=st, flags_per_rank=n - 1, slots=0, ctx=ctx,
                              describe=describe, fault=fault,
                              timeout_s=timeout_s, check=check)
    return out


def all_gather_2d(x, *, ctx: MeshContext, inner_axis: str = "tp",
                  outer_axis: str = "dp", mode: str = "interleaved"):
    """The hierarchical all-gather (``_ring_2d_kernel``, row 3): no engine
    path reaches it; it raises."""
    raise ValueError("all_gather_2d (_ring_2d_kernel) is not ported yet "
                     "(ROADMAP.md queue B)")
