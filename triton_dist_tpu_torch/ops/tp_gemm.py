"""What the tensor-parallel ops share: the fused GEMMs
(:mod:`~triton_dist_tpu_torch.ops.ag_gemm`,
:mod:`~triton_dist_tpu_torch.ops.gemm_rs`,
:mod:`~triton_dist_tpu_torch.ops.gemm_ar`) and the collectives
(:mod:`~triton_dist_tpu_torch.ops.allgather`,
:mod:`~triton_dist_tpu_torch.ops.reduce_scatter`,
:mod:`~triton_dist_tpu_torch.ops.allreduce`): the fp32 product of the
plain versions, the weight-shard views, the axis and operand checks, the
group view of an operand along one axis and the launch through a
symmetric workspace.

Operands carry the simulated ranks as their leading dimension
(:mod:`~triton_dist_tpu_torch.parallel.mesh`). Weights are stored
``(out, in)`` as everywhere in the port; rank r's shard of a
column-parallel weight ``(out, in)`` is rows ``[r·out/n, (r+1)·out/n)``,
of a row-parallel one columns ``[r·in/n, (r+1)·in/n)``, as the JAX
``param_specs`` shard them. Both are views of the one full weight
(:func:`column_shards`, :func:`row_shards`): no copy is made, and the
kernels take the row pitch of the strided row-parallel view. Over an
``(outer, inner)`` tuple axis n = n_o·n_in and rank r = o·n_in + i takes
block r, as ``P(("dp", "tp"))`` cuts a dimension outer-major: the views
are the flat tp = n ones.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.parallel.mesh import axis_names
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel, load


def column_shards(w: torch.Tensor, n: int) -> torch.Tensor:
    """(out, in) → (n, out/n, in): rank r's rows, a view."""
    if w.shape[0] % n:
        raise ValueError(f"{w.shape[0]} output features not divisible by "
                         f"tp={n}")
    return w.view(n, w.shape[0] // n, w.shape[1])


def row_shards(w: torch.Tensor, n: int) -> torch.Tensor:
    """(out, in) → (n, out, in/n): rank r's columns, a strided view."""
    if w.shape[1] % n:
        raise ValueError(f"{w.shape[1]} input features not divisible by "
                         f"tp={n}")
    return w.view(w.shape[0], n, w.shape[1] // n).permute(1, 0, 2)


def mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 ``x @ w.T`` of 2-D operands: on the card bf16 products
    accumulate in fp32 in one ``mm`` (``preferred_element_type=float32``
    of the JAX package); elsewhere in fp32."""
    if x.is_cuda and x.dtype != torch.float32:
        return torch.mm(x, w.t(), out_dtype=torch.float32)
    return F.linear(x.float(), w.float())


def check_axis(op: str, mesh, axis, *, groups: bool = False) -> None:
    """``axis`` is one mesh axis or an ``(outer, inner)`` pair of them
    that spans every rank of ``mesh``. ``groups``: a single axis may span
    part of the mesh (the op runs in each group along it, as GEMM+AR's
    inner hop does); otherwise the other ranks would be data-parallel
    replicas, which are not ported. A pair names two axes in the mesh's
    order: the ranks are stacked outer-major over that order, so the
    pair's flat rank o·n_in + i is the operand's leading index."""
    names = axis_names(axis)
    if len(names) > 2 or any(a not in mesh.axes for a in names):
        raise ValueError(f"{op}: axis {axis!r} is not one mesh axis of "
                         f"{mesh.axes} or an (outer, inner) pair of them")
    if len(names) == 2 and not (mesh.axes.index(names[0])
                                < mesh.axes.index(names[1])):
        raise ValueError(f"{op}: axis {axis!r} must name two different mesh "
                         f"axes, the outer one first in the mesh's order "
                         f"{mesh.axes}")
    if mesh.size(axis) != mesh.n_ranks and not (groups and len(names) == 1):
        raise ValueError(
            f"{op} over axis {axis!r} spans {mesh.size(axis)} of the mesh's "
            f"{mesh.n_ranks} ranks: data-parallel replicas over the other "
            "axes are not ported (ROADMAP.md queue A item 4); shard over "
            "every axis, e.g. axis=('dp', 'tp')")


def axis_groups(x: torch.Tensor, ctx, axis: str):
    """``(n, stride)`` of ``axis`` after checking that ``x`` carries every
    rank of ``ctx`` as its leading dimension."""
    if not isinstance(axis, str):
        raise ValueError(f"axis {axis!r}: one mesh axis (the hierarchical "
                         "forms compose two single-axis calls)")
    if x.dim() < 2 or x.shape[0] != ctx.n_ranks:
        raise ValueError(f"x {tuple(x.shape)}: expected (R={ctx.n_ranks}, "
                         "c, ...), every rank of the mesh")
    return ctx.size(axis), ctx.stride(axis)


def group_view(x: torch.Tensor, n: int, st: int) -> torch.Tensor:
    """(R, ...) → (R/(n·st), n, st, ...): dimension 1 walks a group's
    positions along the axis."""
    return x.view(x.shape[0] // (n * st), n, st, *x.shape[1:])


def hop_name(ctx, axis: str) -> str:
    """How an error names the hop: the axis, outer when a nontrivial axis
    lies inside it."""
    return (f"axis {axis!r} ({'outer' if ctx.stride(axis) > 1 else 'inner'}"
            " hop)")


def check_operands(op: str, a: torch.Tensor, b: torch.Tensor,
                   out_dtype) -> None:
    """The kernels take bf16 ``a (n, rows, K)`` contiguous and bf16
    ``b (n, N, K)`` with unit stride along K and 16-byte aligned rows."""
    dev = a.device
    if dev.type != "cuda":
        raise RuntimeError(f"{op} runs on CUDA tensors (got {dev}); only "
                           "CPU tensors take the plain version")
    for t in (a, b):
        if t.device != dev or t.dtype != torch.bfloat16:
            raise TypeError(f"{op}: expected bf16 tensors on {dev}, got "
                            f"{t.dtype} on {t.device}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"{op}: the kernel writes bf16 (out_dtype "
                        f"{out_dtype})")
    if not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError(f"{op}: a must be contiguous and 16-byte aligned")
    if (b.stride(2) != 1 or b.stride(1) % 8 or b.stride(0) % 8
            or b.data_ptr() % 16 or a.shape[2] % 8):
        raise ValueError(f"{op}: b needs unit stride along K, 16-byte "
                         "aligned rows and K a multiple of 8")


def check_cuda(op: str, *tensors) -> None:
    """The bf16 operands of a kernel on one CUDA device, unit stride along
    the last dim, 16-byte aligned rows and strides; a tensor elsewhere
    raises (only CPU tensors take the plain version)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{op} runs on CUDA tensors (got {dev}); only "
                           "CPU tensors take the plain version")
    for t in tensors:
        if t.device != dev or t.dtype != torch.bfloat16:
            raise TypeError(f"{op}: expected bf16 tensors on {dev}, got "
                            f"{t.dtype} on {t.device}")
        if t.data_ptr() % 16 or t.stride(-1) != 1 or any(
                s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"{op}: operands need unit stride along the "
                             "last dim, 16-byte aligned rows and strides")


def tile(kernel: CudaKernel, rows: int) -> tuple:
    """The output tile (rows, columns) ``kernel`` runs for ``rows`` rows
    per rank (``csrc/tile_gemm.cuh``: the decode tile up to 16 rows)."""
    fn = load(kernel.source).tdt_tp_tile
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 2)()
    fn(rows, out)
    return out[0], out[1]


def launch(kernel: CudaKernel, ws: shmem.Workspace, describe, *args,
           device: torch.device, timeout_s: float, fault: int,
           check: bool, tail: tuple = ()) -> None:
    """One launch of a fused op's kernel on ``ws`` with a new epoch: an
    earlier launch's timed-out wait raises first; ``check`` waits for this
    one and raises if one of its waits timed out. ``describe(rank, step,
    slot)`` names a flag slot of this launch; ``tail``: the launcher's
    arguments after ``fault``."""
    if timeout_s <= 0:
        raise ValueError(f"timeout_s={timeout_s} must be positive")
    shmem.check_errors(device, sources=(kernel.source,))
    epoch = ws.next_epoch()
    shmem.watch(kernel.source, epoch, describe)
    kernel.launch(*args, ws.flags.data_ptr(), ws.abort_ptr, epoch,
                  int(timeout_s * 1e9), fault, *tail, device=device)
    if check:
        shmem.check_errors(device, sync=True, sources=(kernel.source,))


# The ``collectives.cu`` entry points: (x, out, slots, chunk_bytes, R, n,
# stride, flags, abort, epoch, timeout_ns, fault); the all-gather has no
# slots.
COLLECTIVE_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                       + [ctypes.c_uint64] * 2 + [ctypes.c_int])
PIECE_BYTES = 8192      # bytes a work item of the kernels moves (kPieceVecs)


def launch_collective(kernel: CudaKernel, x, out, *, chunk_bytes: int,
                      n: int, st: int, flags_per_rank: int, slots: int, ctx,
                      describe, fault: int, timeout_s: float,
                      check: bool, any_bytes: bool = False,
                      tail: tuple = ()) -> None:
    """One launch of a ``collectives.cu`` entry point on CUDA tensors:
    contiguous 16-byte aligned rows, chunks a multiple of 16 bytes (with
    ``any_bytes``, the byte-granular kernels: contiguous, any chunk size).
    ``flags_per_rank`` flags a rank per 8 KiB piece of a chunk; ``slots``
    chunks a rank of persistent receive or gather slots (0: none).
    ``describe(rank, step, slot, pieces)`` names a flag slot; ``tail``:
    the launcher's arguments after ``fault``."""
    dev = x.device
    if dev.type != "cuda":
        raise RuntimeError(f"{kernel.symbol} runs on CUDA tensors (got "
                           f"{dev}); only CPU tensors take the plain version")
    for t in (x, out):
        if (not t.is_contiguous() or t.device != dev
                or (t.data_ptr() % 16 and not any_bytes)):
            raise ValueError(f"{kernel.symbol}: operands must be contiguous "
                             f"and 16-byte aligned on {dev}")
    if chunk_bytes == 0 or (chunk_bytes % 16 and not any_bytes):
        raise ValueError(f"{kernel.symbol}: a chunk of {chunk_bytes} bytes "
                         "(a multiple of 16 is needed)")
    n_pc = -(-chunk_bytes // PIECE_BYTES)
    ws = shmem.workspace(kernel.symbol, (chunk_bytes, n, st), n=ctx.n_ranks,
                         device=dev, n_flags=ctx.n_ranks * flags_per_rank * n_pc,
                         data_shape=(slots, chunk_bytes) if slots else None,
                         data_dtype=torch.uint8)
    args = [x.data_ptr(), out.data_ptr()]
    if slots:
        args.append(ws.data.data_ptr())
    launch(kernel, ws, lambda r, s, f: describe(r, s, f, n_pc), *args,
           chunk_bytes, ctx.n_ranks, n, st, device=dev, timeout_s=timeout_s,
           fault=fault, check=check, tail=tail)
