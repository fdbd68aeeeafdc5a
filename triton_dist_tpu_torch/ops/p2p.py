"""Point-to-point puts over simulated ranks (counterpart of
``triton_dist_tpu/ops/p2p.py``: ``ppermute_ref``, ``p2p_put``,
``p2p_put_host``, ``migrate_pages_host`` and ``tier_pages_host``).

The ranks are the leading dimension (:mod:`~triton_dist_tpu_torch.parallel.
mesh`): ``x`` (R, ...) stacks every rank's buffer. ``perm`` is a static
list of ``(src, dst)`` positions along ``axis``; in each group of ranks
along it, the rank at ``dst`` ends with the buffer of the rank at
``src``, and a rank that receives nothing ends with zeros, as
``lax.ppermute`` has it. A source may feed several edges (a multicast
forward, which JAX's kernel allows and ``lax.ppermute`` does not); a
destination named twice raises (JAX's kernel would race its puts there,
and ``lax.ppermute`` rejects it). On a CUDA tensor the op is one
cooperative launch of ``p2p_kernel`` (``csrc/p2p.cu``, row 32), every
source rank's thread blocks putting its buffer into its destinations'
outputs and signalling, every destination waiting for its pieces; on a
CPU tensor :func:`ppermute_ref`. The buffers may be of any element type
and byte count: the kernel moves bytes.

JAX's custom VJP (the put along the inverted permutation) waits for the
training slice: a tensor that requires grad raises. The page moves of
disaggregated serving and the KV tiers (``migrate_pages_host``,
``tier_pages_host``) raise, naming ROADMAP.md queue A item 7, whose
serving modules they belong to. JAX's ``resilience.policy`` fallback has
no counterpart: the port has no silent fallback.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

FAULTS = {"wrong_source": 1, "lost_signal": 2}
MAX_AXIS = 64            # positions the kernel's edge table holds (kMaxAxis)

# (x, out, c_bytes, R, n, st, src_of, flags, abort, epoch, timeout_ns, fault)
ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 3 + [ctypes.c_uint64] * 2 + [ctypes.c_int])

# ``KERNEL.launches`` counts launches of the CUDA kernel.
KERNEL = CudaKernel("p2p.cu", "tdt_p2p_put", ARGTYPES)


def check_perm(perm: Sequence[Tuple[int, int]], n: int) -> tuple:
    """``perm`` as a tuple of int pairs, each position in ``range(n)`` and
    no destination twice."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    seen = set()
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"p2p edge ({s}, {d}) out of range for axis "
                             f"size {n}")
        if d in seen:
            raise ValueError(f"p2p: destination {d} is named twice in "
                             f"{perm} (its puts would race; lax.ppermute "
                             "rejects it too)")
        seen.add(d)
    return perm


def ppermute_ref(x: torch.Tensor, perm: Sequence[Tuple[int, int]], *,
                 ctx: MeshContext, axis: str = "pp") -> torch.Tensor:
    """Plain version: in each group along ``axis`` the rank at ``dst``
    takes the buffer of the rank at ``src``; the others take zeros."""
    n, st = tp_gemm.axis_groups(x, ctx, axis)
    perm = check_perm(perm, n)
    v = tp_gemm.group_view(x, n, st)
    out = torch.zeros_like(v)
    for s, d in perm:
        out[:, d] = v[:, s]
    return out.view(x.shape)


def p2p_put(x: torch.Tensor, perm: Sequence[Tuple[int, int]], *,
            ctx: MeshContext, axis: str = "pp", fault: int = 0,
            timeout_s: float = shmem.TIMEOUT_S,
            check: bool = False) -> torch.Tensor:
    """One-sided puts of ``x`` (R, ...) along the static permutation
    ``perm`` of positions on ``axis`` → (R, ...). ``fault`` (a value of
    :data:`FAULTS`), ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    n, st = tp_gemm.axis_groups(x, ctx, axis)
    perm = check_perm(perm, n)
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "p2p_put's VJP (the put along the inverted permutation) waits "
            "for the training slice; pass a tensor that does not require "
            "grad, or impl='xla' to the pipeline layers")
    if x.device.type == "cpu":
        return ppermute_ref(x, perm, ctx=ctx, axis=axis)
    src_of = [-1] * n
    for s, d in perm:
        src_of[d] = s
    return put_table(KERNEL, "p2p", x, src_of, ctx=ctx, axis=axis,
                     what="p2p_put", source="source rank", fault=fault,
                     timeout_s=timeout_s, check=check)


def put_table(kernel: CudaKernel, op: str, x: torch.Tensor, src_of: list,
              *, ctx: MeshContext, axis: str, what: str, source: str,
              fault: int, timeout_s: float, check: bool) -> torch.Tensor:
    """One launch of ``p2p_kernel`` on the CUDA tensor ``x`` (R, ...):
    ``src_of[d]``, the source position of destination position ``d`` (or
    -1: zeros). ``kernel`` counts the launch and ``op`` names the
    workspace, so the ops that launch the table (:func:`p2p_put`, the
    broadcast) keep their own counts and flags; ``what`` and ``source``
    name the op and a wait's source rank in a timeout."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{what} runs on CUDA tensors (got {x.device}); "
                           "only CPU tensors take the plain version")
    n, st = ctx.size(axis), ctx.stride(axis)
    if n > MAX_AXIS:
        raise ValueError(f"{what}: the kernel takes at most {MAX_AXIS} "
                         f"positions along the axis (got {n})")
    x = x.contiguous()
    out = torch.empty_like(x)
    c_bytes = x[0].numel() * x.element_size()
    if c_bytes == 0:
        return out
    table = (ctypes.c_int * n)(*src_of)
    n_pc = -(-c_bytes // tp_gemm.PIECE_BYTES)
    ws = shmem.workspace(op, (c_bytes, n, st), n=ctx.n_ranks,
                         device=x.device, n_flags=ctx.n_ranks * n_pc)
    where = tp_gemm.hop_name(ctx, axis)

    def describe(rank, step, slot):
        return (f"{what} over {where}: rank {rank} waited for piece "
                f"{slot % n_pc} from {source} "
                f"{ctx.device_id(axis, step, rank)} (flag slot {slot}) past "
                f"{timeout_s} s")

    tp_gemm.launch(kernel, ws, describe, x.data_ptr(), out.data_ptr(),
                   c_bytes, ctx.n_ranks, n, st, table, device=x.device,
                   timeout_s=timeout_s, fault=fault, check=check)
    return out


def p2p_put_host(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
                 mesh: MeshContext, *, axis: str = "pp") -> torch.Tensor:
    """JAX's host-level :func:`p2p_put`: on stacked ranks the op itself,
    taking the mesh."""
    return p2p_put(x, perm, ctx=mesh, axis=axis)


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name}: KV page moves belong to disaggregated serving and the KV "
        "tiers (serving/disagg.py, serving/tiers.py), ROADMAP.md queue A "
        "item 7; their transport, p2p_put (row 32), is ported")


def migrate_pages_host(k_payload, v_payload, mesh, *, axis: str = "role",
                       src: int = 0, dst: int = 1, retry=None):
    """JAX's KV page migration between serving roles: raises (queue A
    item 7)."""
    _not_ported("migrate_pages_host")


def tier_pages_host(k_payload, v_payload, mesh, *, axis: str = "role",
                    src: int = 0, dst: int = 1, retry=None):
    """JAX's KV tier transition: raises (queue A item 7)."""
    _not_ported("tier_pages_host")
