"""All-to-all over simulated ranks (counterpart of
``triton_dist_tpu/ops/all_to_all.py``: ``all_to_all_ref`` and
``all_to_all``; and of the ragged hop ``_ragged_a2a`` of
``triton_dist_tpu/ops/ep_a2a.py``, which JAX runs as
``lax.ragged_all_to_all`` on the TPU).

The ranks are the leading dimension (:mod:`~triton_dist_tpu_torch.parallel.
mesh`): ``x`` (n, n, C, ...) stacks every rank's per-shard (n, C, ...),
``x[s][d]`` being sender s's chunk for receiver d. :func:`all_to_all`
returns ``out`` (n, n, C, ...) with ``out[d][s] = x[s][d]``: receiver d's
slot s holds what sender s sent it. At one rank it returns ``x``, as JAX
does. On a CUDA tensor it is one cooperative launch of
``all_to_all_kernel`` (``csrc/all_to_all.cu``), every rank's thread blocks
running the JAX kernel's direct puts into the peer's slot, signals and
arrival waits; on a CPU tensor :func:`all_to_all_ref`. The rows may be of
any element type: the kernel moves bytes.

:func:`ragged_all_to_all` is the same kernel's ragged form, the drop-free
EP hop: each (sender, receiver) chunk has its own row count and offsets,
three (n, n) int32 matrices on the device, so only the real rows move and
nothing is read on the host; its plain version is JAX's index-copy
emulation of ``ragged_all_to_all`` (:func:`ragged_all_to_all_ref`).

JAX's ``force_kernel`` (the one-chip lowering check of its hardware
battery) has no counterpart: at one rank nothing crosses ranks.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

FAULTS = {"slot_off_by_one": 1, "lost_signal": 2}
ROW_BLOCK_BYTES = 64 << 10     # about what one work item of the kernel moves

# ``KERNEL.launches`` counts launches of the CUDA kernel (both forms),
# ``FORM_LAUNCHES`` the same launches by form.
FORM_LAUNCHES = {"dense": 0, "ragged": 0}
KERNEL = CudaKernel("all_to_all.cu", "tdt_all_to_all",
                    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                    + [ctypes.c_uint64] * 2 + [ctypes.c_int])


def all_to_all_ref(x: torch.Tensor, **_) -> torch.Tensor:
    """Plain version: (n, n, C, ...) → ``out[d][s] = x[s][d]``."""
    return x.transpose(0, 1).contiguous()


def _check_ranks(x: torch.Tensor, ctx: MeshContext, axis: str) -> int:
    n = ctx.size(axis)
    if x.shape[0] != n:
        raise ValueError(f"leading dim {x.shape[0]} != axis size {n}")
    return n


def _launch(src, out, mats, *, chunk_rows, out_rows, name, fault, timeout_s,
            check):
    """One launch of the kernel: ``src`` (n, rows, ...) every sender's
    rows, ``out`` (n, out_rows, ...) every receiver's; ``mats`` the ragged
    form's (in_off, sizes, out_off) or None (dense)."""
    n = src.shape[0]
    dev = src.device
    if dev.type != "cuda":
        raise RuntimeError(f"{name} runs on CUDA tensors (got {dev}); only "
                           "CPU tensors take the plain version")
    if out.device != dev or out.dtype != src.dtype:
        raise TypeError(f"{name}: out is {out.dtype} on {out.device}, the "
                        f"rows {src.dtype} on {dev}")
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError(f"{name}: the rows and out must be contiguous")
    row_bytes = src[0, 0].numel() * src.element_size()
    rb_rows = max(1, min(chunk_rows, ROW_BLOCK_BYTES // row_bytes))
    n_rb = -(-chunk_rows // rb_rows)
    ws = shmem.workspace("all_to_all", (chunk_rows, rb_rows), n=n,
                         n_flags=n * n * n_rb, device=dev)

    def describe(rank, step, slot):
        rb = slot % n_rb
        return (f"{name}: rank {rank} waited for row block {rb} of rank "
                f"{step}'s chunk (flag slot {slot}) past {timeout_s} s")

    ptrs = (None,) * 3 if mats is None else tuple(m.data_ptr() for m in mats)
    tp_gemm.launch(KERNEL, ws, describe, src.data_ptr(), out.data_ptr(),
                   *ptrs, src.stride(0) * src.element_size(),
                   out.stride(0) * out.element_size(), row_bytes, n,
                   chunk_rows, out_rows, rb_rows, device=dev,
                   timeout_s=timeout_s, fault=fault, check=check)
    FORM_LAUNCHES["dense" if mats is None else "ragged"] += 1
    return out


def all_to_all(x: torch.Tensor, *, ctx: MeshContext, axis: str = "ep",
               fault: int = 0, timeout_s: float = shmem.TIMEOUT_S,
               check: bool = False) -> torch.Tensor:
    """Per-rank all-to-all: ``x`` (n, n, C, ...), ``x[s][d]`` the chunk
    rank s sends rank d → (n, n, C, ...), ``out[d][s]`` the chunk rank d
    received from rank s (``ctx``'s ``axis`` has size n). ``fault`` (a
    value of :data:`FAULTS`), ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    n = _check_ranks(x, ctx, axis)
    if x.dim() < 3 or x.shape[1] != n:
        raise ValueError(f"x {tuple(x.shape)}: expected (n={n}, n, C, ...)")
    if n == 1:
        return x
    if x.device.type == "cpu":
        return all_to_all_ref(x)
    c = x.shape[2]
    if c == 0:
        return all_to_all_ref(x)
    # A planted fault leaves a slot unwritten: zeros keep it visible.
    out = torch.zeros_like(x) if fault else torch.empty_like(x)
    _launch(x.reshape(n, n * c, *x.shape[3:]),
            out.view(n, n * c, *x.shape[3:]), None, chunk_rows=c,
            out_rows=n * c, name="all_to_all", fault=fault,
            timeout_s=timeout_s, check=check)
    return out


def ragged_all_to_all_ref(operand: torch.Tensor, out: torch.Tensor,
                          in_off: torch.Tensor, sizes: torch.Tensor,
                          out_off: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ragged_all_to_all`: JAX's emulation of
    ``ragged_all_to_all`` off the TPU. Sender s's sorted row j belongs to
    the chunk of receiver ``d = searchsorted(in_off[s], j) - 1`` and moves
    when ``j - in_off[s, d] < sizes[s, d]``, to receiver d's row
    ``out_off[s, d] + j - in_off[s, d]``. Writes ``out`` in place."""
    n, rows = operand.shape[:2]
    r_rows = out.shape[1]
    j = torch.arange(rows, device=operand.device).expand(n, rows)
    dst = torch.clamp(torch.searchsorted(in_off.long().contiguous(), j.contiguous(),
                                         right=True) - 1, 0, n - 1)
    pos = j - torch.gather(in_off.long(), 1, dst)
    valid = pos < torch.gather(sizes.long(), 1, dst)
    tgt = torch.gather(out_off.long(), 1, dst) + pos
    flat = torch.where(valid, dst * r_rows + tgt, n * r_rows)
    tail = out.new_empty((1, *out.shape[2:]))
    buf = torch.cat([out.reshape(n * r_rows, *out.shape[2:]), tail])
    buf.index_copy_(0, flat.reshape(-1),
                    operand.reshape(n * rows, *operand.shape[2:]))
    out.copy_(buf[:-1].view(out.shape))
    return out


def ragged_all_to_all(operand: torch.Tensor, out: torch.Tensor,
                      in_off: torch.Tensor, sizes: torch.Tensor,
                      out_off: torch.Tensor, *, ctx: MeshContext,
                      axis: str = "ep", fault: int = 0,
                      timeout_s: float = shmem.TIMEOUT_S,
                      check: bool = False) -> torch.Tensor:
    """The ragged hop: ``operand`` (n, N, ...) every sender's rows sorted by
    receiver, ``out`` (n, R, ...) every receiver's buffer (rows nothing
    lands on keep their contents: the caller's fill); ``in_off``,
    ``sizes``, ``out_off`` (n, n) int32 [sender, receiver]: where each
    chunk starts among the sender's rows, its rows, where it lands among
    the receiver's. Returns ``out``, written in place. On a CUDA tensor one
    launch of the kernel's ragged form; on a CPU tensor
    :func:`ragged_all_to_all_ref`. ``fault``, ``timeout_s``, ``check`` as
    in :func:`all_to_all`."""
    n = _check_ranks(operand, ctx, axis)
    for name, m in (("in_off", in_off), ("sizes", sizes),
                    ("out_off", out_off)):
        if tuple(m.shape) != (n, n):
            raise ValueError(f"{name} {tuple(m.shape)} != {(n, n)}")
    if out.shape[0] != n or out.shape[2:] != operand.shape[2:]:
        raise ValueError(f"out {tuple(out.shape)} does not hold rows of "
                         f"operand {tuple(operand.shape)}")
    if operand.device.type == "cpu":
        return ragged_all_to_all_ref(operand, out, in_off, sizes, out_off)
    if operand.shape[1] == 0:
        return out
    for name, m in (("in_off", in_off), ("sizes", sizes),
                    ("out_off", out_off)):
        if (m.device != operand.device or m.dtype != torch.int32
                or not m.is_contiguous()):
            raise TypeError(f"{name} must be contiguous int32 on "
                            f"{operand.device}")
    return _launch(operand, out, (in_off, sizes, out_off),
                   chunk_rows=operand.shape[1], out_rows=out.shape[1],
                   name="ragged_all_to_all", fault=fault,
                   timeout_s=timeout_s, check=check)
