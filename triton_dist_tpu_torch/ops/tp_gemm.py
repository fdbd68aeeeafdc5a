"""What the three fused tensor-parallel GEMM ops share
(:mod:`~triton_dist_tpu_torch.ops.ag_gemm`,
:mod:`~triton_dist_tpu_torch.ops.gemm_rs`,
:mod:`~triton_dist_tpu_torch.ops.gemm_ar`): the fp32 product of their
plain versions, the weight-shard views, the operand checks and the launch
through a symmetric workspace.

Operands carry the simulated ranks as their leading dimension
(:mod:`~triton_dist_tpu_torch.parallel.mesh`). Weights are stored
``(out, in)`` as everywhere in the port; rank r's shard of a
column-parallel weight ``(out, in)`` is rows ``[r·out/n, (r+1)·out/n)``,
of a row-parallel one columns ``[r·in/n, (r+1)·in/n)``, as the JAX
``param_specs`` shard them. Both are views of the one full weight
(:func:`column_shards`, :func:`row_shards`): no copy is made, and the
kernels take the row pitch of the strided row-parallel view.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

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
           check: bool) -> None:
    """One launch of a fused op's kernel on ``ws`` with a new epoch: an
    earlier launch's timed-out wait raises first; ``check`` waits for this
    one and raises if one of its waits timed out. ``describe(rank, step,
    slot)`` names a flag slot of this launch."""
    if timeout_s <= 0:
        raise ValueError(f"timeout_s={timeout_s} must be positive")
    shmem.check_errors(device, sources=(kernel.source,))
    epoch = ws.next_epoch()
    shmem.watch(kernel.source, epoch, describe)
    kernel.launch(*args, ws.flags.data_ptr(), ws.abort_ptr, epoch,
                  int(timeout_s * 1e9), fault, device=device)
    if check:
        shmem.check_errors(device, sync=True, sources=(kernel.source,))
