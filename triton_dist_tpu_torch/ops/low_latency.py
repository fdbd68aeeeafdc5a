"""The low-latency all-to-all with the quantization on the wire
(counterpart of the wire half of ``triton_dist_tpu/ops/low_latency.py``:
``wire_max``, ``quantize_rows``, ``wire_roundtrip`` and ``ll_a2a``).

:func:`ll_a2a` takes the ranks as its leading dimension
(:mod:`~triton_dist_tpu_torch.parallel.mesh`): ``x`` (n, n, C, d), ``x[s]
[d]`` the chunk rank s sends rank d, and returns (n, n, C, d), ``out[d][s]``
what rank d received from rank s, each row quantized on the way (int8 or
fp8 e4m3 codes and an fp32 per-row scale, :func:`quantize_rows`) and
dequantized on arrival into ``x``'s dtype. On a CUDA tensor it is one
cooperative launch of ``ll_a2a_kernel`` (``csrc/ll_a2a.cu``): every rank's
blocks quantize their chunks straight into the receiver's inbound slot
(the slot parity is ``step % 2``, as in JAX), signal, and the receiver's
blocks wait and dequantize. The inbound slots (two parities of codes and
scales) persist in the op's workspace; each call's epoch keeps calls of
one parity apart. On a CPU tensor it runs :func:`ll_a2a_ref`:
quantize, transpose, dequantize. At one rank it is the wire round trip,
as JAX's ``n == 1`` form.

``fast_allgather`` and ``ll_a2a_steps`` (rows 22 and 24) have no caller on
the port's paths and are not ported yet (ROADMAP.md queue A item 5); nor is
JAX's ``force_kernel`` (a one-chip lowering check).
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

FAULTS = {"wrong_parity": 1, "lost_signal": 2, "wrong_scale_row": 3}
WIRE_DTYPES = (torch.int8, torch.float8_e4m3fn)
ROWS_PER_ITEM = 8              # csrc/ll_a2a.cu kRows: one warp a row

# ``KERNEL.launches`` counts launches of the CUDA kernel.
KERNEL = CudaKernel("ll_a2a.cu", "tdt_ll_a2a",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p] * 2 + [ctypes.c_uint64] * 2
                    + [ctypes.c_int])


def wire_max(dtype) -> float:
    """Largest representable magnitude of the wire dtype."""
    if dtype == torch.int8:
        return 127.0
    return float(torch.finfo(dtype).max)


def quantize_rows(v: torch.Tensor, wire_dtype):
    """Per-row absmax quantization: v (…, d) float → (codes, scale (…, 1)
    fp32). JAX's recipe: ``scale = max(absmax / wire_max, 1e-12)``, codes
    ``v / scale`` (a true division), rounded half to even for int8."""
    v = v.float()
    amax = v.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor: PyTorch multiplies by the reciprocal of a Python
    # scalar divisor on the card, which rounds differently.
    scale = torch.clamp_min(amax / torch.full_like(amax, wire_max(wire_dtype)),
                            1e-12)
    q = v / scale
    if wire_dtype == torch.int8:
        q = torch.round(q)
    return q.to(wire_dtype), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype) -> torch.Tensor:
    """``(q · scale)`` in fp32, rounded once to ``dtype``."""
    return (q.float() * scale).to(dtype)


def wire_roundtrip(x: torch.Tensor, wire_dtype) -> torch.Tensor:
    """Quantize + immediately dequantize (the one-rank form)."""
    q, scale = quantize_rows(x, wire_dtype)
    return dequantize_rows(q, scale, x.dtype)


def ll_a2a_ref(x: torch.Tensor, wire_dtype=torch.int8) -> torch.Tensor:
    """Plain version: every row's wire round trip, then the all-to-all's
    transpose over the two rank dimensions."""
    return wire_roundtrip(x, wire_dtype).transpose(0, 1).contiguous()


def ll_a2a(x: torch.Tensor, *, ctx: MeshContext, axis: str = "ep", step=0,
           wire_dtype=torch.int8, fault: int = 0,
           timeout_s: float = shmem.TIMEOUT_S,
           check: bool = False) -> torch.Tensor:
    """Slot-parity low-latency all-to-all with the quantization in the
    kernel: ``x`` (n, n, C, d) → (n, n, C, d) (module docstring); ``step``
    is the caller's step counter, whose parity picks the inbound slot;
    ``wire_dtype`` torch.int8 or torch.float8_e4m3fn. ``fault`` (a value of
    :data:`FAULTS`), ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    n = ctx.size(axis)
    if x.shape[0] != n:
        raise ValueError(f"leading dim {x.shape[0]} != axis size {n}")
    if x.dim() != 4 or x.shape[1] != n:
        raise ValueError(f"x {tuple(x.shape)}: expected (n={n}, n, C, d)")
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype {wire_dtype}: one of {WIRE_DTYPES}")
    _, _, c, d = x.shape
    parity = int(step) % 2
    if n == 1:
        return wire_roundtrip(x, wire_dtype)
    if x.device.type == "cpu":
        return ll_a2a_ref(x, wire_dtype)
    dev = x.device
    if dev.type != "cuda":
        raise RuntimeError(f"ll_a2a runs on CUDA tensors (got {dev}); only "
                           "CPU tensors take the plain version")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or d % 8:
        raise ValueError("ll_a2a: x must be contiguous bf16 with d a "
                         f"multiple of 8 (got {x.dtype}, d={d})")
    if c == 0:
        return torch.empty_like(x)
    n_rb = -(-c // ROWS_PER_ITEM)
    ws = shmem.workspace(
        "ll_a2a", (c, d, str(wire_dtype)), n=n, n_flags=n * 2 * n * n_rb,
        device=dev, buffers={"q": ((2, n, c, d), torch.uint8),
                             "scale": ((2, n, c), torch.float32)})
    out = torch.empty_like(x)

    def describe(rank, step_, slot):
        rb = slot % n_rb
        return (f"ll_a2a: rank {rank} waited for row block {rb} of rank "
                f"{step_}'s chunk at parity {parity} (flag slot {slot}) past "
                f"{timeout_s} s")

    tp_gemm.launch(KERNEL, ws, describe, x.data_ptr(), out.data_ptr(),
                   ws.buffers["q"].data_ptr(), ws.buffers["scale"].data_ptr(),
                   n, c, d, parity, int(wire_dtype != torch.int8),
                   device=dev, timeout_s=timeout_s, fault=fault, check=check)
    return out
