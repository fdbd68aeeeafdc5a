"""The MoE combine epilogue (counterpart of
``triton_dist_tpu/ops/moe_reduce.py``: ``moe_reduce_rs``,
``moe_reduce_rs_ref``, ``moe_reduce_ar`` and ``moe_reduce_ar_ref``).

At one rank (``y`` (T, K, d)) the reduce-scatter and the all-reduce are
the identity, and JAX's ``n == 1`` form of both is the fp32 weighted
top-k combine in XLA; here it is the same combine in PyTorch.

Over n simulated ranks (:mod:`~triton_dist_tpu_torch.parallel.mesh`) ``y``
(n, T, K, d) stacks every rank's partial expert outputs (its ffn shard's)
and ``w`` (n, T, K) every rank's top-k weights (fp32; a view that repeats
one copy does). :func:`moe_reduce_rs` leaves rank r the combined sum over
ranks of tokens ``[r·T/n, (r+1)·T/n)``, ``(n, T/n, d)``;
:func:`moe_reduce_ar` leaves every rank the whole sum, ``(n, T, d)``. On
a CUDA tensor each is one launch of ``csrc/moe_reduce.cu``
(``moe_reduce_rs_kernel``: the ring of JAX's ``_moe_rs_kernel``, row 21;
``moe_reduce_ar_kernel``: the one-shot push and reduce of
``_moe_ar_kernel``, row 20), every rank's thread blocks in one
cooperative launch; on a CPU tensor the plain versions. Both sum in fp32
and round once: the reduce-scatter adds a chunk's partials in the ring's
order (ranks c+1, c+2, ..., c), the all-reduce in rank order.

JAX's block knobs keep their divisor snapping (a row and column tile
that divide T/n and d); the kernels take the snapped tile, cut to at
most 16 rows and 256 columns so that enough items run at once.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

FAULTS = {"wrong_chunk": 1, "lost_signal": 2, "wrong_weight": 3}
TILE_ROWS, TILE_COLS = 16, 256       # the kernels' largest item tile

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
         + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
         + [ctypes.c_uint64] * 2 + [ctypes.c_int])
# ``launches`` counts launches of each CUDA kernel.
RS_KERNEL = CudaKernel("moe_reduce.cu", "tdt_moe_reduce_rs_bf16", _ARGS)
AR_KERNEL = CudaKernel("moe_reduce.cu", "tdt_moe_reduce_ar_bf16", _ARGS)


def _combine(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 ``sum_k w[..., t, k] · y[..., t, k, :]``."""
    return torch.einsum("...tkd,...tk->...td", y.float(), w.float())


def _check(y: torch.Tensor, w: torch.Tensor):
    t, k, _ = y.shape[-3:]
    if tuple(w.shape[-2:]) != (t, k) or w.dim() != y.dim() - 1:
        raise ValueError(f"weights {tuple(w.shape[-2:])} != {(t, k)}")
    return t


def _snap(block: int, size: int) -> int:
    """JAX's snapping: clamp to ``size``, halve until it divides."""
    b = min(block, size)
    while b > 1 and size % b:
        b //= 2
    return b


def moe_reduce_rs_ref(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version over ranks: each rank's fp32 combine; chunk c's sum
    taken in the ring's order (rank c+1's partial first, rank c's last),
    rounded once to ``y.dtype``. (n, T, K, d), (n, T, K) → (n, T/n, d)."""
    n, t = y.shape[0], y.shape[1]
    t_loc = t // n
    parts = _combine(y, w)                      # (n, T, d)
    out = []
    for c in range(n):
        acc = None
        for s in range(n):
            p = parts[(c + s + 1) % n, c * t_loc:(c + 1) * t_loc]
            acc = p if acc is None else p + acc
        out.append(acc)
    return torch.stack(out).to(y.dtype)


def moe_reduce_ar_ref(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version over ranks: each rank's fp32 combine, summed in rank
    order and rounded once; every rank's copy. (n, T, K, d), (n, T, K) →
    (n, T, d)."""
    parts = _combine(y, w)
    acc = parts[0]
    for r in range(1, y.shape[0]):
        acc = acc + parts[r]
    return acc.to(y.dtype).expand(y.shape[0], *acc.shape)


def _launch(kernel: CudaKernel, op: str, y, w, out, buf, *, n, t, tm, tn,
            ws, describe, fault, timeout_s, check) -> None:
    dev = y.device
    if dev.type != "cuda":
        raise RuntimeError(f"{op} runs on CUDA tensors (got {dev}); only CPU "
                           "tensors take the plain version")
    if y.dtype != torch.bfloat16 or y.device != dev:
        raise TypeError(f"{op}: y must be bf16 on {dev} (got {y.dtype} on "
                        f"{y.device})")
    if w.dtype != torch.float32 or w.device != dev:
        raise TypeError(f"{op}: w must be fp32 on {dev} (got {w.dtype} on "
                        f"{w.device})")
    k, d = y.shape[2], y.shape[3]
    if (y[0].stride() != (k * d, d, 1) or y.stride(0) % 8 or d % 8
            or y.data_ptr() % 16):
        raise ValueError(f"{op}: each rank's y must be contiguous (T, K, d), "
                         "16-byte aligned at a rank stride and d a multiple "
                         "of 8")
    if w[0].stride() != (k, 1):
        raise ValueError(f"{op}: each rank's w must be contiguous (T, K)")
    tp_gemm.launch(kernel, ws, describe, y.data_ptr(), w.data_ptr(),
                   out.data_ptr(), buf.data_ptr(), y.stride(0), w.stride(0),
                   n, t, k, d, tm, tn, device=dev, timeout_s=timeout_s,
                   fault=fault, check=check)


def moe_reduce_rs(y: torch.Tensor, w: torch.Tensor, *,
                  ctx: Optional[MeshContext] = None, axis: str = "tp",
                  block_m: int = 128, block_n: int = 512, fault: int = 0,
                  timeout_s: float = shmem.TIMEOUT_S,
                  check: bool = False) -> torch.Tensor:
    """Fused weighted combine + reduce-scatter. One rank: y (T, K, d)
    expert outputs in slot order, w (T, K) top-k weights → (T, d) in
    ``y.dtype``, summed in fp32. Ranks (``ctx``'s ``axis`` of size n): y
    (n, T, K, d), w (n, T, K) → (n, T/n, d). ``fault`` (a value of
    :data:`FAULTS`), ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`."""
    t = _check(y, w)
    if y.dim() == 3:
        return _combine(y, w).to(y.dtype)
    n = ctx.size(axis) if ctx is not None else y.shape[0]
    if y.shape[0] != n:
        raise ValueError(f"y {tuple(y.shape)}: expected (n={n}, T, K, d)")
    if t % n:
        raise ValueError(f"T={t} not divisible by axis size {n}")
    t_loc, d = t // n, y.shape[3]
    tm, tn = _snap(block_m, t_loc), _snap(block_n, d)
    if y.device.type == "cpu":
        return moe_reduce_rs_ref(y, w)
    tm, tn = min(tm, TILE_ROWS), min(tn, TILE_COLS)
    n_rb, n_cb = -(-t_loc // tm), -(-d // tn)
    slots = max(n - 1, 1)
    ws = shmem.workspace("moe_reduce_rs", (t_loc, d, tm, tn), n=n,
                         n_flags=n * slots * n_rb * n_cb, device=y.device,
                         data_shape=(slots, t_loc, d))
    out = torch.empty((n, t_loc, d), dtype=y.dtype, device=y.device)

    def describe(rank, step, slot):
        s, tile = divmod(slot % (slots * n_rb * n_cb), n_rb * n_cb)
        return (f"moe_reduce_rs: rank {rank} waited at ring step {step} for "
                f"the running sum of tile {divmod(tile, n_cb)} from rank "
                f"{(rank - 1) % n} (receive slot {s}, flag slot {slot}) "
                f"past {timeout_s} s")

    _launch(RS_KERNEL, "moe_reduce_rs", y, w, out, ws.data, n=n, t=t, tm=tm,
            tn=tn, ws=ws, describe=describe, fault=fault,
            timeout_s=timeout_s, check=check)
    return out


def moe_reduce_ar(y: torch.Tensor, w: torch.Tensor, *,
                  ctx: Optional[MeshContext] = None, axis: str = "tp",
                  block_n: int = 512, fault: int = 0,
                  timeout_s: float = shmem.TIMEOUT_S,
                  check: bool = False) -> torch.Tensor:
    """Fused weighted combine + one-shot all-reduce (the decode-shaped
    epilogue). One rank: y (T, K, d), w (T, K) → (T, d). Ranks: y (n, T,
    K, d), w (n, T, K) → the whole sum on every rank, (n, T, d).
    ``fault``, ``timeout_s`` and ``check`` as in :func:`moe_reduce_rs`."""
    t = _check(y, w)
    if y.dim() == 3:
        return _combine(y, w).to(y.dtype)
    n = ctx.size(axis) if ctx is not None else y.shape[0]
    if y.shape[0] != n:
        raise ValueError(f"y {tuple(y.shape)}: expected (n={n}, T, K, d)")
    d = y.shape[3]
    tn = _snap(block_n, d)
    if y.device.type == "cpu":
        return moe_reduce_ar_ref(y, w)
    tm, tn = min(t, TILE_ROWS), min(tn, TILE_COLS)
    n_rb, n_cb = -(-t // tm), -(-d // tn)
    ws = shmem.workspace("moe_reduce_ar", (t, d, tm, tn), n=n,
                         n_flags=n * n * n_rb * n_cb, device=y.device,
                         data_shape=(n, t, d))
    out = torch.empty((n, t, d), dtype=y.dtype, device=y.device)

    def describe(rank, step, slot):
        src, tile = divmod(slot % (n * n_rb * n_cb), n_rb * n_cb)
        return (f"moe_reduce_ar: rank {rank} waited for rank {src}'s "
                f"partial of tile {divmod(tile, n_cb)} (gather slot {src}, "
                f"flag slot {slot}) past {timeout_s} s")

    _launch(AR_KERNEL, "moe_reduce_ar", y, w, out, ws.data, n=n, t=t, tm=tm,
            tn=tn, ws=ws, describe=describe, fault=fault,
            timeout_s=timeout_s, check=check)
    return out
