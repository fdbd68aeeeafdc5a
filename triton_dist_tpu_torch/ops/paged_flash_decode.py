"""Paged GQA flash decode (counterpart of
``triton_dist_tpu/ops/paged_flash_decode.py``).

:func:`paged_flash_decode` is the local (``axis=None``) form over a
bf16, int8 or fp8 page pool (a quantized pool with its per-page scales).
On a CUDA tensor it launches ``paged_decode_kernel``
(``csrc/paged_attention.cu``, one instantiation per pool dtype, the
quantized ones dequantizing in the kernel), which replaces the Pallas
``_decode_kernel``; on a CPU tensor it runs :func:`paged_flash_decode_ref`,
the plain version. The sequence-sharded form (``axis=...``) is not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.ops.chunked_prefill import gather_pages_dense
from triton_dist_tpu_torch.ops.flash_decode import flash_decode_ref
from triton_dist_tpu_torch.utils.build import CudaKernel

# Each kernel's ``launches`` counts launches of its CUDA instantiation:
# ``KERNELS[pool dtype]``; ``KERNEL`` is the bf16 one.
_PTRS = [ctypes.c_void_p]
KERNEL = CudaKernel("paged_attention.cu", "tdt_paged_decode_bf16",
                    _PTRS * 6 + [ctypes.c_int] * 6)
KERNELS = {
    torch.bfloat16: KERNEL,
    torch.int8: CudaKernel("paged_attention.cu", "tdt_paged_decode_int8",
                           _PTRS * 8 + [ctypes.c_int] * 6),
    torch.float8_e4m3fn: CudaKernel("paged_attention.cu",
                                    "tdt_paged_decode_fp8",
                                    _PTRS * 8 + [ctypes.c_int] * 6),
}
SUPPORTED_HEAD_DIMS = (128,)      # compiled in csrc/paged_attention.cu
QUANTIZED = (torch.int8, torch.float8_e4m3fn)


def is_quantized_pool(pool: torch.Tensor) -> bool:
    return pool.dtype in QUANTIZED


def require_pool_scales(pool: torch.Tensor, k_scale, *,
                        reject_spurious: bool = False) -> None:
    """Every paged reader's quantization contract: an int8/fp8 pool
    without scales raises rather than attend raw codes;
    ``reject_spurious`` also refuses scales beside an unquantized pool."""
    if is_quantized_pool(pool) and k_scale is None:
        raise ValueError(
            f"k_pages is a QUANTIZED pool ({pool.dtype}) but no "
            "k_scale/v_scale was passed — a scaleless reader would attend "
            "raw quantized bytes (kv_dtype mismatch between the pool's "
            "writer and this reader?)")
    if reject_spurious and k_scale is not None and not is_quantized_pool(
            pool):
        raise ValueError(f"k_scale passed for an unquantized ({pool.dtype}) "
                         "pool — scales only pair with int8/fp8 storage")


def kernel_args(q, k_pages, v_pages, k_scale, v_scale, ints, *,
                head_dim: int):
    """Checks a paged kernel's arguments (device, dtypes, layout, the
    scale tables of a quantized pool) and returns the launch's leading
    pointers: q, the pools, and the scales when quantized."""
    dev = q.device
    if dev.type != "cuda":
        raise RuntimeError(
            f"paged attention kernels run on CUDA tensors (got {dev}); "
            "only CPU tensors take the plain version")
    if q.dtype != torch.bfloat16 or k_pages.dtype not in KERNELS:
        raise TypeError(f"expected bf16 queries and bf16/int8/fp8 pools, got "
                        f"{q.dtype} and {k_pages.dtype}")
    for t in (q, k_pages, v_pages):
        if t.device != dev or t.dtype != (q.dtype if t is q
                                          else k_pages.dtype):
            raise TypeError(f"expected tensors of one pool dtype on {dev}, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q and the pools must be contiguous and "
                             "16-byte aligned")
    for t in ints:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"block table / lengths must be contiguous "
                            f"int32 on {dev}, got {t.dtype} on {t.device}")
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim={head_dim} not in {SUPPORTED_HEAD_DIMS}")
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if is_quantized_pool(k_pages):
        want = k_pages.shape[:2]
        for t in (k_scale, v_scale):
            if (t is None or t.device != dev or t.dtype != torch.float32
                    or tuple(t.shape) != tuple(want)
                    or not t.is_contiguous()):
                raise TypeError(f"scales must be contiguous fp32 {tuple(want)}"
                                f" on {dev}")
        ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
    return ptrs


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_table: torch.Tensor,
                       kv_len: torch.Tensor, *, axis=None, k_scale=None,
                       v_scale=None) -> torch.Tensor:
    """Paged-KV GQA decode step, one query per slot.

    q: (B, H, hd); k_pages/v_pages: (num_pages, KV, page, hd) — one
    layer's head-major page pool; block_table: (B, P_max) int32 page
    ids; kv_len: (B,) int32 — slot b attends positions
    ``< max(kv_len[b], 1)`` (a parked slot's length clamps to one, so
    its row stays finite), capped at the row's ``P_max·page``.
    A quantized (int8/fp8) pool needs ``k_scale``/``v_scale``: its
    layer's (num_pages, KV) fp32 dequant scales. Returns (B, H, hd)."""
    if axis is not None:
        raise NotImplementedError(
            "the sequence-sharded decode (axis=...) needs several cards; "
            "it is not ported yet (ROADMAP.md)")
    require_pool_scales(k_pages, k_scale, reject_spurious=True)
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, k_pages, v_pages, block_table,
                                      kv_len, k_scale, v_scale)
    b, h, hd = q.shape
    _, kvh, page, _ = k_pages.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[-1] != hd:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {q.shape}")
    if block_table.shape[0] != b or kv_len.shape != (b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / kv_len "
                         f"{tuple(kv_len.shape)} do not match batch {b}")
    ptrs = kernel_args(q, k_pages, v_pages, k_scale, v_scale,
                       (block_table, kv_len), head_dim=hd)
    out = torch.empty_like(q)
    KERNELS[k_pages.dtype].launch(
        *ptrs, block_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        b, h, kvh, hd, page, block_table.shape[1], device=q.device)
    return out


def paged_flash_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           kv_len: torch.Tensor, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """Plain version: gather the block table's pages into the dense
    position-major view (dequantized to fp32 for a quantized pool) and
    run masked attention
    (:func:`~triton_dist_tpu_torch.ops.flash_decode.flash_decode_ref`).
    Lengths clamp to >= 1 as in the kernel. Returns (B, H, hd)."""
    require_pool_scales(k_pages, k_scale)
    safe_len = torch.clamp(kv_len, min=1)
    return flash_decode_ref(q, gather_pages_dense(k_pages, block_table,
                                                  k_scale),
                            gather_pages_dense(v_pages, block_table,
                                               v_scale), safe_len)
