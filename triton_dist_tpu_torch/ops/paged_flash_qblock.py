"""Paged flash Q-BLOCK attention (counterpart of
``triton_dist_tpu/ops/paged_flash_qblock.py``): the decode kernel
generalized from one query to Cq queries per slot, each with its own
causal bound. The chunked-prefill step rides it.

Both serving uses ride it: the chunk (``start + arange(C)`` positions)
and the speculative verify block (``lens[s] + j``). Pools are bf16, int8
or fp8 (quantized pools with their per-page scales). On a CUDA tensor
:func:`paged_flash_qblock` launches ``paged_qblock_kernel``
(``csrc/paged_attention.cu``, one instantiation per pool dtype), which
replaces the Pallas ``_qblock_kernel``; on a CPU tensor it runs
:func:`paged_flash_qblock_ref`, the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from triton_dist_tpu_torch.ops.chunked_prefill import gather_pages_dense
from triton_dist_tpu_torch.ops.paged_flash_decode import (
    kernel_args, require_pool_scales,
)
from triton_dist_tpu_torch.utils.build import CudaKernel

# Each kernel's ``launches`` counts launches of its CUDA instantiation:
# ``KERNELS[pool dtype]``; ``KERNEL`` is the bf16 one.
_PTRS = [ctypes.c_void_p]
KERNEL = CudaKernel("paged_attention.cu", "tdt_paged_qblock_bf16",
                    _PTRS * 6 + [ctypes.c_int] * 7)
KERNELS = {
    torch.bfloat16: KERNEL,
    torch.int8: CudaKernel("paged_attention.cu", "tdt_paged_qblock_int8",
                           _PTRS * 8 + [ctypes.c_int] * 7),
    torch.float8_e4m3fn: CudaKernel("paged_attention.cu",
                                    "tdt_paged_qblock_fp8",
                                    _PTRS * 8 + [ctypes.c_int] * 7),
}


def paged_flash_qblock(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_table: torch.Tensor,
                       positions: torch.Tensor, *, k_scale=None,
                       v_scale=None) -> torch.Tensor:
    """Paged-KV GQA attention of a Q-block per slot.

    q: (B, Cq, H, hd); k_pages/v_pages: (num_pages, KV, page, hd) — one
    layer's pool with every attended key already written; block_table:
    (B, P_max) int32; positions: (B, Cq) int32 — query (b, i) attends
    keys at positions ``<= positions[b, i]``, clamped to
    ``[0, P_max·page - 1]``. A quantized (int8/fp8) pool needs
    ``k_scale``/``v_scale``: its layer's (num_pages, KV) fp32 dequant
    scales. Returns (B, Cq, H, hd)."""
    require_pool_scales(k_pages, k_scale, reject_spurious=True)
    if q.device.type == "cpu":
        return paged_flash_qblock_ref(q, k_pages, v_pages, block_table,
                                      positions, k_scale, v_scale)
    b, cq, h, hd = q.shape
    _, kvh, page, _ = k_pages.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[-1] != hd:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {q.shape}")
    if block_table.shape[0] != b or positions.shape != (b, cq):
        raise ValueError(f"block_table {tuple(block_table.shape)} / "
                         f"positions {tuple(positions.shape)} do not match "
                         f"q {tuple(q.shape)}")
    ptrs = kernel_args(q, k_pages, v_pages, k_scale, v_scale,
                       (block_table, positions), head_dim=hd)
    out = torch.empty_like(q)
    KERNELS[k_pages.dtype].launch(
        *ptrs, block_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        b, cq, h, kvh, hd, page, block_table.shape[1], device=q.device)
    return out


def paged_flash_qblock_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           positions: torch.Tensor, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """Plain version: gather each slot's pages into the dense
    position-major view (dequantized to fp32 for a quantized pool) and
    run per-query masked fp32 attention; probabilities are cast to the
    value dtype before P·V. Returns (B, Cq, H, hd)."""
    require_pool_scales(k_pages, k_scale)
    b, cq, h, hd = q.shape
    rep = h // k_pages.shape[1]
    positions = torch.clamp(positions, min=0)
    kd = gather_pages_dense(k_pages, block_table, k_scale)
    vd = gather_pages_dense(v_pages, block_table, v_scale)
    t = kd.shape[1]
    k = kd.repeat_interleave(rep, dim=2)              # (B, T, H, hd)
    v = vd.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bchd,bthd->bhct", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    key_pos = torch.arange(t, device=q.device)
    mask = key_pos[None, None, :] <= positions[:, :, None]   # (B, Cq, T)
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhct,bthd->bchd", probs, v).to(q.dtype)
