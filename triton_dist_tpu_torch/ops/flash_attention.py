"""Prefill flash attention (counterpart of the Pallas flash attention that
``triton_dist_tpu/layers/tp_attn.py`` ``sdpa`` takes for a causal prefill,
``jax.experimental.pallas.ops.tpu.flash_attention``, :177-188).

:func:`flash_attention` takes sdpa's layout: q (B, S, H, hd), k and v
(B, S, KV, hd), query head h reading KV head ``h // (H // KV)``. On a CUDA
tensor it launches ``flash_attention_kernel`` (``csrc/flash_attention.cu``);
on a CPU tensor it runs :func:`flash_attention_ref`, the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.utils.build import CudaKernel

# ``KERNEL.launches`` counts launches of the CUDA kernel.
KERNEL = CudaKernel("flash_attention.cu", "tdt_flash_attention_bf16",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                    + [ctypes.c_float, ctypes.c_int])
MAX_HEAD_DIM = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float) -> torch.Tensor:
    """Attention of every query over the same sequence's keys, GQA by head
    group. q: (B, S, H, hd); k/v: (B, S, KV, hd) with ``H % KV == 0``;
    query i attends keys ``j <= i`` when ``causal``, every key otherwise.
    Scores are ``q·k · sm_scale``, summed and softmaxed in fp32. Returns
    (B, S, H, hd) in q's dtype."""
    b, s, h, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd \
            or h % k.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)} (same B, S and hd; H a "
                         "multiple of KV)")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    dev = q.device
    if dev.type != "cuda":
        raise RuntimeError(f"flash_attention runs on CUDA tensors (got "
                           f"{dev}); only CPU tensors take the plain version")
    for t in (q, k, v):
        if t.device != dev or t.dtype != torch.bfloat16:
            raise TypeError(f"expected bf16 tensors on {dev}, got {t.dtype} "
                            f"on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q, k and v must be contiguous and 16-byte "
                             "aligned")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim={hd} above the kernel's {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, s, h, k.shape[2], hd, float(sm_scale), int(causal),
                  device=dev)
    return out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sm_scale: float) -> torch.Tensor:
    """Plain version: fp32 scores and softmax with the query heads grouped
    by their KV head (a reshape of q, no K/V repeat), probabilities cast to
    the value dtype before P·V, as the JAX package's ``sdpa``."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * sm_scale
    if causal:
        pos = torch.arange(s, device=q.device)
        scores = scores.masked_fill(pos[None, :] > pos[:, None],
                                    float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, s, h, hd).to(q.dtype)
