"""The MoE combine epilogue at one rank (counterpart of
``triton_dist_tpu/ops/moe_reduce.py``: ``moe_reduce_rs``,
``moe_reduce_ar``).

At one rank the reduce-scatter and the all-reduce are the identity, and
JAX's ``n == 1`` form of both is the fp32 weighted top-k combine in XLA;
here it is the same combine in PyTorch. The ring kernels
(``_moe_rs_kernel``, ``_moe_ar_kernel``, PERF.md rows 20-21) span ranks
and wait for the expert-parallel slice (ROADMAP.md, queue B).
"""

from __future__ import annotations

import torch


def moe_reduce_rs(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted combine + reduce-scatter at one rank. y: (T, K, d) expert
    outputs in slot order; w: (T, K) top-k weights. Returns (T, d) in
    ``y.dtype``, summed in fp32."""
    t, k, _ = y.shape
    if w.shape != (t, k):
        raise ValueError(f"weights {tuple(w.shape)} != {(t, k)}")
    return torch.einsum("tkd,tk->td", y.float(), w.float()).to(y.dtype)


# Weighted combine + all-reduce (the decode epilogue): at one rank the
# same combine as the reduce-scatter form.
moe_reduce_ar = moe_reduce_rs
