"""Sequence-parallel flash-decode layer (counterpart of
``triton_dist_tpu/layers/sp_flash_decode.py``: ``init`` and ``fwd``): one
decode step over a KV cache sharded by sequence, each rank attending its
slice (row 15's sequence-sharded ``axis=`` form) and the partial results
merged by a cross-rank log-sum-exp combine. Not ported yet: :func:`fwd`
raises, naming ROADMAP.md queue A item 6; the decode kernel's ``axis=``
form raises too (:func:`~triton_dist_tpu_torch.ops.paged_flash_decode.
paged_flash_decode`).
"""

from __future__ import annotations

init = None  # JAX's layer takes tp_attn-style weights from the caller


def fwd(params, x, cfg, k_cache, v_cache, cache_len, *, axis="sp",
        fused: bool = False, ctx=None, page: int = 128):
    """JAX's sequence-sharded decode step: not ported."""
    raise NotImplementedError(
        "layers.sp_flash_decode (the sequence-sharded decode with its "
        "cross-rank LSE combine) is not ported yet: ROADMAP.md queue A "
        "item 6")
