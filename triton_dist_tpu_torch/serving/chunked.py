"""Bucketed chunked-prefill driver (counterpart of
``triton_dist_tpu/serving/chunked.py``).

Prompts stream into the slot's pages in fixed-shape chunks
(:func:`~triton_dist_tpu_torch.ops.chunked_prefill.plan_chunks`), each
chunk one call of the engine model's ``prefill_chunk_paged``
(:func:`~triton_dist_tpu_torch.models.dense.prefill_chunk_paged`, or the
MoE model's). PyTorch
runs eagerly, so there is no jit cache to bound; the JAX package's
bucket-count gate becomes a count of the distinct chunk shapes
dispatched, which must never exceed the bucket count.

:class:`MegaChunkedPrefill` is the same driver over a megakernel engine's
chunk builds: one megakernel launch per chunk.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from triton_dist_tpu_torch.ops.chunked_prefill import (
    chunk_row_codes, plan_chunks)

__all__ = ["ChunkedPrefill", "MegaChunkedPrefill", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (128, 512, 2048)


class ChunkedPrefill:
    """Bucketed chunk dispatch over one engine's weights and page pool."""

    def __init__(self, engine, buckets: Sequence[int]):
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"prefill buckets must be positive ints, "
                             f"got {buckets!r}")
        self.engine = engine
        self.buckets = buckets
        self._shapes = set()

    def plan(self, n_tokens: int) -> List[Tuple[int, int]]:
        """Deterministic ``[(bucket, valid), ...]`` cover of ``n_tokens``."""
        return plan_chunks(n_tokens, self.buckets)

    def next_chunk(self, remaining: int) -> Tuple[int, int]:
        """The next (bucket, valid) for ``remaining`` tokens."""
        return self.plan(remaining)[0]

    def step(self, params, toks: np.ndarray, cache, table_row: np.ndarray,
             start: int, wfrom: int, valid: int) -> torch.Tensor:
        """Dispatch one chunk; writes its K/V into ``cache`` in place and
        returns the fp32 logits (vocab,) of its last valid token.
        ``toks`` is (bucket,) int32, padded past ``valid``."""
        eng = self.engine
        dev = eng.device
        logits = eng.model.prefill_chunk_paged(
            params, torch.as_tensor(toks, device=dev), cache,
            torch.as_tensor(table_row, device=dev), eng.cfg,
            start=int(start), wfrom=int(wfrom), valid=int(valid),
            **eng.paged_kw)
        self._shapes.add(int(toks.shape[0]))
        if len(self._shapes) > len(self.buckets):
            raise RuntimeError(
                f"chunked prefill dispatched {len(self._shapes)} chunk "
                f"shapes > {len(self.buckets)} buckets {self.buckets}")
        return logits

    def cache_size(self) -> int:
        """Distinct chunk shapes dispatched so far (<= bucket count)."""
        return len(self._shapes)


class MegaChunkedPrefill:
    """Chunk driver over a
    :class:`~triton_dist_tpu_torch.megakernel.engine.MegaKernelEngine`
    built with ``prefill_buckets``: the :class:`ChunkedPrefill` surface the
    server drives (``buckets``, ``plan``, ``next_chunk``, ``step``,
    ``cache_size``). The pool lives in the engine, so ``step`` ignores its
    ``params`` and ``cache``; the chunk's cursors become the per-row codes
    of :func:`~triton_dist_tpu_torch.ops.chunked_prefill.chunk_row_codes`."""

    def __init__(self, engine):
        if not getattr(engine, "prefill_buckets", None):
            raise ValueError(
                "MegaChunkedPrefill needs a MegaKernelEngine built with "
                "prefill_buckets=(...): the chunk builds are made at "
                "engine construction")
        self.engine = engine
        self.buckets = tuple(engine.prefill_buckets)

    def plan(self, n_tokens: int) -> List[Tuple[int, int]]:
        """The same ``[(bucket, valid), ...]`` cover as the layer lane."""
        return plan_chunks(n_tokens, self.buckets)

    def next_chunk(self, remaining: int) -> Tuple[int, int]:
        return self.plan(remaining)[0]

    def step(self, params, toks: np.ndarray, cache, table_row: np.ndarray,
             start: int, wfrom: int, valid: int) -> torch.Tensor:
        """One chunk launch; returns the fp32 logits (vocab,) of its last
        valid row, the only row of the chunk's logits it reads out."""
        codes = chunk_row_codes(start, len(toks), valid, wfrom)
        return self.engine.prefill_chunk(toks, codes, table_row,
                                         row=int(valid) - 1)

    def cache_size(self) -> int:
        """The engine's chunk builds (<= bucket count)."""
        return self.engine.chunk_cache_size()
