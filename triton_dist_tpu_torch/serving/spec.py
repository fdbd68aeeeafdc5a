"""Speculative decoding: draft proposal and greedy acceptance
(counterpart of ``triton_dist_tpu/serving/spec.py``).

A host-side n-gram DRAFT proposes K-1 continuations of a request; one
K-token verify dispatch (:func:`~triton_dist_tpu_torch.models.dense.
verify_step_paged` on the layer lane, :meth:`~triton_dist_tpu_torch.
megakernel.engine.MegaKernelEngine.verify_step` on the megakernel lane)
scores them; greedy acceptance commits exactly the tokens a sequential
greedy decode would have produced. The draft is a self-proposer: the
tokens that followed the most recent earlier occurrence of the history's
trailing n-gram (shorter n-grams as fallbacks, then the last token
repeated).
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["NgramDraft", "accept_greedy"]


class NgramDraft:
    """Self-speculative n-gram proposer over a request's own history
    (prompt + generated tokens); ``n`` is the longest n-gram tried."""

    def __init__(self, n: int = 3):
        if n < 1:
            raise ValueError(f"ngram n must be >= 1, got {n}")
        self.n = n

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """``k`` continuation tokens for ``history`` (which ends with the
        pending token the verify dispatch feeds first). The most recent
        earlier match wins; a continuation shorter than ``k`` cycles."""
        if k <= 0:
            return []
        hist = list(history)
        if not hist:
            return [0] * k
        for n in range(min(self.n, len(hist)), 0, -1):
            tail = hist[-n:]
            for i in range(len(hist) - n - 1, -1, -1):
                if hist[i:i + n] == tail:
                    seg = hist[i + n:]
                    if seg:
                        return [seg[j % len(seg)] for j in range(k)]
        return [hist[-1]] * k


def accept_greedy(draft: Sequence[int], greedy: Sequence[int]) -> int:
    """How many tokens of a verify dispatch commit: ``draft`` holds the K
    fed candidates ``d_1..d_K``, ``greedy`` the K per-position argmax
    tokens ``t_1..t_K``. ``t_1`` always commits, each later ``t_j`` iff
    ``t_{j-1} == d_j``."""
    k = len(draft)
    m = 1
    while m < k and greedy[m - 1] == draft[m]:
        m += 1
    return m
