"""Fixed-shape chunked-prefill building blocks over a paged KV pool
(counterpart of ``triton_dist_tpu/ops/chunked_prefill.py``).

- :func:`plan_chunks` — the deterministic bucket cover of a prompt;
- :func:`chunk_write_ids` — which pool page / offset each chunk token
  writes (padding and prefix-resident positions go to the scratch page);
- :func:`chunk_row_codes` — the same rule as the megakernel's per-row
  sign-encoded positions;
- :func:`chunk_attend` — causal attention of a chunk over a slot's
  gathered position-major KV view;
- :func:`gather_pages_dense` — THE dense-row gather (pool pages →
  position-major view) every plain paged reader shares.

``plan_chunks``, ``chunk_write_ids`` and ``chunk_row_codes`` are exact
copies of the JAX logic: preemption replays re-prefill through the same
chunk sequence, and the tests hold them against the JAX package for
equality.
"""

from __future__ import annotations

import math

import numpy as np
import torch


SCRATCH_PAGE = 0


def gather_pages_dense(pool: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Gather block-table pages into the dense position-major view.

    pool: (num_pages, KV, page, hd) — ONE layer's page pool; table:
    (..., P) int page ids (``(p_max,)`` for one slot's row, ``(S,
    p_max)`` for a decode batch). Returns (..., P·page, KV, hd);
    positions past the written region are garbage the caller masks."""
    kvh, page, hd = pool.shape[1:]
    g = pool[table.long()]                   # (..., P, KV, page, hd)
    g = g.movedim(-2, -3)                    # (..., P, page, KV, hd)
    return g.reshape(*table.shape[:-1], table.shape[-1] * page, kvh, hd)


def plan_chunks(n_tokens: int, buckets) -> list:
    """Deterministic bucket cover of ``n_tokens``: greedily the largest
    bucket that fits, then the smallest bucket covering the remainder
    (padded). Returns ``[(bucket, valid), ...]`` with
    ``sum(valid) == n_tokens``."""
    if n_tokens < 0:
        raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
    bs = sorted(set(int(b) for b in buckets))
    if not bs or bs[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets}")
    out = []
    rem = int(n_tokens)
    while rem > 0:
        fit = [b for b in bs if b <= rem]
        if fit:
            b = max(fit)
            out.append((b, b))
            rem -= b
        else:                    # tail: smallest bucket covers it, padded
            b = min(x for x in bs if x >= rem)
            out.append((b, rem))
            rem = 0
    return out


def chunk_write_ids(positions: torch.Tensor, table_row: torch.Tensor,
                    valid, wfrom, *, page: int):
    """Scatter targets for one chunk's K/V tokens.

    ``positions``: (C,) int global positions of the chunk tokens;
    ``table_row``: (p_max,) int — the slot's block-table row;
    ``valid``: tokens past it are bucket padding; ``wfrom``: positions
    below it are already resident (prefix-shared pages another request
    may be attending) and are never rewritten.

    Returns ``(pids, offsets)``: padding / resident positions map to the
    scratch page (id 0); real positions map to
    ``table_row[pos // page]``."""
    c = positions.shape[0]
    i = torch.arange(c, dtype=torch.int32, device=positions.device)
    row = torch.clamp(positions // page, 0, table_row.shape[0] - 1)
    writable = (i < valid) & (positions >= wfrom)
    pids = torch.where(writable, table_row[row.long()],
                       torch.full_like(row, SCRATCH_PAGE))
    return pids, positions % page


def chunk_row_codes(start: int, bucket: int, valid, wfrom) -> np.ndarray:
    """Sign-encoded per-row positions of ONE megakernel prefill chunk, a
    (bucket,) int32 host vector. Row ``i`` sits at global position
    ``start + i``:

    - ``>= 0``: write and attend at that position;
    - ``<= -2``: attend only, at ``-code - 2`` (a position below
      ``wfrom``, already resident in a prefix-shared page, never
      rewritten);
    - ``-1``: a dead padding row (``i >= valid``).

    The megakernel's chunk bodies decode it
    (:func:`triton_dist_tpu_torch.megakernel.kernels._chunk_apos`)."""
    i = np.arange(int(bucket), dtype=np.int64)
    pos = int(start) + i
    codes = np.where(pos >= int(wfrom), pos, -(pos + 2))
    codes = np.where(i < int(valid), codes, -1)
    return codes.astype(np.int32)


def chunk_attend(q: torch.Tensor, k_dense: torch.Tensor,
                 v_dense: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Causal chunk attention over a gathered position-major KV view.

    q: (C, H, hd); k_dense/v_dense: (T, KV, hd); positions: (C,) global
    query positions — query ``i`` attends keys at positions
    ``<= positions[i]``. GQA by head repeat; fp32 softmax, probabilities
    cast to the value dtype before P·V. Returns (C, H, hd)."""
    c, h, hd = q.shape
    t, kvh, _ = k_dense.shape
    rep = h // kvh
    k = k_dense.repeat_interleave(rep, dim=1)       # (T, H, hd)
    v = v_dense.repeat_interleave(rep, dim=1)
    scores = torch.einsum("chd,thd->hct", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    key_pos = torch.arange(t, device=q.device)
    mask = key_pos[None, :] <= positions.to(q.device)[:, None]
    scores = scores.masked_fill(~mask[None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("hct,thd->chd", probs, v).to(q.dtype)
