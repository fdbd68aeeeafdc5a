"""Paged KV block manager — the serving layer's memory system
(counterpart of ``triton_dist_tpu/serving/blocks.py``).

- :class:`PagedKVCache` — the device half: per-layer page pools
  ``(L, num_pages, KV, page, hd)`` plus the per-slot ``block_table``,
  ``lens`` and ``live`` mask every decode dispatch reads. Writers update
  the pools IN PLACE (``index_put_``): the JAX package's ``.at[].set``
  returns a copy and its server donates the pool to avoid that copy;
  here there is no copy to avoid.
- :class:`BlockManager` — the host allocator: free list of page ids,
  per-slot page lists, append-time page growth, fragmentation stats and
  optional prefix-block reuse (full prompt pages shared by content,
  refcounted, evicted by a decayed hit score).

Page id 0 is RESERVED as the scratch page: parked slots keep an all-zero
table row, so the fixed-shape decode step's writes for them land there.
Only unquantized pools are ported; int8/fp8 pools and the KV-tier hooks
are listed in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from triton_dist_tpu_torch.ops.chunked_prefill import (
    SCRATCH_PAGE, chunk_write_ids, gather_pages_dense,
)

KV_DTYPES = ("bf16", "int8", "fp8")
_KV_QUANT = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}


def kv_quant_spec(kv_dtype: str):
    """→ (storage dtype | None, qmax | None) for a ``kv_dtype`` value;
    None means the unquantized native pool."""
    if kv_dtype in (None, "bf16", "native"):
        return None, None
    if kv_dtype not in _KV_QUANT:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                         f"{kv_dtype!r}")
    return _KV_QUANT[kv_dtype]


class OutOfPagesError(RuntimeError):
    """The pool has no free page (and nothing evictable) — the caller
    should apply backpressure (queue or preempt the request)."""


class BlockTableOverflowError(RuntimeError):
    """A request needs more pages than one block-table row holds
    (``p_max``) — it outgrew ``max_len``; fail the request, not the
    server."""


@dataclasses.dataclass
class PagedKVCache:
    """Device half of the paged cache (see module docstring).

    ``k_pages``/``v_pages``: (L, num_pages, KV, page, hd) pools;
    ``block_table``: (num_slots, p_max) int32 page ids; ``lens``:
    (num_slots,) int32 valid tokens per slot; ``live``: (num_slots,)
    int32 0/1. Every write method updates the pools in place and returns
    nothing."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_table: torch.Tensor
    lens: torch.Tensor
    live: torch.Tensor

    @classmethod
    def empty(cls, num_layers: int, num_pages: int, page: int,
              kv_heads: int, head_dim: int, *, num_slots: int, p_max: int,
              device, dtype=torch.bfloat16) -> "PagedKVCache":
        shape = (num_layers, num_pages, kv_heads, page, head_dim)
        ints = dict(dtype=torch.int32, device=device)
        return cls(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=torch.zeros(shape, dtype=dtype, device=device),
            block_table=torch.zeros((num_slots, p_max), **ints),
            lens=torch.zeros((num_slots,), **ints),
            live=torch.zeros((num_slots,), **ints))

    @property
    def page(self) -> int:
        return self.k_pages.shape[3]

    @property
    def capacity(self) -> int:
        """Tokens one block-table row can address (p_max · page)."""
        return self.block_table.shape[1] * self.page

    def _put(self, layer: int, pids, offs, k_rows, v_rows) -> None:
        """In-place write of token rows (n, KV, hd) at (page id, offset)
        pairs (n,) of one layer's pools."""
        heads = torch.arange(self.k_pages.shape[2], device=pids.device)
        idx = (pids.long()[:, None], heads[None, :], offs.long()[:, None])
        self.k_pages[layer].index_put_(idx, k_rows.to(self.k_pages.dtype))
        self.v_pages[layer].index_put_(idx, v_rows.to(self.v_pages.dtype))

    def append_decode(self, layer: int, k_tok, v_tok) -> None:
        """Write one decode token's K/V per slot at each slot's own
        length, in place. k_tok/v_tok: (num_slots, 1, KV, hd). Parked
        slots (all-zero table row) write the scratch page. Lengths
        advance once per step via :meth:`advance`, not here."""
        page = self.page
        row = (self.lens // page).long()
        pids = torch.gather(self.block_table, 1, row[:, None])[:, 0]
        self._put(layer, pids, self.lens % page, k_tok[:, 0], v_tok[:, 0])

    def advance(self) -> None:
        """Bump live slots' lengths after all layers appended."""
        self.lens += self.live

    def write_chunk(self, layer: int, k_tok, v_tok, table_row, positions,
                    valid, wfrom) -> None:
        """Write one prefill chunk's K/V into a slot's pages, in place.

        k_tok/v_tok: (C, 1, KV, hd); ``table_row``: (p_max,) int32;
        ``positions``: (C,) global positions; ``valid``/``wfrom`` route
        bucket padding and prefix-resident positions to the scratch page
        (:func:`~triton_dist_tpu_torch.ops.chunked_prefill.chunk_write_ids`)."""
        pids, offs = chunk_write_ids(positions, table_row, valid, wfrom,
                                     page=self.page)
        self._put(layer, pids, offs, k_tok[:, 0], v_tok[:, 0])

    def write_prompt(self, k_prompt, v_prompt, page_ids) -> None:
        """Blit a prefilled prompt's K/V into pages, in place (every
        layer at once).

        k_prompt/v_prompt: (L, S_pad, KV, hd), S_pad a multiple of
        ``page`` (the tail past the slot's length is masked by every
        reader); ``page_ids``: (S_pad // page,) int page ids, one per
        page block. The caller passes only the suffix of its allocation
        that is not prefix-shared (:meth:`BlockManager.prefix_hits`):
        shared pages keep the first sharer's bytes."""
        num_l, s_pad, kvh, hd = k_prompt.shape
        n_p = s_pad // self.page
        ids = torch.as_tensor(page_ids, dtype=torch.long,
                              device=self.k_pages.device)
        for pool, prompt in ((self.k_pages, k_prompt),
                             (self.v_pages, v_prompt)):
            blocks = prompt.reshape(num_l, n_p, self.page, kvh, hd)
            pool[:, ids] = blocks.transpose(2, 3).to(pool.dtype)

    def dense_row(self, layer: int, table_row):
        """ONE slot's pages of one layer, gathered to the dense
        position-major view (p_max·page, KV, hd) — K and V."""
        return (gather_pages_dense(self.k_pages[layer], table_row),
                gather_pages_dense(self.v_pages[layer], table_row))

    def dense_layer(self, layer: int):
        """Every slot's pages of one layer, gathered to
        (num_slots, p_max·page, KV, hd) — K and V."""
        return (gather_pages_dense(self.k_pages[layer], self.block_table),
                gather_pages_dense(self.v_pages[layer], self.block_table))


class BlockManager:
    """Host-side page allocator over a fixed pool (see module
    docstring). Plain Python bookkeeping — no device syncs.

    ``prefix_reuse=True`` content-addresses FULL prompt pages: a request
    whose prompt shares a page-aligned prefix with a committed one
    re-uses those page ids (refcounted). Shared pages are always full,
    so decode appends (which touch only a slot's last, private page)
    never mutate them. The cache holds one reference per shared page;
    when the free list runs dry, unreferenced prefix pages are evicted
    lowest score first — an EWMA of hit frequency and recency (every
    hit adds one, every allocation tick decays by ``score_decay``)."""

    def __init__(self, num_pages: int, page: int, p_max: int, *,
                 prefix_reuse: bool = False,
                 page_bytes: Optional[int] = None,
                 score_decay: float = 0.9):
        if num_pages < 2:
            raise ValueError(f"num_pages={num_pages} < 2 (page 0 is the "
                             "reserved scratch page)")
        if not (0.0 < score_decay <= 1.0):
            raise ValueError(f"score_decay must be in (0, 1], got "
                             f"{score_decay}")
        self.num_pages = num_pages
        self.page = page
        self.p_max = p_max
        self.prefix_reuse = prefix_reuse
        self.page_bytes = page_bytes
        self.score_decay = float(score_decay)
        self._free: deque = deque(range(1, num_pages))
        self._refs: Dict[int, int] = {}
        self._slot_pages: Dict[int, List[int]] = {}
        self._slot_tokens: Dict[int, int] = {}
        self._slot_hits: Dict[int, int] = {}
        # Committed prefix cache: chained content key -> page id. Entries
        # are published in two phases: alloc_prefill stages a slot's
        # prefix-eligible pages in _pending_prefix, and commit_prefix
        # moves them here once their KV content is written — a hit hands
        # other requests these bytes, so registering at allocation time
        # would share unwritten pages.
        self._prefix: Dict[Tuple, int] = {}
        self._pending_prefix: Dict[int, List[Tuple[Tuple, int]]] = {}
        # Eviction score per committed key: (score, last-touch tick).
        self._score: Dict[Tuple, Tuple[float, int]] = {}
        self._tick = 0
        self.stats = {"allocs": 0, "frees": 0, "prefix_hits": 0,
                      "prefix_misses": 0, "evictions": 0}

    # -- raw pool ----------------------------------------------------

    def _take_page(self) -> int:
        if not self._free:
            self.evict(1)
        if not self._free:
            raise OutOfPagesError(
                f"page pool exhausted ({self.num_pages - 1} usable "
                f"pages, {len(self._prefix)} pinned by live prefixes)")
        pid = self._free.popleft()
        self._refs[pid] = self._refs.get(pid, 0) + 1
        self.stats["allocs"] += 1
        return pid

    def _drop_ref(self, pid: int):
        self._refs[pid] -= 1
        if self._refs[pid] == 0:
            del self._refs[pid]
            self._free.append(pid)
            self.stats["frees"] += 1

    def _decayed_score(self, key: Tuple) -> float:
        score, last = self._score.get(key, (0.0, self._tick))
        return score * self.score_decay ** (self._tick - last)

    def _touch_score(self, key: Tuple):
        self._score[key] = (self._decayed_score(key) + 1.0, self._tick)

    def evict(self, n: int = 1) -> List[Tuple[Tuple, int]]:
        """Evict up to ``n`` UNREFERENCED committed prefix pages, lowest
        decayed score first (ties in insertion order). Pages a live slot
        still references are never candidates. Returns the evicted
        ``(key, pid)`` pairs. The scan is linear in the committed
        entries, which is bounded by ``num_pages``."""
        out: List[Tuple[Tuple, int]] = []
        for _ in range(n):
            victim, best = None, None
            for key, pid in self._prefix.items():
                if self._refs.get(pid, 0) != 1:   # a slot still reads it
                    continue
                s = self._decayed_score(key)
                if best is None or s < best:
                    victim, best = (key, pid), s
            if victim is None:
                break
            key, pid = victim
            del self._prefix[key]
            self._score.pop(key, None)
            self._drop_ref(pid)
            self.stats["evictions"] += 1
            out.append(victim)
        return out

    # -- per-slot API ------------------------------------------------

    def iter_prefix_keys(self, tokens: Sequence[int]):
        """Successive chained content keys for ``tokens``'s FULL pages —
        the one definition of the prefix-key algebra."""
        key: Tuple = ()
        for i in range(len(tokens) // self.page):
            key = (key, tuple(tokens[i * self.page:(i + 1) * self.page]))
            yield key

    def alloc_prefill(self, slot: int, tokens: Sequence[int]) -> List[int]:
        """Allocate the page list for a prompt entering ``slot``: shared
        full-prefix pages (with ``prefix_reuse``) + private pages for the
        rest, in position order. Raises :class:`BlockTableOverflowError`
        when the prompt alone outgrows one table row, and
        :class:`OutOfPagesError` (allocation rolled back) when the pool
        is dry."""
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} already allocated; free it "
                             "before reuse")
        self._tick += 1            # the eviction score's decay clock
        n_tok = len(tokens)
        n_pages = max((n_tok + self.page - 1) // self.page, 1)
        if n_pages > self.p_max:
            raise BlockTableOverflowError(
                f"prompt of {n_tok} tokens needs {n_pages} pages > one "
                f"block-table row ({self.p_max} x {self.page})")
        pages: List[int] = []
        hits = 0
        try:
            full = n_tok // self.page
            keys = self.iter_prefix_keys(tokens)
            for i in range(n_pages):
                if self.prefix_reuse and i < full:
                    key = next(keys)
                    pid = self._prefix.get(key)
                    if pid is not None:
                        self._refs[pid] += 1
                        self.stats["prefix_hits"] += 1
                        self._touch_score(key)
                        if hits == i:     # hits are always a prefix run
                            hits += 1
                        pages.append(pid)
                        continue
                    self.stats["prefix_misses"] += 1
                    pid = self._take_page()
                    # Staged, not published: the page holds no KV yet.
                    self._pending_prefix.setdefault(slot, []).append(
                        (key, pid))
                    pages.append(pid)
                else:
                    pages.append(self._take_page())
        except OutOfPagesError:
            self._pending_prefix.pop(slot, None)
            for pid in pages:
                self._drop_ref(pid)
            raise
        self._slot_pages[slot] = pages
        self._slot_tokens[slot] = n_tok
        self._slot_hits[slot] = hits
        return list(pages)   # copy: appends must not mutate the result

    def commit_prefix(self, slot: int):
        """Publish ``slot``'s staged prefix pages into the
        content-addressed cache — call exactly when their KV content is
        written (the last chunk of the slot's prefill). If another sharer
        committed the same content first, its entry wins and this slot's
        copy stays private."""
        for key, pid in self._pending_prefix.pop(slot, []):
            if key in self._prefix:
                continue
            self._refs[pid] += 1
            self._prefix[key] = pid
            self._score[key] = (1.0, self._tick)

    def prefix_hits(self, slot: int) -> int:
        """Leading page count of ``slot``'s allocation that came from
        the prefix cache (always a prefix run of the page list). Their KV
        bytes were written by the first sharer and are never rewritten."""
        return self._slot_hits.get(slot, 0)

    def append(self, slot: int, pos: Optional[int] = None) -> Optional[int]:
        """Account one appended token for ``slot``; allocates (and
        returns) a fresh page when the token starts a new page, else
        returns None. Raises :class:`BlockTableOverflowError` when the
        request outgrows its table row. ``pos`` (the position being
        written) makes the call idempotent per position."""
        n = self._slot_tokens[slot]
        if pos is not None and pos < n:
            return None          # retry of an already-accounted token
        if n % self.page == 0 and n // self.page >= len(
                self._slot_pages[slot]):
            if len(self._slot_pages[slot]) >= self.p_max:
                raise BlockTableOverflowError(
                    f"slot {slot} at {n} tokens needs page "
                    f"{n // self.page + 1} > row capacity "
                    f"{self.p_max} x {self.page}")
            pid = self._take_page()
            self._slot_pages[slot].append(pid)
            self._slot_tokens[slot] = n + 1
            return pid
        self._slot_tokens[slot] = n + 1
        return None

    def truncate_to(self, slot: int, n_tokens: int):
        """Roll ``slot``'s token accounting back to ``n_tokens`` and free
        now-unused TRAILING pages (never its prefix-hit run)."""
        pages = self._slot_pages.get(slot)
        if pages is None:
            raise KeyError(f"slot {slot} has no allocation to truncate")
        cur = self._slot_tokens[slot]
        if n_tokens > cur:
            raise ValueError(f"truncate_to({n_tokens}) beyond slot "
                             f"{slot}'s {cur} accounted tokens")
        keep = max((n_tokens + self.page - 1) // self.page, 1,
                   self._slot_hits.get(slot, 0))
        while len(pages) > keep:
            self._drop_ref(pages.pop())
        self._slot_tokens[slot] = n_tokens

    def free_slot(self, slot: int):
        """Release a finished request's pages (committed shared pages
        survive in the prefix cache until evicted; staged ones are
        dropped, so no later request hits an unwritten page)."""
        self._pending_prefix.pop(slot, None)
        for pid in self._slot_pages.pop(slot, []):
            self._drop_ref(pid)
        self._slot_tokens.pop(slot, None)
        self._slot_hits.pop(slot, None)

    # -- checkpoint/restore ------------------------------------------

    def snapshot(self) -> dict:
        """Plain-data deep copy of the full allocator state (free list,
        refcounts, per-slot pages/tokens/hits, committed and staged
        prefix entries, scores, stats); :meth:`load_snapshot` adopts it."""
        return {
            "num_pages": self.num_pages, "page": self.page,
            "p_max": self.p_max, "prefix_reuse": self.prefix_reuse,
            "free": list(self._free),
            "refs": dict(self._refs),
            "slot_pages": {s: list(p) for s, p in self._slot_pages.items()},
            "slot_tokens": dict(self._slot_tokens),
            "slot_hits": dict(self._slot_hits),
            "prefix": list(self._prefix.items()),
            "prefix_score": [(k, s, t) for k, (s, t) in
                             self._score.items()],
            "tick": self._tick,
            "pending_prefix": {s: list(v) for s, v in
                               self._pending_prefix.items()},
            "stats": dict(self.stats),
        }

    def load_snapshot(self, snap: dict) -> None:
        """Adopt a :meth:`snapshot` wholesale; the geometry must match."""
        for key in ("num_pages", "page", "p_max"):
            if snap[key] != getattr(self, key):
                raise ValueError(
                    f"snapshot {key}={snap[key]} != this manager's "
                    f"{getattr(self, key)} — restore needs an "
                    "identically-planned pool")
        self.prefix_reuse = bool(snap["prefix_reuse"])
        self._free = deque(snap["free"])
        self._refs = {int(k): int(v) for k, v in snap["refs"].items()}
        self._slot_pages = {int(s): list(p) for s, p in
                            snap["slot_pages"].items()}
        self._slot_tokens = {int(s): int(n) for s, n in
                             snap["slot_tokens"].items()}
        self._slot_hits = {int(s): int(n) for s, n in
                           snap["slot_hits"].items()}
        self._prefix = {k: int(v) for k, v in snap["prefix"]}
        self._score = {k: (float(s), int(t)) for k, s, t in
                       snap["prefix_score"]}
        self._tick = int(snap["tick"])
        self._pending_prefix = {int(s): [(k, int(p)) for k, p in v]
                                for s, v in snap["pending_prefix"].items()}
        self.stats = dict(snap["stats"])

    def table_row(self, slot: int) -> List[int]:
        """This slot's block-table row, scratch-padded to p_max."""
        row = [SCRATCH_PAGE] * self.p_max
        for i, pid in enumerate(self._slot_pages.get(slot, [])):
            row[i] = pid
        return row

    def fragmentation(self) -> dict:
        """Pool health: page accounting + internal fragmentation
        (used-token fraction of allocated page capacity)."""
        used_pages = self.num_pages - 1 - len(self._free)
        used_tokens = sum(self._slot_tokens.values())
        held_pages = sum(len(p) for p in self._slot_pages.values())
        shared = max(held_pages - len(
            set(p for ps in self._slot_pages.values() for p in ps)), 0)
        cap = max(held_pages, 1) * self.page
        out = {
            "num_pages": self.num_pages, "page": self.page,
            "free_pages": len(self._free), "used_pages": used_pages,
            "prefix_pages": len(self._prefix),
            "shared_page_refs": shared,
            "used_tokens": used_tokens,
            "utilization": used_tokens / cap if held_pages else 1.0,
            **self.stats,
        }
        if self.page_bytes:
            out["bytes_per_token"] = self.page_bytes / self.page
        return out
