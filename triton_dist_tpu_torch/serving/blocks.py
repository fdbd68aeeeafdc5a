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

At tp = n > 1 (simulated ranks) rank r's pools are its ``KV/n`` KV heads,
``[r·KV/n, (r+1)·KV/n)`` of the one pool of all ``KV`` heads: the
rank-major stack of the shards is the unsharded head order (JAX's global
view of its head-sharded pool), so one pool, one block table, one scratch
page and one allocator serve every rank, and a paged-attention launch over
the stacked heads is every rank's attention at once.

Quantized pools (``kv_dtype="int8"|"fp8"``) store one byte per element
and one fp32 scale per (layer, page, kv_head) beside it: symmetric
max-abs, ``scale = amax / qmax``, ``stored = round/cast(x / scale)``,
``dequant = stored * scale``. Every writer merges the token range it
writes into the touched pages under a fresh max-abs scale
(:func:`_quant_range_write`), every reader dequantizes. The KV-tier
hooks are listed in ROADMAP.md.
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


def quantize(x: torch.Tensor, scale, qdtype: torch.dtype,
             qmax: float) -> torch.Tensor:
    """fp32 ``x`` → storage dtype under ``scale`` (broadcastable). Divides
    (a reciprocal would move ties by one code); int8 rounds half to even
    and clips to ±qmax; fp8 clips to ±qmax first (the cast gives NaN out
    of range), then rounds to nearest even in the cast."""
    y = x / scale
    if qdtype == torch.int8:
        return torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    return torch.clamp(y, -qmax, qmax).to(qdtype)


def safe_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """amax → scale, with an all-zero page stored under scale 1."""
    return torch.where(amax > 0, amax / qmax,
                       torch.ones_like(amax)).to(torch.float32)


def _quant_range_write(pool, scales, layer: int, pids, loc, toks, tok_mask,
                       had_prior, qmax: float) -> None:
    """Merge consecutive token ranges into QUANTIZED pages, in place:
    the shared core of every partial-page quantized write (decode append,
    the K-token verify block, the prefill chunk).

    pool: (L, N, KV, page, hd) storage; scales: (L, N, KV) fp32; pids:
    (S, n_t) touched page ids per slot (scratch-substituted windows write
    garbage there); loc: (S, K) each token's place in the window
    [0, n_t·page) (tokens whose ``tok_mask`` is False are dropped); toks:
    (S, K, KV, hd); had_prior: (S, n_t) — a page holding earlier valid
    tokens keeps its running amax (scale·qmax) through the merge, a page
    whose first token lands now gets a fresh scale, so a freed-and-reused
    page never inherits a stale one. A page no token lands in
    requantizes to itself exactly (same scale)."""
    s, n_t = pids.shape
    _, _, kvh, page, hd = pool.shape
    dev = pool.device
    pids = pids.long()
    toks = toks.float()
    old_scale = scales[layer][pids]                      # (S, n_t, KV)
    deq = pool[layer][pids].float() * old_scale[..., None, None]
    dense = deq.permute(0, 1, 3, 2, 4).reshape(s, n_t * page, kvh, hd)
    # One dump row past the window takes the masked tokens.
    dense = torch.cat([dense, torch.zeros(s, 1, kvh, hd, device=dev)], 1)
    loc_w = torch.where(tok_mask, loc, torch.full_like(loc, n_t * page))
    rows = torch.arange(s, device=dev)[:, None].expand_as(loc_w)
    dense[rows, loc_w.long()] = toks
    dense = dense[:, :n_t * page]
    tok_amax = torch.where(tok_mask[..., None], toks.abs().amax(dim=-1),
                           torch.zeros((), device=dev))  # (S, K, KV)
    tpage = torch.clamp(torch.div(loc, page, rounding_mode="floor"), 0,
                        n_t - 1).long()
    amax_new = torch.zeros(s, n_t, kvh, device=dev).scatter_reduce(
        1, tpage[..., None].expand(-1, -1, kvh), tok_amax, reduce="amax")
    amax = torch.maximum(
        torch.where(had_prior[..., None], old_scale * qmax,
                    torch.zeros((), device=dev)), amax_new)
    new_scale = safe_scale(amax, qmax)
    blocks = dense.reshape(s, n_t, page, kvh, hd).permute(0, 1, 3, 2, 4)
    pool[layer][pids] = quantize(blocks, new_scale[..., None, None],
                                 pool.dtype, qmax)
    scales[layer][pids] = new_scale


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
    int32 0/1. A quantized pool (int8/fp8 storage) also carries
    ``k_scale``/``v_scale``: (L, num_pages, KV) fp32 dequant scales,
    ones at first. Every write method updates the pools (and scales) in
    place and returns nothing."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_table: torch.Tensor
    lens: torch.Tensor
    live: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def empty(cls, num_layers: int, num_pages: int, page: int,
              kv_heads: int, head_dim: int, *, num_slots: int, p_max: int,
              device, dtype=torch.bfloat16, kv_dtype: str = "bf16",
              tp: int = 1) -> "PagedKVCache":
        """Zeroed pools of ``kv_heads`` heads: every rank's at ``tp`` > 1
        (module docstring), whose quantized form is not ported."""
        shape = (num_layers, num_pages, kv_heads, page, head_dim)
        ints = dict(dtype=torch.int32, device=device)
        qdtype, _ = kv_quant_spec(kv_dtype)
        if qdtype is not None and tp > 1:
            raise ValueError(
                f"quantized pools at tp={tp}: the per-rank scale tables are "
                "ROADMAP.md queue A item 8")
        if kv_heads % tp:
            raise ValueError(f"kv_heads={kv_heads} not divisible by tp={tp}")
        pool_dtype = dtype if qdtype is None else qdtype
        scales = [None, None] if qdtype is None else [
            torch.ones(shape[:3], dtype=torch.float32, device=device)
            for _ in range(2)]
        return cls(
            k_pages=torch.zeros(shape, dtype=pool_dtype, device=device),
            v_pages=torch.zeros(shape, dtype=pool_dtype, device=device),
            block_table=torch.zeros((num_slots, p_max), **ints),
            lens=torch.zeros((num_slots,), **ints),
            live=torch.zeros((num_slots,), **ints),
            k_scale=scales[0], v_scale=scales[1])

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def qmax(self) -> float:
        return 127.0 if self.k_pages.dtype == torch.int8 else 448.0

    def layer_scales(self, layer: int):
        """One layer's ``(k_scale, v_scale)``, or ``(None, None)`` on an
        unquantized pool: what every paged-kernel call site passes."""
        if not self.quantized:
            return None, None
        return self.k_scale[layer], self.v_scale[layer]

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
        if self.quantized:
            self._quant_append(layer, k_tok, v_tok)
            return
        page = self.page
        row = (self.lens // page).long()
        pids = torch.gather(self.block_table, 1, row[:, None])[:, 0]
        self._put(layer, pids, self.lens % page, k_tok[:, 0], v_tok[:, 0])

    def append_block(self, layer: int, k_tok, v_tok, budget=None) -> None:
        """Write K consecutive tokens per slot at positions
        ``lens[s] .. lens[s] + K - 1``, in place: the speculative-verify
        form of :meth:`append_decode` (the host commits the accepted
        prefix by advancing only its length mirrors). k_tok/v_tok: (S, K,
        KV, hd). Parked slots write the scratch page, and so do tokens
        past the table row or past the slot's ``budget`` (S,): a
        fixed-K dispatch near a request's token budget must not write a
        real page (or, quantized, grow its scale)."""
        if self.quantized:
            self._quant_append(layer, k_tok, v_tok, budget)
            return
        page = self.page
        k = k_tok.shape[1]
        j = torch.arange(k, dtype=torch.int32, device=self.lens.device)
        pos = self.lens[:, None] + j[None]
        rows_raw = torch.div(pos, page, rounding_mode="floor")
        valid = rows_raw < self.block_table.shape[1]
        if budget is not None:
            valid = valid & (j[None] < budget[:, None])
        rows = torch.clamp(rows_raw, 0, self.block_table.shape[1] - 1)
        pids = torch.where(valid, torch.gather(self.block_table, 1,
                                               rows.long()),
                           torch.full_like(rows, SCRATCH_PAGE))
        self._put(layer, pids.flatten(), (pos % page).flatten(),
                  k_tok.flatten(0, 1), v_tok.flatten(0, 1))

    def _quant_append(self, layer: int, k_tok, v_tok, budget=None) -> None:
        """Quantized slot-range write of :meth:`append_decode` (K = 1) and
        :meth:`append_block`: the touched pages merge under a fresh
        max-abs scale; a page whose first position reaches ``lens`` gets
        a fresh scale."""
        page = self.page
        k = k_tok.shape[1]
        p_max = self.block_table.shape[1]
        dev = self.lens.device
        n_t = (k - 1) // page + 2
        lens = self.lens[:, None]
        rows = (torch.div(lens, page, rounding_mode="floor")
                + torch.arange(n_t, dtype=torch.int32, device=dev)[None])
        rows_c = torch.clamp(rows, 0, p_max - 1).long()
        pids = torch.where(rows < p_max,
                           torch.gather(self.block_table, 1, rows_c),
                           torch.full_like(rows, SCRATCH_PAGE))
        j = torch.arange(k, dtype=torch.int32, device=dev)[None]
        loc = lens % page + j
        mask = torch.div(lens + j, page, rounding_mode="floor") < p_max
        if budget is not None:
            mask = mask & (j < budget[:, None])
        had_prior = rows * page < lens
        for pool, scales, tok in ((self.k_pages, self.k_scale, k_tok),
                                  (self.v_pages, self.v_scale, v_tok)):
            _quant_range_write(pool, scales, layer, pids, loc, tok, mask,
                               had_prior, self.qmax)

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
        if self.quantized:
            self._quant_write_chunk(layer, k_tok, v_tok, table_row,
                                    positions, valid, wfrom)
            return
        pids, offs = chunk_write_ids(positions, table_row, valid, wfrom,
                                     page=self.page)
        self._put(layer, pids, offs, k_tok[:, 0], v_tok[:, 0])

    def _quant_write_chunk(self, layer, k_tok, v_tok, table_row, positions,
                           valid, wfrom) -> None:
        """Quantized chunk write. Positions are consecutive (``start +
        arange(C)``), so the touched pages are a bounded window. Pages
        below the page-aligned ``wfrom`` (prefix-resident, read by
        another request) are swapped for the scratch page: their bytes
        and scales are never rewritten; a page whose first token landed
        in an earlier chunk keeps its running amax."""
        page = self.page
        c = positions.shape[0]
        dev = positions.device
        start = int(positions[0])
        n_t = (c - 1) // page + 2
        row0 = start // page
        rows = row0 + torch.arange(n_t, dtype=torch.int32, device=dev)
        rows_c = torch.clamp(rows, 0, table_row.shape[0] - 1).long()
        writable = rows >= int(wfrom) // page
        pids = torch.where(writable, table_row[rows_c],
                           torch.full_like(rows, SCRATCH_PAGE))[None]
        i = torch.arange(c, dtype=torch.int32, device=dev)
        tok_mask = ((i < int(valid)) & (positions >= int(wfrom)))[None]
        loc = (positions - row0 * page)[None]
        had_prior = ((rows * page < start) & writable)[None]
        for pool, scales, tok in ((self.k_pages, self.k_scale, k_tok),
                                  (self.v_pages, self.v_scale, v_tok)):
            _quant_range_write(pool, scales, layer, pids, loc,
                               tok[:, 0][None], tok_mask, had_prior,
                               self.qmax)

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
        for pool, scales, prompt in ((self.k_pages, self.k_scale, k_prompt),
                                     (self.v_pages, self.v_scale, v_prompt)):
            blocks = prompt.reshape(num_l, n_p, self.page, kvh, hd)
            blocks = blocks.transpose(2, 3)
            if scales is None:
                pool[:, ids] = blocks.to(pool.dtype)
                continue
            # Whole-page quantize, one fresh scale per (layer, page,
            # head); the tail padding is the prefill cache's zeros.
            b32 = blocks.float()
            sc = safe_scale(b32.abs().amax(dim=(3, 4)), self.qmax)
            pool[:, ids] = quantize(b32, sc[..., None, None], pool.dtype,
                                    self.qmax)
            scales[:, ids] = sc

    def gather_pages(self, page_ids):
        """Whole pages as a migration payload: (K, V) each (L, n, KV,
        page, hd) as stored, plus (K_scale, V_scale) each (L, n, KV) on
        a quantized pool, so the receiver dequantizes bit-exactly."""
        ids = torch.as_tensor(page_ids, dtype=torch.long,
                              device=self.k_pages.device)
        k, v = self.k_pages[:, ids], self.v_pages[:, ids]
        if not self.quantized:
            return k, v
        return k, v, self.k_scale[:, ids], self.v_scale[:, ids]

    def scatter_pages(self, k_payload, v_payload, page_ids, k_scale=None,
                      v_scale=None) -> None:
        """Blit a :meth:`gather_pages` payload into this pool's pages, in
        place (ids meant to be dropped point at the scratch page). A
        quantized pool needs the payload's scales, and an unquantized one
        takes none: bytes without their scales are unreadable."""
        if self.quantized and (k_scale is None or v_scale is None):
            raise ValueError(
                "scatter_pages into a quantized pool needs the payload's "
                "k_scale/v_scale (gather_pages returns them) — bytes "
                "without scales are unreadable")
        if not self.quantized and (k_scale is not None
                                   or v_scale is not None):
            raise ValueError(
                "scatter_pages got quantization scales but this pool is "
                "unquantized (kv_dtype mismatch between roles?)")
        ids = torch.as_tensor(page_ids, dtype=torch.long,
                              device=self.k_pages.device)
        self.k_pages[:, ids] = torch.as_tensor(k_payload).to(
            self.k_pages.device, self.k_pages.dtype)
        self.v_pages[:, ids] = torch.as_tensor(v_payload).to(
            self.v_pages.device, self.v_pages.dtype)
        if self.quantized:
            self.k_scale[:, ids] = torch.as_tensor(k_scale).to(
                self.k_scale.device, torch.float32)
            self.v_scale[:, ids] = torch.as_tensor(v_scale).to(
                self.v_scale.device, torch.float32)

    def dense_row(self, layer: int, table_row):
        """ONE slot's pages of one layer, gathered (and dequantized) to
        the dense position-major view (p_max·page, KV, hd) — K and V."""
        ks, vs = self.layer_scales(layer)
        return (gather_pages_dense(self.k_pages[layer], table_row, ks),
                gather_pages_dense(self.v_pages[layer], table_row, vs))

    def dense_layer(self, layer: int):
        """Every slot's pages of one layer, gathered (and dequantized) to
        (num_slots, p_max·page, KV, hd) — K and V."""
        ks, vs = self.layer_scales(layer)
        return (gather_pages_dense(self.k_pages[layer], self.block_table,
                                   ks),
                gather_pages_dense(self.v_pages[layer], self.block_table,
                                   vs))


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
                 native_page_bytes: Optional[int] = None,
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
        self.native_page_bytes = native_page_bytes
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
            # What a resident token costs, and how many more pages the
            # same bytes buy than unquantized pages would.
            out["bytes_per_token"] = self.page_bytes / self.page
            if self.native_page_bytes:
                ratio = self.native_page_bytes / self.page_bytes
                out["capacity_ratio_vs_native"] = round(ratio, 4)
                out["pages_at_native_bytes"] = int(
                    (self.num_pages - 1) * ratio)
        return out
