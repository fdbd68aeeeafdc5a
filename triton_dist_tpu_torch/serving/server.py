"""Continuous-batching server over a paged KV pool (counterpart of the
core of ``triton_dist_tpu/serving/server.py``).

One tick (:meth:`ServingEngine.step`): expire deadlines → admit queued
requests into free slots (pages allocated, backpressure when the pool is
dry) → stream ONE bucketed prefill chunk per prefilling slot → one joint
decode dispatch over every running slot → per-slot sampling, EOS and
slot recycling. A request that cannot get a page mid-decode is preempted:
its pages are freed and it re-enters at the queue head, re-prefilling
prompt + generated tokens through the same chunk plan, so greedy output
is unchanged.

Two lanes, chosen by the engine:

- the layer lane (:class:`~triton_dist_tpu_torch.models.engine.Engine`):
  prefill streams through the bucketed chunk path (the Q-block kernel),
  decode through the paged decode kernel;
- the megakernel lane
  (:class:`~triton_dist_tpu_torch.megakernel.engine.MegaKernelEngine`):
  every decode tick is ONE launch of the persistent megakernel; the paged
  pool lives in the engine, page 0 is the scratch page of parked rows.
  With ``prefill_buckets`` (the same on engine and server) prompts enter
  through the same chunk stream as the layer lane, each chunk ONE
  megakernel launch of the chunk task pair (:class:`~triton_dist_tpu_torch.
  serving.chunked.MegaChunkedPrefill`); without, they stream one token
  per tick through the decode launch (the prefill lane) while running
  slots decode beside them.

The engine's model may be dense Qwen3 or Qwen3-MoE. On the megakernel
lane a MoE engine routes inside the kernel and counts every routed
(row, expert) pair; the server folds each decode tick's counts into
``expert_totals`` and a load EWMA (``expert_ewma``, ``stats()
["expert_load"]``) and, every ``REBALANCE_EVERY`` ticks, hands a changed
hot-expert set to a dynamic-schedule engine's claim priorities
(:meth:`MegaKernelEngine.set_expert_load`). The expert-parallel decode
transports and hot-expert replicas are not ported (ROADMAP.md, queue A
item 5).

On the layer lane, ``prefill_buckets=None`` (the default) admits each
prompt monolithically: one dense-cache :meth:`Engine.prefill` of the
whole sequence (the prefill flash-attention kernel; a fused MoE engine's
grouped expert GEMM), whose K/V is blitted into the slot's pages.

``kv_dtype="int8"|"fp8"`` stores the K/V pools quantized, one fp32 scale
per (layer, page, kv_head) beside them (:mod:`.blocks`); ``spec_k=K``
(K >= 2) replaces each decode dispatch by ONE K-token verify dispatch over
an n-gram self-draft (:mod:`.spec`): greedy acceptance commits the
accepted prefix, the rejected suffix's page growth rolls back. On the
megakernel lane both are ENGINE knobs (``MegaKernelEngine(kv_dtype=...,
spec_k=...)``), and the server's must match them.

On a CUDA engine the kernels are the hand-written ones, on a CPU engine
their plain versions. KV tiers, SLO scheduling, trace telemetry and the
resilience hooks are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from triton_dist_tpu_torch.megakernel.engine import MegaKernelEngine
from triton_dist_tpu_torch.serving.blocks import (
    BlockManager, OutOfPagesError, PagedKVCache, kv_quant_spec,
)
from triton_dist_tpu_torch.serving.chunked import (
    ChunkedPrefill, MegaChunkedPrefill)
from triton_dist_tpu_torch.serving.scheduler import (
    Request, RequestHandle, Scheduler,
)
from triton_dist_tpu_torch.serving.spec import NgramDraft, accept_greedy

# MoE megakernel lane: decode ticks between hand-offs of the expert-load
# EWMA to a dynamic-schedule engine, the EWMA share over the mean that
# makes an expert hot, and the EWMA's weight of each tick (the JAX
# server's defaults).
REBALANCE_EVERY = 8
HOT_EXPERT_FACTOR = 2.0
LOAD_ALPHA = 0.25


def sample_seed(seed: int, step: int) -> int:
    """Per-(request seed, step) generator seed, so a request samples the
    same tokens alone or in a shared batch."""
    return ((int(seed) & 0xFFFFFFFF) << 32 | (int(step) & 0xFFFFFFFF))


class ServingEngine:
    """Continuous-batching server over an
    :class:`~triton_dist_tpu_torch.models.engine.Engine` (layer lane) or a
    :class:`~triton_dist_tpu_torch.megakernel.engine.MegaKernelEngine`
    (megakernel lane).

    ``num_slots``: decode-batch width. ``page``: tokens per KV page (must
    divide the engine's ``max_len``). ``num_pages``: pool size including
    the reserved scratch page (default: full residency for every slot;
    undersize it to exercise backpressure and preemption). ``policy``:
    ``"continuous"`` | ``"static"``. ``prefill_buckets``: the chunk
    lengths prompts stream through; ``None`` on the layer lane admits
    each prompt with one monolithic :meth:`Engine.prefill` and blits its
    K/V into the pages. ``clock`` is injectable for deadline
    tests. On the megakernel lane the engine must be paged; its batch,
    page and pool are the server's (``num_slots``, ``page`` and
    ``num_pages`` are not read, as in the JAX server), and
    ``prefill_buckets`` must equal the engine's (its chunk builds are made
    at engine construction): ``None`` on both keeps the one-token prefill
    lane.

    ``kv_dtype``: ``"bf16"`` keeps the pool at the engine's dtype;
    ``"int8"``/``"fp8"`` quantize it per page. ``spec_k``: 0 (or 1) is
    plain one-token decode, K >= 2 speculative decoding with an n-gram
    draft of up to ``spec_ngram`` tokens. On the megakernel lane both
    must equal the engine's (a mismatch raises).
    """

    def __init__(self, engine, *, num_slots: Optional[int] = None,
                 page: Optional[int] = None,
                 num_pages: Optional[int] = None, max_queue: int = 64,
                 policy: str = "continuous", prefix_reuse: bool = False,
                 clock=time.monotonic,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 kv_dtype: str = "bf16", spec_k: int = 0,
                 spec_ngram: int = 3):
        self.engine = engine
        self.cfg = cfg = engine.cfg
        self.max_len = engine.max_len
        self.device = engine.device
        self.mega = isinstance(engine, MegaKernelEngine)
        kv_quant_spec(kv_dtype)            # validate the knob early
        self.kv_dtype = kv_dtype
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if self.spec_k == 1:
            self.spec_k = 0                # K = 1 is plain decode
        self._draft = NgramDraft(spec_ngram)
        if prefill_buckets:
            prefill_buckets = tuple(sorted(set(
                int(b) for b in prefill_buckets)))
        if self.mega:
            # kv_dtype and spec_k are engine knobs on this lane (the pools,
            # scale tables and verify build are made with the engine).
            if kv_quant_spec(kv_dtype)[0] is None:
                kv_dtype = "bf16"          # every unquantized spelling
            if kv_dtype != engine.kv_dtype:
                raise ValueError(
                    f"megakernel kv_dtype mismatch: the engine stores "
                    f"{engine.kv_dtype!r} pools but the serving layer was "
                    f"asked for {kv_dtype!r}; construct MegaKernelEngine("
                    f"kv_dtype={kv_dtype!r}, paged=True) and pass the same "
                    "value here")
            self.kv_dtype = kv_dtype
            if self.spec_k != engine.spec_k:
                raise ValueError(
                    f"megakernel spec_k mismatch: the engine was built with "
                    f"spec_k={engine.spec_k} but the serving layer was asked "
                    f"for {self.spec_k}; construct MegaKernelEngine("
                    "spec_k=K, paged=True) and pass the same K here")
            eng_buckets = engine.prefill_buckets
            if (prefill_buckets or None) != (eng_buckets or None):
                raise ValueError(
                    f"megakernel prefill_buckets mismatch: the engine was "
                    f"built with prefill_buckets={eng_buckets} but the "
                    f"serving layer was asked for {prefill_buckets}; "
                    "construct MegaKernelEngine(prefill_buckets=..., "
                    "paged=True) and pass the same buckets here")
            if not engine.paged:
                raise NotImplementedError(
                    "serving a dense-cache MegaKernelEngine is not ported "
                    "(ROADMAP.md); construct it with paged=True")
            num_slots = engine.batch
            page = engine.builder.page
            num_pages = engine.num_pages
            need = num_slots * engine.builder.p_max + 1
            if num_pages < need:
                raise ValueError(
                    "paged megakernel serving reserves page 0 as scratch: "
                    "construct the engine with num_pages >= batch*p_max+1 "
                    f"(= {need}, got {num_pages})")
        else:
            num_slots = num_slots or 4
            page = page or math.gcd(self.max_len, 32)
            if self.max_len % page:
                raise ValueError(f"page={page} must divide max_len="
                                 f"{self.max_len}")
        self.page = page
        self.p_max = self.max_len // page
        self.plan = cfg.kv_cache_plan(
            max_len=self.max_len, page=page, num_slots=num_slots,
            dtype_bytes=engine.dtype.itemsize, kv_dtype=self.kv_dtype)
        num_pages = num_pages or self.plan["num_pages"]
        self.manager = BlockManager(
            num_pages, page, self.p_max, prefix_reuse=prefix_reuse,
            page_bytes=self.plan["page_bytes_per_rank"],
            native_page_bytes=self.plan["native_page_bytes_per_rank"])
        self.cache = self.chunker = self.prefill_buckets = None
        if self.mega:
            if prefill_buckets:
                self.prefill_buckets = prefill_buckets
                self.chunker = MegaChunkedPrefill(engine)
        else:
            if self.spec_k and not hasattr(engine.model,
                                           "verify_step_paged"):
                raise NotImplementedError(
                    f"model {engine.model.__name__!r} has no "
                    "verify_step_paged: speculative decoding needs the "
                    "K-token verify contract")
            self.cache = PagedKVCache.empty(
                cfg.num_hidden_layers, num_pages, page,
                cfg.num_key_value_heads, cfg.head_dim, num_slots=num_slots,
                p_max=self.p_max, device=self.device, dtype=engine.dtype,
                kv_dtype=self.kv_dtype)
            if prefill_buckets:
                self.prefill_buckets = prefill_buckets
                self.chunker = ChunkedPrefill(engine, prefill_buckets)
        # The megakernel's one-token prefill lane: prompts ride the decode
        # launch (no chunker).
        self._lane = self.mega and self.chunker is None
        self.sched = Scheduler(num_slots, max_queue=max_queue,
                               policy=policy, clock=clock)
        self.num_slots = num_slots
        # Host mirrors of the per-slot device state: scheduling decisions
        # never read the device.
        self._lens = np.zeros((num_slots,), np.int32)
        self._live = np.zeros((num_slots,), np.int32)
        self._toks = np.zeros((num_slots,), np.int32)
        # Expert-load telemetry (MoE megakernel lane): totals and EWMA of
        # the routed (row, expert) counts of each decode tick.
        self._mk_counts_base = None
        self._mk_load_sig = None
        self.expert_totals = np.zeros((cfg.num_experts,), np.int64)
        self.expert_ewma = np.zeros((cfg.num_experts,), np.float64)
        self.stats_counters = {
            "decode_dispatches": 0, "tokens_generated": 0,
            "prefill_tokens": 0, "prefill_calls": 0, "prefill_chunks": 0,
            "admit_stalls": 0, "preemptions": 0, "decode_tokens": 0,
            "decode_time_s": 0.0, "prefill_time_s": 0.0,
            "spec_drafted": 0, "spec_accepted": 0,
            "spec_sampled_fallbacks": 0,
            "greedy_ref_tokens": 0, "greedy_agree_tokens": 0,
        }

    # -- public API --------------------------------------------------

    def submit(self, request, **kw) -> RequestHandle:
        """Queue a request (a :class:`Request`, or a prompt sequence plus
        :class:`Request` kwargs). Raises
        :class:`~triton_dist_tpu_torch.serving.scheduler.QueueFullError`
        on backpressure and ``ValueError`` for a request that could never
        fit."""
        if isinstance(request, Request):
            if kw:
                raise TypeError(
                    f"keyword args {sorted(kw)} ignored when passing a "
                    "Request — set them on the Request itself")
        else:
            request = Request(prompt=list(request), **kw)
        if len(request.prompt) == 0:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(request.prompt) + request.max_new_tokens
        cap = self.p_max * self.page
        if total > cap or total > self.max_len:
            raise ValueError(
                f"prompt {len(request.prompt)} + gen "
                f"{request.max_new_tokens} exceeds capacity "
                f"{min(cap, self.max_len)}")
        return self.sched.submit(request)

    def step(self) -> int:
        """One serving tick (see module docstring). Returns how many live
        slots decoded (0 = no decode this tick)."""
        now = self.sched.now()
        for h in self.sched.expired(now):
            self._retire(h, "timeout", TimeoutError(
                f"request {h.request.request_id} missed deadline "
                f"{h.request.deadline} (now {now})"))
        stalled: List[RequestHandle] = []
        for h in self.sched.admit():
            self._admit(h, stalled)
        # Pool-starved admissions go back to the queue head in their
        # original order.
        for h in reversed(stalled):
            self.sched.queue.appendleft(h)
        self._advance_chunks()
        return self._decode_tick()

    def run(self, *, max_steps: int = 100000) -> None:
        """Drive :meth:`step` until queue and slots drain."""
        for _ in range(max_steps):
            if self.sched.idle:
                return
            self.step()
        raise RuntimeError(f"serving loop did not drain in {max_steps} "
                           "steps")

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, **kw) -> List[List[int]]:
        """Submit every prompt, run to idle, return per-prompt token lists
        (order preserved). Raises if any request did not finish."""
        handles = [self.submit(p, max_new_tokens=max_new_tokens, **kw)
                   for p in prompts]
        self.run()
        for h in handles:
            if h.status != "done":
                raise RuntimeError(
                    f"request {h.request.request_id} ended "
                    f"{h.status}: {h.error!r}") from h.error
        return [h.tokens for h in handles]

    def stats(self) -> dict:
        """Serving and scheduler counters, pool health and throughput."""
        c = self.stats_counters
        out = dict(c)
        out.update(self.sched.counters)
        out["queue_depth"] = len(self.sched.queue)
        out["live_slots"] = int(self._live.sum())
        out["engine_kind"] = "mega" if self.mega else "layer"
        out["prefill_buckets"] = list(self.prefill_buckets or ())
        out["prefill_cache_size"] = (self.chunker.cache_size()
                                     if self.chunker else 0)
        out["pool"] = self.manager.fragmentation()
        out["plan"] = self.plan
        out["device"] = str(self.device)
        out["dispatch_transport"] = (
            "in-kernel-tp" if self.mega and self.cfg.is_moe else None)
        if self._mk_counts_base is not None or self.expert_totals.any():
            out["expert_load"] = self.expert_ewma.tolist()
            out["expert_totals"] = self.expert_totals.tolist()
        # Decode-emitted tokens over decode-dispatch time only: the first
        # token of each request comes from prefill.
        out["tokens_per_s"] = (c["decode_tokens"] / c["decode_time_s"]
                               if c["decode_time_s"] > 0 else None)
        out["prefill_tokens_per_s"] = (
            c["prefill_tokens"] / c["prefill_time_s"]
            if c["prefill_time_s"] > 0 else None)
        # Which storage the pools ride and what a resident token costs.
        out["kv_dtype"] = self.kv_dtype
        out["kv_bytes_per_token"] = self.plan["bytes_per_token"]
        out["mk_kv_dtype"] = self.kv_dtype if self.mega else None
        out["mk_spec"] = self.spec_k if self.mega else None
        if self.spec_k:
            drafted = c["spec_drafted"]
            out["spec"] = {
                "k": self.spec_k, "drafted": drafted,
                "accepted": c["spec_accepted"],
                "sampled_fallbacks": c["spec_sampled_fallbacks"],
                "accept_rate": (c["spec_accepted"] / drafted
                                if drafted else None),
                "tokens_per_dispatch": (c["decode_tokens"]
                                        / max(c["decode_dispatches"], 1)),
            }
        if c["greedy_ref_tokens"]:
            out["greedy_agreement"] = (c["greedy_agree_tokens"]
                                       / c["greedy_ref_tokens"])
        return out

    def compare_greedy(self, pairs) -> float:
        """Fold the greedy-token agreement of ``(got_tokens,
        reference_tokens)`` pairs (a quantized run against a bf16-pool
        run of the same prompts) into the counters, surfaced as
        ``stats()["greedy_agreement"]``. Returns the running agreement."""
        c = self.stats_counters
        for got, want in pairs:
            n = min(len(got), len(want))
            c["greedy_ref_tokens"] += n
            c["greedy_agree_tokens"] += sum(
                1 for a, b in zip(got[:n], want[:n]) if a == b)
        ref = c["greedy_ref_tokens"]
        return c["greedy_agree_tokens"] / ref if ref else 1.0

    # -- admission / chunked prefill ---------------------------------

    def _unadmit(self, h: RequestHandle, error: OutOfPagesError,
                 stalled: List[RequestHandle]):
        """Roll an admitted request back (pool dry); the caller requeues
        ``stalled`` at the head. If nothing else holds a slot, no future
        retirement can free pages, so fail it instead of spinning."""
        self.sched.slots.pop(h.slot, None)
        h.slot = None
        if not self.sched.slots:
            self._retire(h, "failed", error)
            return
        h.status, h.started_at = "queued", None
        h.queued_at = self.sched.now()
        stalled.append(h)
        self.stats_counters["admit_stalls"] += 1

    def _admit(self, h: RequestHandle, stalled: List[RequestHandle]):
        """Allocate the slot's pages and enter the chunk stream. A
        preempted request re-enters with prompt + every already-fed
        generated token (the last generated token was never fed and
        re-enters through decode). Prefix hits skip already-resident
        pages: the cursor starts at the first non-shared page, clamped so
        the last token always runs (its logits seed the first generated
        token), and those pages are never rewritten (``wfrom``)."""
        slot = h.slot
        seq = list(h.request.prompt) + [int(t) for t in h.tokens[:-1]]
        try:
            pages = self.manager.alloc_prefill(slot, seq)
        except OutOfPagesError as e:
            self._unadmit(h, e, stalled)
            return
        if self._lane:
            # Prefill lane: ``seq`` streams through the decode launch one
            # token per tick, from position 0.
            h.lane = seq
            h.prompt_pos = 0
            h.status = "prefill"
            self._lens[slot] = 0
            self._live[slot] = 1
            self._toks[slot] = seq[0]
            return
        if self.chunker is None:
            self._admit_monolithic(h, seq, pages)
            return
        h.resident = self.manager.prefix_hits(slot) * self.page
        h.lane = seq
        h.prompt_pos = min(h.resident, len(seq) - 1)
        h.chunks = []
        h.status = "prefill"
        # Parked until the prompt is resident: the decode dispatch sees
        # live=0 and a scratch table row for this slot.
        self._lens[slot] = 0
        self._live[slot] = 0
        self._toks[slot] = 0

    def _admit_monolithic(self, h: RequestHandle, seq: List[int],
                          pages: List[int]):
        """Monolithic admission (``prefill_buckets=None`` on the layer
        lane): one :meth:`Engine.prefill` of the whole (1, len) sequence,
        then a blit of only the pages that are not prefix hits (shared
        pages keep the first sharer's bytes), then the pages are
        published for sharing and the slot goes live with its first
        token. A failing prefill releases the slot and re-raises."""
        slot = h.slot
        t0 = time.perf_counter()
        try:
            logits, kv = self.engine.prefill(np.asarray([seq], np.int32))
            hits = self.manager.prefix_hits(slot)
            if hits < len(pages):
                span = slice(hits * self.page, len(pages) * self.page)
                self.cache.write_prompt(kv.k[:, 0, span], kv.v[:, 0, span],
                                        pages[hits:])
            logits = logits[0].cpu().numpy()
        except Exception as e:  # noqa: BLE001 — release the slot, re-raise
            self._retire(h, "failed", e)
            raise
        c = self.stats_counters
        c["prefill_time_s"] += time.perf_counter() - t0
        c["prefill_calls"] += 1
        c["prefill_tokens"] += len(seq)
        h.lane = seq
        self._activate(h, logits)

    def _advance_chunks(self):
        """One bucketed chunk per prefilling slot per tick (the
        megakernel's prefill lane rides the decode launch instead)."""
        if self._lane:
            return
        for h in list(self.sched.running()):
            if h.status == "prefill":
                self._advance_chunk(h)

    def _advance_chunk(self, h: RequestHandle):
        slot, seq, start = h.slot, h.lane, h.prompt_pos
        bucket, valid = self.chunker.next_chunk(len(seq) - start)
        toks = np.zeros((bucket,), np.int32)
        toks[:valid] = seq[start:start + valid]
        row = np.asarray(self.manager.table_row(slot), np.int32)
        t0 = time.perf_counter()
        try:
            logits = self.chunker.step(self.engine.params, toks, self.cache,
                                       row, start, h.resident, valid)
            logits = logits.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — release the slot, re-raise
            self._retire(h, "failed", e)
            raise
        c = self.stats_counters
        c["prefill_time_s"] += time.perf_counter() - t0
        c["prefill_chunks"] += 1
        c["prefill_tokens"] += valid
        h.chunks.append((start, bucket, valid))
        h.prompt_pos = start + valid
        if h.prompt_pos >= len(seq):
            c["prefill_calls"] += 1
            self._activate(h, logits)

    def _activate(self, h: RequestHandle, logits: np.ndarray):
        """Flip a fully prefilled slot live; seed the first generated
        token from the last chunk's last-valid-token logits (a resumed
        request already knows its next token)."""
        slot = h.slot
        # Every page's content is written: publish the staged prefix.
        self.manager.commit_prefix(slot)
        self._lens[slot] = len(h.lane)
        self._live[slot] = 1
        h.status = "running"
        if not h.tokens:
            self._emit(h, self._pick(logits, h.request, 0))

    # -- decode ------------------------------------------------------

    def _decode_tick(self) -> int:
        if self.spec_k:
            return self._spec_tick()
        # Megakernel prefill-lane slots ride the decode launch; slots
        # mid-chunk-stream stay parked until their prompt is resident.
        active = [h for h in self.sched.running()
                  if h.status == "running"
                  or (self._lane and h.status == "prefill")]
        if not active:
            return 0
        preempted = []
        for h in active:
            slot = h.slot
            lane = self._lane and h.status == "prefill"
            self._toks[slot] = h.lane[h.prompt_pos] if lane else h.tokens[-1]
            if lane:
                # Lane tokens land in pages alloc_prefill reserved.
                continue
            try:
                # Page-boundary growth for the token written this step.
                # A row overflow is a caller bug (submit validates the
                # capacity) and propagates.
                self.manager.append(slot, int(self._lens[slot]))
            except OutOfPagesError as e:
                # Pool dry mid-decode: preempt this request (pages freed,
                # requeued at the head, resumed by re-prefill).
                self._preempt(h, e)
                preempted.append(h)
        active = [h for h in active if h not in preempted]
        if not active:
            return 0
        tbl = np.zeros((self.num_slots, self.p_max), np.int32)
        for h in active:
            tbl[h.slot] = self.manager.table_row(h.slot)
        t0 = time.perf_counter()
        logits = self._dispatch(tbl)
        c = self.stats_counters
        c["decode_time_s"] += time.perf_counter() - t0
        c["decode_dispatches"] += 1
        self._maybe_rebalance()
        for h in active:
            self._lens[h.slot] += 1
            if self._lane and h.status == "prefill":
                h.prompt_pos += 1
                if h.prompt_pos < len(h.lane):
                    continue
                # The lane's last token: its page is written, so the
                # prompt's pages are shareable from here.
                h.status = "running"
                self.manager.commit_prefix(h.slot)
                if h.tokens:
                    # A resumed lane already knows its next token.
                    continue
            h.decode_steps += 1
            c["decode_tokens"] += 1
            self._emit(h, self._pick(logits[h.slot], h.request,
                                     len(h.tokens)))
        return len(active)

    def _dispatch(self, tbl: np.ndarray) -> np.ndarray:
        """The joint decode step over every slot; returns host logits
        (num_slots, vocab)."""
        if self.mega:
            # This tick's allocator table (flat, the builder's layout);
            # parked rows point at the scratch page.
            self.engine.block_table = tbl.reshape(-1)
            moe = self.cfg.is_moe
            if moe and self._mk_counts_base is None:
                # The counters only grow: snapshot them before the first
                # serving dispatch, so traffic from before does not count.
                self._mk_counts_base = self.engine.expert_counts()
            logits = self.engine.decode_step(self._toks,
                                             self._lens).cpu().numpy()
            if moe:
                total = self.engine.expert_counts()
                self._note_expert_counts(total - self._mk_counts_base)
                self._mk_counts_base = total
            return logits
        cache = self.cache
        cache.block_table.copy_(torch.from_numpy(tbl))
        cache.lens.copy_(torch.from_numpy(self._lens))
        cache.live.copy_(torch.from_numpy(self._live))
        toks = torch.from_numpy(self._toks).to(self.device)
        logits = self.engine.model.decode_step_paged(
            self.engine.params, toks, cache, self.cfg)
        return logits.cpu().numpy()

    # -- the speculative tick (spec_k >= 2) ---------------------------

    def _draft_slot(self, h: RequestHandle, kk: int):
        """Account a running slot's candidate positions with the
        allocator and draft its K candidates. Returns ``(draft, budget)``
        (``budget``: how many candidates may commit and write real pages,
        bounded by the request's remaining tokens), or None when the pool
        ran dry and the request was preempted."""
        slot = h.slot
        base = int(self._lens[slot])
        n_pre = max(1, min(kk, h.request.max_new_tokens - len(h.tokens)))
        try:
            for j in range(n_pre):
                self.manager.append(slot, base + j)
        except OutOfPagesError as e:
            # Pool dry mid-draft: preempt; the resume replays the same
            # history, so the draft replays too.
            self._preempt(h, e)
            return None
        d = [int(h.tokens[-1])]
        if h.request.temperature <= 0.0:
            hist = list(h.request.prompt) + [int(t) for t in h.tokens]
            d += self._draft.propose(hist, kk - 1)
            # Only candidates that could commit count: accept_rate
            # measures the draft, not the budget's clipping.
            self.stats_counters["spec_drafted"] += n_pre - 1
        else:
            d += [d[-1]] * (kk - 1)        # sampled: commits one at most
            self.stats_counters["spec_sampled_fallbacks"] += 1
        return d, n_pre

    def _commit_block(self, h: RequestHandle, d, logits_rows,
                      budget: int) -> None:
        """Greedy acceptance of one slot's verified block: commit the
        accepted prefix (lengths, page accounting rolled back to it)
        BEFORE emitting, since an emission may retire the request."""
        slot, kk = h.slot, len(d)
        h.decode_steps += 1
        greedy = h.request.temperature <= 0.0
        if greedy:
            picks = [int(np.argmax(logits_rows[j])) for j in range(kk)]
            m = accept_greedy(d, picks)
        else:
            m = 1
        m = min(m, budget)
        if greedy:
            self.stats_counters["spec_accepted"] += m - 1
        base = int(self._lens[slot])
        self._lens[slot] = base + m
        self.manager.truncate_to(slot, base + m)
        self.stats_counters["decode_tokens"] += m
        for j in range(m):
            if h.done:
                break
            self._emit(h, picks[j] if greedy else self._pick(
                logits_rows[j], h.request, len(h.tokens)))

    def _spec_tick(self) -> int:
        """One tick through the K-token verify dispatch: draft, one
        fixed-shape dispatch, greedy acceptance, commit the accepted
        prefix. Greedy tokens are those of the non-speculative loop;
        sampled requests commit one token from position 0's logits."""
        if self.mega:
            return self._spec_tick_mega()
        active = [h for h in self.sched.running() if h.status == "running"]
        kk = self.spec_k
        drafts, budget = {}, np.zeros((self.num_slots,), np.int32)
        for h in active:
            got = self._draft_slot(h, kk)
            if got is not None:
                drafts[h.slot], budget[h.slot] = got
        active = [h for h in active if h.slot in drafts]
        if not active:
            return 0
        tbl = np.zeros((self.num_slots, self.p_max), np.int32)
        toks = np.zeros((self.num_slots, kk), np.int32)
        for h in active:
            tbl[h.slot] = self.manager.table_row(h.slot)
            toks[h.slot] = drafts[h.slot]
        t0 = time.perf_counter()
        cache = self.cache
        cache.block_table.copy_(torch.from_numpy(tbl))
        cache.lens.copy_(torch.from_numpy(self._lens))
        cache.live.copy_(torch.from_numpy(self._live))
        logits = self.engine.model.verify_step_paged(
            self.engine.params, torch.from_numpy(toks).to(self.device),
            cache, self.cfg,
            budget=torch.from_numpy(budget).to(self.device)).cpu().numpy()
        c = self.stats_counters
        c["decode_time_s"] += time.perf_counter() - t0
        c["decode_dispatches"] += 1
        for h in active:
            self._commit_block(h, drafts[h.slot], logits[h.slot],
                               int(budget[h.slot]))
        return len(active)

    def _spec_tick_mega(self) -> int:
        """The megakernel's speculative tick: ONE Q-block verify launch
        (:meth:`MegaKernelEngine.verify_step`). Running slots feed their K
        candidates at per-row positions (over-budget rows at -1: the
        kernel masks them, so they touch no page and no scale);
        prefill-lane slots ride row (slot, 0) with the lane's next token,
        rows 1..K-1 masked."""
        kk = self.spec_k
        active = [h for h in self.sched.running()
                  if h.status == "running"
                  or (self._lane and h.status == "prefill")]
        drafts, budget = {}, np.zeros((self.num_slots,), np.int32)
        pos = np.full((self.num_slots * kk,), -1, np.int32)
        toks = np.zeros((self.num_slots, kk), np.int32)
        keep = []
        for h in active:
            slot, base = h.slot, int(self._lens[h.slot])
            if h.status == "prefill":
                # Lane tokens land in pages alloc_prefill reserved.
                toks[slot, 0] = h.lane[h.prompt_pos]
                pos[slot * kk] = base
                keep.append(h)
                continue
            got = self._draft_slot(h, kk)
            if got is None:
                continue
            drafts[slot], budget[slot] = got
            toks[slot] = drafts[slot]
            pos[slot * kk:slot * kk + budget[slot]] = \
                base + np.arange(budget[slot])
            keep.append(h)
        active = keep
        if not active:
            return 0
        tbl = np.zeros((self.num_slots, self.p_max), np.int32)
        for h in active:
            tbl[h.slot] = self.manager.table_row(h.slot)
        self.engine.block_table = tbl.reshape(-1)
        moe = self.cfg.is_moe
        if moe and self._mk_counts_base is None:
            self._mk_counts_base = self.engine.expert_counts()
        t0 = time.perf_counter()
        logits = self.engine.verify_step(toks.reshape(-1), pos)
        logits = logits.cpu().numpy()
        c = self.stats_counters
        c["decode_time_s"] += time.perf_counter() - t0
        c["decode_dispatches"] += 1
        if moe:
            total = self.engine.expert_counts()
            self._note_expert_counts(total - self._mk_counts_base)
            self._mk_counts_base = total
        self._maybe_rebalance()
        for h in active:
            slot = h.slot
            if h.status == "prefill":
                self._lens[slot] += 1
                h.prompt_pos += 1
                if h.prompt_pos < len(h.lane):
                    continue
                h.status = "running"       # the lane's last token
                self.manager.commit_prefix(slot)
                if h.tokens:
                    continue               # a resumed lane knows its next
                h.decode_steps += 1
                c["decode_tokens"] += 1
                self._emit(h, self._pick(logits[slot, 0], h.request, 0))
                continue
            self._commit_block(h, drafts[slot], logits[slot],
                               int(budget[slot]))
        return len(active)

    # -- expert-load telemetry + hot-expert rebalancing --------------

    def _note_expert_counts(self, counts: np.ndarray):
        """Fold one tick's per-expert routed counts into the totals and
        the load EWMA (of each tick's share per expert)."""
        counts = np.asarray(counts, np.int64)
        if counts.sum() <= 0:
            return
        self.expert_totals += counts
        a = LOAD_ALPHA
        self.expert_ewma = ((1.0 - a) * self.expert_ewma
                            + a * (counts / counts.sum()))

    def _maybe_rebalance(self):
        """Every ``REBALANCE_EVERY`` decode dispatches, hand the load EWMA
        to the megakernel's claim priorities (a dynamic-schedule engine
        only)."""
        if (not self.mega or self.stats_counters["decode_dispatches"]
                % REBALANCE_EVERY):
            return
        ewma = self.expert_ewma
        if ewma.size == 0 or ewma.sum() <= 0:
            return
        self._rebalance_megakernel(ewma)

    def _rebalance_megakernel(self, ewma: np.ndarray):
        """Re-prioritize the dynamic claim order when the SET of hot
        experts (EWMA > ``HOT_EXPERT_FACTOR`` x mean) changes; an emptied
        hot set restores the uniform order once. A re-prioritization
        re-emits claim tables, so an unchanged set never triggers one."""
        eng = self.engine
        if eng.schedule != "dynamic":
            return
        hot = frozenset(int(e) for e in np.nonzero(
            ewma > HOT_EXPERT_FACTOR * ewma.mean())[0])
        if hot == self._mk_load_sig or (not hot
                                        and self._mk_load_sig is None):
            return
        eng.set_expert_load(ewma.tolist() if hot else None)
        self._mk_load_sig = hot or None

    # -- per-request token handling ---------------------------------

    def _pick(self, logits_row: np.ndarray, req: Request, step: int) -> int:
        """Greedy (first maximum, as the JAX server's ``np.argmax``), or
        a temperature / top-k sample from a ``torch.Generator`` seeded by
        (request seed, step). Samples do not reproduce JAX's
        ``jax.random`` bits."""
        if req.temperature <= 0.0:
            return int(np.argmax(logits_row))
        lg = torch.as_tensor(logits_row, dtype=torch.float32) / req.temperature
        if req.top_k > 0:
            kth = torch.topk(lg, req.top_k).values[-1]
            lg = lg.masked_fill(lg < kth, float("-inf"))
        gen = torch.Generator().manual_seed(sample_seed(req.seed, step))
        return int(torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                     generator=gen))

    def _emit(self, h: RequestHandle, tok: int):
        h.tokens.append(int(tok))
        self.stats_counters["tokens_generated"] += 1
        if h.request.stream_cb is not None:
            h.request.stream_cb(int(tok), h)
        hit_eos = h.request.eos_id is not None and tok == h.request.eos_id
        if hit_eos or len(h.tokens) >= h.request.max_new_tokens:
            self._retire(h, "done")

    def _preempt(self, h: RequestHandle, error: OutOfPagesError):
        """Evict a starving request mid-decode: free its pages, park its
        slot, requeue it at the HEAD for a resume re-prefill. If it was
        the only slot holder, nothing can ever free pages for it — fail
        it instead of spinning."""
        slot = h.slot
        self.sched.slots.pop(slot, None)
        h.slot = None
        self._live[slot] = 0
        self._lens[slot] = 0
        self._toks[slot] = 0
        self.manager.free_slot(slot)
        if not self.sched.slots:
            self._retire(h, "failed", error)
            return
        h.status = "queued"
        h.queued_at = self.sched.now()
        self.sched.queue.appendleft(h)
        self.stats_counters["preemptions"] += 1

    def _retire(self, h: RequestHandle, status: str, error=None):
        slot = h.slot
        self.sched.retire(h, status, error)
        if slot is not None:
            self._live[slot] = 0
            self._lens[slot] = 0
            self._toks[slot] = 0
            self.manager.free_slot(slot)

