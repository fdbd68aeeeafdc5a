"""Megakernel inference engine: greedy decode where every step is ONE
launch of the persistent kernel (counterpart of
``triton_dist_tpu/megakernel/engine.py``, without a mesh: one card).

The whole step runs inside the kernel: the embedding gather, the norms,
the projections, rope, attention over the KV cache, SwiGLU (or, for a
Qwen3-MoE config, the router, every expert and the weighted combine) and
the LM head — token ids in, logits out. Besides the decode step, an engine may
carry one prefill-chunk build per bucket (``prefill_buckets``: one launch
per bucketed prompt chunk of one slot) or one batched-prefill build
(``prefill_seq``: one launch per (batch, S) prompt), and a Q-block verify
build (``spec_k``: one launch scores K drafted tokens of every slot);
every build shares the one arena. ``kv_dtype="int8"|"fp8"`` stores the
paged pools quantized with per-(layer, page, kv_head) scale tables.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from triton_dist_tpu_torch.megakernel.builder import ModelBuilder
from triton_dist_tpu_torch.models import dense, qwen_moe
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.engine import resolve_device


class MegaKernelEngine:
    """``params``: a :class:`~triton_dist_tpu_torch.models.dense.DenseLM`
    (a :class:`~triton_dist_tpu_torch.models.qwen_moe.MoELM` for a MoE
    config; for example from :func:`~triton_dist_tpu_torch.models.convert.
    from_jax_params`), or ``None`` for random weights drawn on the device
    from a ``torch.Generator`` seeded with ``seed``. The weights are
    packed into the arena in ``dtype`` (bf16 on the card, which is what
    the CUDA kernel takes; fp32 for the plain version on the CPU) and the
    model is dropped unless ``keep_params``. A MoE model with random
    weights and no ``keep_params`` is drawn and packed one layer at a
    time, so the card never holds the weights twice.

    A MoE engine routes inside the kernel and counts every routed (row,
    expert) pair of every build's launches in one int32 buffer,
    :attr:`counts` (``moe_counts`` rows x w; :meth:`expert_counts` sums
    it); :meth:`set_expert_load` re-prioritizes a
    ``schedule="dynamic"`` engine's claim order toward hot experts.

    ``paged=True`` keeps the KV cache as page pools (layers, num_pages,
    page, kv, hd) read through :attr:`block_table` (a serving layer
    installs its allocator's table per step); ``paged=False`` keeps one
    (max_len,) row per batch slot. ``device=None`` means the card.

    ``prefill_buckets=(C1, C2, ...)`` (paged only) also builds one
    prefill-chunk step per bucket (:meth:`prefill_chunk`: one launch takes
    a C-token prompt chunk of one slot); ``prefill_seq=S`` instead builds
    the batched prefill (:meth:`prefill`: one launch takes a (batch, S)
    prompt). The two exclude each other, as in the JAX engine.

    ``kv_dtype``: ``"bf16"`` keeps the pools at ``dtype``; ``"int8"`` /
    ``"fp8"`` store them at one byte per element with (layers, num_pages,
    kv) fp32 scale tables :attr:`k_scale`/:attr:`v_scale` (ones at
    first), quantize fused into the write task and dequantize into every
    attention read. ``spec_k=K`` (>= 2; 1 means 0) also builds the Q-block
    verify step (:meth:`verify_step`). Both need ``paged=True`` and
    exclude ``prefill_seq``: prompts stream through the one-token lane or
    the chunk builds."""

    def __init__(self, cfg: ModelConfig, *, batch: int, max_len: int = 512,
                 tile_w: Optional[int] = None, t_tile: Optional[int] = None,
                 paged: bool = False, page: Optional[int] = None,
                 num_pages: Optional[int] = None, schedule: str = "static",
                 strategy: str = "round_robin",
                 params: Optional[dense.DenseLM] = None, seed: int = 0,
                 device=None, dtype: torch.dtype = torch.bfloat16,
                 keep_params: bool = False, prefill_seq: int = 0,
                 prefill_buckets=None, kv_dtype: str = "bf16",
                 spec_k: int = 0):
        from triton_dist_tpu_torch.serving.blocks import kv_quant_spec

        qdtype, _ = kv_quant_spec(kv_dtype)
        self.kv_dtype = "bf16" if qdtype is None else kv_dtype
        self.spec_k = int(spec_k or 0)
        if self.spec_k == 1:
            self.spec_k = 0              # K = 1 is plain decode
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be 0 or >= 2, got {spec_k}")
        self.prefill_buckets = (tuple(sorted(set(
            int(c) for c in prefill_buckets))) if prefill_buckets else None)
        if self.prefill_buckets and self.prefill_buckets[0] < 1:
            raise ValueError(f"prefill buckets must be positive ints, "
                             f"got {prefill_buckets!r}")
        for knob, on in (("kv_dtype", qdtype is not None),
                         ("spec_k", bool(self.spec_k)),
                         ("prefill_buckets", bool(self.prefill_buckets))):
            if not on:
                continue
            if not paged:
                raise ValueError(f"{knob} needs paged=True (per-page scales "
                                 "/ block-table addressing)")
            if prefill_seq > 1:
                raise ValueError(
                    f"{knob} is incompatible with prefill_seq: stream "
                    "prompts through the prefill lane (the decode kernel) "
                    "or the chunk steps instead")
        kv_quant = None if qdtype is None else kv_dtype
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.paged = paged
        self.device = resolve_device(device)
        self.dtype = dtype
        self.schedule = schedule
        self.steps_done = 0
        t_tile = t_tile or min(128, max_len)
        if paged and page is None:
            # One page for every build (they address the same pools).
            page = math.lcm(t_tile, prefill_seq if prefill_seq > 1 else 1)
        # Every build claims the same moe_counts span, sized by the most
        # rows any of them runs (a verify launch runs batch * K).
        counts_rows = max([batch, *(self.prefill_buckets or ()),
                           batch * prefill_seq, batch * self.spec_k])
        kw = dict(max_len=max_len, tile_w=tile_w, t_tile=t_tile,
                  schedule=schedule, strategy=strategy, page=page,
                  counts_rows=counts_rows)
        self.builder = ModelBuilder(cfg, batch=batch, paged=paged,
                                    kv_quant=kv_quant, **kw)
        # One chunk build per bucket: C rows of one slot per launch.
        self.chunk_builders = {
            c: ModelBuilder(cfg, batch=c, seq=c, chunk=True, paged=True,
                            kv_quant=kv_quant, **kw)
            for c in (self.prefill_buckets or ())}
        # The Q-block verify build: batch * K rows, K per slot.
        self.verify_builder = None
        if self.spec_k:
            self.verify_builder = ModelBuilder(
                cfg, batch=batch * self.spec_k, seq=self.spec_k,
                qblock=True, paged=True, kv_quant=kv_quant, **kw)
        self.prefill_builder = None
        self.prefill_seq = 0
        if prefill_seq > 1:
            self.prefill_builder = ModelBuilder(
                cfg, batch=batch * prefill_seq, seq=prefill_seq, paged=paged,
                **kw)
            self.prefill_seq = prefill_seq
        builders = [self.builder, *self.chunk_builders.values()]
        for extra in (self.prefill_builder, self.verify_builder):
            if extra is not None:
                builders.append(extra)
        # One arena for every build: each lays out the same weight region
        # first, and the activation tail is per-launch scratch, so the
        # largest footprint sizes and packs it.
        weights = [[(r.name, r.offset, r.rows)
                    for r in b.schema.regions("weight")] for b in builders]
        if any(w != weights[0] for w in weights[1:]):
            raise ValueError("the engine's builds lay out different weight "
                             "regions and cannot share one arena")
        pack = max(builders, key=lambda b: b.arena_rows)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if params is None and cfg.is_moe and not keep_params:
            self._arena = torch.zeros(pack.arena_rows, pack.w, dtype=dtype,
                                      device=self.device)
            draw = dict(generator=gen, device=self.device, dtype=dtype)
            for li in range(cfg.num_hidden_layers):
                pack.pack_layer(self._arena, li,
                                qwen_moe.init_layer(cfg, **draw))
            pack.pack_head(self._arena, qwen_moe.init_head(cfg, **draw))
        else:
            if params is None:
                model = qwen_moe if cfg.is_moe else dense
                params = model.init_params(cfg, generator=gen,
                                           device=self.device, dtype=dtype)
            self._arena = pack.pack_arena(params, dtype=dtype,
                                          device=self.device)
        self.params = params if keep_params else None
        self.counts = None
        if cfg.is_moe:
            rows = self.builder.schema.region("moe_counts").rows
            self.counts = torch.zeros(rows, pack.w, dtype=torch.int32,
                                       device=self.device)
            self.builder.schema.add_buffer("expert_counters", (rows, pack.w),
                                           "int32", kind="counter")

        kv, hd, L = cfg.num_key_value_heads, cfg.head_dim, \
            cfg.num_hidden_layers
        if paged:
            p_max = self.builder.p_max
            self.num_pages = num_pages or batch * p_max
            if self.num_pages < batch * p_max:
                raise ValueError(
                    f"num_pages {self.num_pages} < batch*p_max "
                    f"{batch * p_max} (identity table needs one page per "
                    "(batch, page index))")
            shape = (L, self.num_pages, self.builder.page, kv, hd)
            self.block_table = np.arange(batch * p_max, dtype=np.int32)
        else:
            self.num_pages = None
            shape = (L, batch, max_len, kv, hd)
            self.block_table = None
        pool_dtype = dtype if qdtype is None else qdtype
        self.k_cache = torch.zeros(shape, dtype=pool_dtype,
                                   device=self.device)
        self.v_cache = torch.zeros(shape, dtype=pool_dtype,
                                   device=self.device)
        sch = self.builder.schema
        name = str(pool_dtype).replace("torch.", "")
        sch.add_buffer("k_cache", shape, name, kind="kv")
        sch.add_buffer("v_cache", shape, name, kind="kv")
        # Per-(layer, page, kv_head) dequant scales of quantized pools;
        # a page's first write resets its scale.
        self.k_scale = self.v_scale = None
        if qdtype is not None:
            sshape = shape[:2] + (kv,)
            self.k_scale = torch.ones(sshape, dtype=torch.float32,
                                      device=self.device)
            self.v_scale = torch.ones(sshape, dtype=torch.float32,
                                      device=self.device)
            sch.add_buffer("k_scale", sshape, "float32", kind="scale")
            sch.add_buffer("v_scale", sshape, "float32", kind="scale")

    @property
    def arena(self) -> torch.Tensor:
        return self._arena

    def decode_step(self, token_ids, cache_len) -> torch.Tensor:
        """token_ids (B,) -> fp32 logits (B, vocab) on the engine's device.
        ``cache_len``: a scalar (uniform batch) or a (B,) vector of
        per-slot positions: each row appends and attends at its own
        length, so a continuous-batching server drives slots of different
        ages through one launch."""
        logits = self.builder.step(self._arena, self.k_cache, self.v_cache,
                                   token_ids, cache_len, self.block_table,
                                   counts=self.counts, **self._scales())
        self.steps_done += 1
        return logits

    def _scales(self) -> dict:
        return dict(k_scale=self.k_scale, v_scale=self.v_scale)

    def verify_step(self, token_rows, positions) -> torch.Tensor:
        """ONE Q-block verify launch (``spec_k`` builds): ``token_rows``
        (B, K) or (B·K,) drafted candidates, slot-major; ``positions``
        (B·K,) each row's cache position, -1 masking a row (over-budget
        candidates and parked slots write nothing; their logits are
        garbage the host discards). Writes each unmasked row's K/V at its
        position, attends under the per-row causal bound, and returns fp32
        logits (B, K, vocab): row j's are those :meth:`decode_step` would
        give at that position, up to the order of the sums (the verify
        launch runs the tensor-core LINEAR)."""
        if self.verify_builder is None:
            raise ValueError("engine built without spec_k: there is no "
                             "Q-block verify build")
        toks = np.asarray(torch.as_tensor(token_rows).cpu(),
                          np.int32).reshape(-1)
        pos = np.asarray(torch.as_tensor(positions).cpu(),
                         np.int32).reshape(-1)
        logits = self.verify_builder.step(
            self._arena, self.k_cache, self.v_cache, toks, pos,
            self.block_table, counts=self.counts, **self._scales())
        self.steps_done += 1
        return logits.reshape(self.batch, self.spec_k, -1)

    def prefill_chunk(self, token_row, codes, table_row, *,
                      row: Optional[int] = None) -> torch.Tensor:
        """ONE prefill-chunk launch (``prefill_buckets`` builds).
        ``token_row`` (C,): chunk tokens padded to a bucket length;
        ``codes`` (C,): sign-encoded per-row positions
        (:func:`~triton_dist_tpu_torch.ops.chunked_prefill.chunk_row_codes`:
        ``>= 0`` write and attend there, ``<= -2`` attend only at
        ``-code - 2``, ``-1`` dead padding); ``table_row`` (p_max,): the
        slot's block-table row. Writes each writing row's K/V, attends
        under the per-row causal horizon and returns fp32 logits (C,
        vocab), or (vocab,) of row ``row`` alone."""
        toks = np.asarray(torch.as_tensor(token_row).cpu(),
                          np.int32).reshape(-1)
        b = self.chunk_builders.get(int(toks.shape[0]))
        if b is None:
            raise ValueError(
                f"no chunk step for bucket {toks.shape[0]}: engine built "
                f"with prefill_buckets={self.prefill_buckets}; pad chunks "
                "to a configured bucket (ops.chunked_prefill.plan_chunks)")
        logits = b.step(self._arena, self.k_cache, self.v_cache, toks,
                        codes, table_row, rows=row, counts=self.counts,
                        **self._scales())
        self.steps_done += 1
        return logits

    def expert_counts(self) -> np.ndarray:
        """Cumulative routed (row, expert) counts of every launch of every
        build, (num_experts,) int64 — monotonic; diff two snapshots for a
        window. Every row of a launch routes, parked and padding rows
        included, as in the JAX engine. Exact on every device (int32
        counters, where the JAX engine sums its fp32 arena rows)."""
        if self.counts is None:
            raise ValueError("expert_counts() needs a MoE megakernel")
        return (self.counts.sum(dim=0, dtype=torch.int64).cpu().numpy()
                [:self.cfg.num_experts])

    def set_expert_load(self, load) -> None:
        """Hot-expert rebalance hook: recompute the dynamic claim order
        of the decode and chunk builds under a per-expert load vector
        (``None``: uniform), as the JAX engine does."""
        self.builder.reprioritize(load)
        for b in (*self.chunk_builders.values(), self.verify_builder):
            if b is not None:
                b.reprioritize(load)

    def chunk_cache_size(self) -> int:
        """Chunk builds of this engine, one per bucket: the port runs
        eagerly, so this stands where the JAX engine counts its chunk
        steps' jit-cache entries, and never exceeds the bucket count."""
        return len(self.chunk_builders)

    def prefill_chain(self, prompt_ids):
        """Feed a (B, S) prompt token by token; returns the last column
        to seed :meth:`generate` with ``start_pos=S-1``."""
        prompt = np.asarray(prompt_ids, np.int32)
        for pos in range(prompt.shape[1] - 1):
            self.decode_step(prompt[:, pos], pos)
        return prompt[:, -1]

    def prefill(self, prompt_ids, *, start_pos: int = 0) -> torch.Tensor:
        """Batched prefill (``prefill_seq=S`` builds): the whole (B, S)
        prompt is ONE launch (rows are (b, s) pairs, causal attention,
        cache writes at ``start_pos + s``). Returns the last position's
        fp32 logits (B, vocab); the cache then holds ``start_pos + S``
        tokens per slot."""
        if self.prefill_builder is None:
            raise ValueError("engine built without prefill_seq")
        s = self.prefill_seq
        if self.paged and int(start_pos) % s:
            raise ValueError(f"paged prefill needs start_pos % prefill_seq "
                             f"== 0 (got {start_pos} % {s})")
        prompt = np.asarray(torch.as_tensor(prompt_ids).cpu(), np.int32)
        if prompt.shape != (self.batch, s):
            raise ValueError(f"prompt {prompt.shape} != ({self.batch}, {s})")
        logits = self.prefill_builder.step(
            self._arena, self.k_cache, self.v_cache, prompt.reshape(-1),
            np.full(self.batch * s, int(start_pos), np.int32),
            self.block_table,
            rows=[bb * s + s - 1 for bb in range(self.batch)],
            counts=self.counts)
        self.steps_done += 1
        return logits

    def generate(self, first_tokens, steps: int, *,
                 start_pos: int = 0) -> torch.Tensor:
        """Greedy chain from (B,) seed tokens at cache position
        ``start_pos``; returns (B, steps) int32 on the engine's device."""
        tok = torch.as_tensor(np.asarray(first_tokens, np.int32))
        out = []
        for i in range(steps):
            logits = self.decode_step(tok, start_pos + i)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
        return torch.stack(out, dim=1)
