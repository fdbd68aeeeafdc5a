"""ModelBuilder: a whole Qwen3 (dense or MoE) step as one task graph, scheduled
natively and run as ONE persistent kernel (counterpart of
``triton_dist_tpu/megakernel/builder.py``).

The graph, the arena layout (offsets, tile-major ``(w, w)`` weight
blocks, ``(batch, w)`` activation tiles, the logits region, the
``(vocab * d_tiles, w)`` embedding rows) and the static and dynamic
schedule tables are the JAX package's, built the same way, so they can be
compared exactly. :meth:`ModelBuilder.step` then runs the step:

- on CUDA tensors it launches ``megakernel_kernel``
  (``csrc/megakernel.cu``), which replaces the Pallas
  ``ModelBuilder._kernel`` (``triton_dist_tpu/megakernel/builder.py:1157``):
  a cooperative launch of as many blocks as fit on the card at once, each
  claiming tasks off an atomic counter in claim-list order, waiting on
  its predecessors' done flags and running the task's body;
- on CPU tensors it runs the plain interpreter: the same claim list in
  order through the PyTorch task bodies of :mod:`.kernels`.

It builds the dense step in four row modes, chosen by the
cache task pair each layer records:

- decode (``seq=1``: ``WRITE_KV``/``ATTN_DECODE``), paged or dense: row r
  is slot r at its own length;
- batched prefill (``seq=S > 1``: ``WRITE_KV_PREFILL``/``ATTN_PREFILL``),
  paged or dense: ``batch`` counts rows, slot-major (slots * S), each at
  the shared base plus its index in the slot;
- prefill chunk (``chunk=True``, ``batch = seq = C``:
  ``WRITE_KV_CHUNK``/``ATTN_CHUNK``), paged only: C rows of one slot whose
  (p_max,) table row rides the launch, positions sign-encoded per row
  (:func:`~triton_dist_tpu_torch.ops.chunked_prefill.chunk_row_codes`);
- Q-block verify (``qblock=True``, ``seq = K``: ``WRITE_KV_QBLOCK``/
  ``ATTN_QBLOCK``), paged only: ``batch`` = slots * K rows, slot-major,
  each at its own position; a negative position masks the row.

``kv_quant="int8"|"fp8"`` (paged; decode, chunk and Q-block builds)
stores the pools at one byte per element with (layers, num_pages, kv)
fp32 scale tables beside them, quantize fused into the write task and
dequantize into every attention read; batched prefill has no
fused-quant write and refuses it, as in the JAX builder.

A MoE config (Qwen3-MoE, the tensor-parallel expert regime at one rank)
replaces each layer's MLP by the JAX graph's MoE FFN: the router
``LINEAR``, ``MOE_WEIGHTS`` (softmax, top-k, combine weights, expert
counters), every expert's gate/up ``LINEAR``, ``SILU_MUL`` and down
``LINEAR``, and a chain of ``WEIGHTED_ADD`` combines into ``mpart``; the
same bodies serve all three row modes. Every expert runs for every row,
as in the JAX design; the counters count what each row routed to.

With ``mesh=make_mesh(tp=n)`` the builder records rank-local graphs as
the JAX builder does for ``ModelBuilder(cfg, mesh)``: every rank holds
``H/n`` query heads, ``KV/n`` KV heads, ``ff/n`` MLP columns and a
``vocab/n`` shard of the embedding and the LM head, so the GATHER of a
token outside the rank's shard writes zeros, and an ``ALLREDUCE`` task
after the embedding, after each attention output projection and after
each MLP down projection sums the ranks' partials through the ``ar_ws``
workspace. The n ranks are simulated on one device: the arena is (n,
rows, w), rank r's slice packed from rank r's weight shards, and the
pools hold every rank's KV heads in rank order, rank r's at heads
``[r·KV/n, (r+1)·KV/n)``. One launch runs every rank (the CUDA kernel
gives each rank its own blocks); the plain interpreter runs each task
for every rank in turn. Quantized pools, the Q-block verify set, the
batched prefill and MoE graphs are one rank only (ROADMAP.md queue A
item 8).

Hybrid GDN and profiling are later slices (ROADMAP.md).
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from triton_dist_tpu_torch.megakernel import kernels as K
from triton_dist_tpu_torch.megakernel.graph import Graph, comm_priority
from triton_dist_tpu_torch.megakernel.scheduler import (
    prune_deps, schedule_dyn, schedule_mc)
from triton_dist_tpu_torch.megakernel.task import ARGS_MAX, TaskType
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.ops.tp_gemm import (check_axis, column_shards,
                                               row_shards)
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel, load

# ``KERNEL.launches`` counts launches of the CUDA megakernel.
KERNEL = CudaKernel("megakernel.cu", "tdt_megakernel_bf16",
                    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 11
                    + [ctypes.c_float, ctypes.c_float, ctypes.c_longlong]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                    + [ctypes.c_int, ctypes.c_float]
                    + [ctypes.c_int] * 5 + [ctypes.c_longlong]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_uint64]
                    + [ctypes.c_int] * 3)
# Planted faults of the multi-rank ALLREDUCE task (``launch(fault=)``):
# rank ``fault_rank``'s ``fault_ar``-th ALLREDUCE of the launch never
# signals its slab to rank ``fault_rank + 1``, or puts its slab into the
# slot of rank ``fault_rank + 1`` instead of its own.
AR_FAULTS = {"lost_signal": 1, "wrong_slot": 2}
# Launches of the CUDA megakernel by row mode, and by row mode and pool
# storage for quantized pools ("decode-int8", ...); each also counts in
# ``KERNEL.launches``.
MODE_LAUNCHES = {f"{mode}{kv}": 0
                 for mode in ("decode", "prefill", "chunk", "qblock")
                 for kv in ("", "-int8", "-fp8")}
# The pool storage the kernel takes, by ``kv_quant`` (0: the arena's bf16).
KV_QUANT_CODES = {None: 0, "int8": 1, "fp8": 2}
KV_QUANT_DTYPES = {None: torch.bfloat16, "int8": torch.int8,
                   "fp8": torch.float8_e4m3fn}
# What csrc/megakernel.cu is compiled for.
KERNEL_TILE_W = 128
KERNEL_HEAD_DIM = 128
KERNEL_MAX_GQA = 8            # query heads per KV head
# Rows the decode instantiation's CUDA-core LINEAR takes; prompt modes and
# wider decode launches run the tensor-core instantiation.
KERNEL_CUDA_CORE_ROWS = 8
# Task types the CUDA kernel runs: the decode set, the batched-prefill,
# prefill-chunk and Q-block cache pairs, and the MoE pair.
KERNEL_TYPES = frozenset({
    TaskType.RMSNORM, TaskType.LINEAR, TaskType.ADD, TaskType.SILU_MUL,
    TaskType.ATTN_DECODE, TaskType.WRITE_KV, TaskType.ALLREDUCE,
    TaskType.GATHER, TaskType.WRITE_KV_PREFILL, TaskType.ATTN_PREFILL,
    TaskType.WRITE_KV_CHUNK, TaskType.ATTN_CHUNK, TaskType.WRITE_KV_QBLOCK,
    TaskType.ATTN_QBLOCK, TaskType.MOE_WEIGHTS, TaskType.WEIGHTED_ADD})
# The cache task pair (write, attend) each layer records, by row mode.
CACHE_PAIRS = {
    "decode": (TaskType.WRITE_KV, TaskType.ATTN_DECODE),
    "prefill": (TaskType.WRITE_KV_PREFILL, TaskType.ATTN_PREFILL),
    "chunk": (TaskType.WRITE_KV_CHUNK, TaskType.ATTN_CHUNK),
    "qblock": (TaskType.WRITE_KV_QBLOCK, TaskType.ATTN_QBLOCK),
}
DEFAULT_TIMEOUT_S = 5.0


class MegakernelTimeoutError(RuntimeError):
    """A task of the megakernel waited past the timeout on a predecessor.
    The kernel traps, so the CUDA context of the process is lost."""


def _cdiv(a, b):
    return -(-a // b)


def tp_ranks(mesh, axis) -> int:
    """The ranks of one mesh axis that spans every rank of ``mesh``; the
    two-axis ``("dp", "tp")`` megakernel is ROADMAP.md queue A item 8."""
    if isinstance(axis, (tuple, list)):
        raise NotImplementedError(
            f"axis={tuple(axis)}: the megakernel and the paged lanes over "
            "an (outer, inner) mesh are ROADMAP.md queue A item 8")
    from triton_dist_tpu_torch.ops.tp_gemm import check_axis

    if mesh.size("pp") > 1:
        raise ValueError("the megakernel does not run over a mesh with pp > "
                         "1: pipeline parallelism is the layer "
                         "layers.pp_comm, as in JAX")
    check_axis("the megakernel", mesh, axis)
    return mesh.size(axis)


# In-arena region kinds; the rest are named device buffers (the pools).
ARENA_KINDS = ("weight", "activation", "workspace", "counter", "io")


@dataclasses.dataclass(frozen=True)
class ArenaRegion:
    """One named region: ``rows`` rows at ``offset`` of the (rows, w)
    arena, or a device buffer of ``shape``/``dtype`` beside it."""

    name: str
    kind: str
    offset: int = 0
    rows: int = 0
    shape: Tuple[int, ...] = ()
    dtype: str = "float32"

    @property
    def in_arena(self) -> bool:
        return self.kind in ARENA_KINDS and not self.shape


class ArenaSchema:
    """The described memory layout of a build: every region by name, with
    offset and rows (in the arena) or shape and dtype (device buffers)."""

    def __init__(self, w: int):
        self.w = int(w)
        self._regions: Dict[str, ArenaRegion] = {}
        self._cursor = 0

    def alloc(self, name: str, rows: int, kind: str = "activation") -> int:
        if kind not in ARENA_KINDS:
            raise ValueError(f"kind {kind!r} is not an in-arena kind "
                             f"{ARENA_KINDS}")
        if name in self._regions:
            raise ValueError(f"arena region {name!r} already allocated")
        off = self._cursor
        self._regions[name] = ArenaRegion(name=name, kind=kind, offset=off,
                                          rows=int(rows))
        self._cursor += int(rows)
        return off

    def add_buffer(self, name: str, shape, dtype, kind: str) -> None:
        """A device buffer beside the arena. ``kind`` ``"counter"`` is
        allowed here too: the MoE engine's exact int32 expert counters
        sit beside the arena's ``moe_counts`` rows."""
        if kind in ARENA_KINDS and kind != "counter":
            raise ValueError(f"kind {kind!r} is an in-arena kind — use "
                             "alloc()")
        if name in self._regions:
            raise ValueError(f"arena region {name!r} already allocated")
        self._regions[name] = ArenaRegion(
            name=name, kind=kind, shape=tuple(int(s) for s in shape),
            dtype=str(dtype))

    @property
    def rows(self) -> int:
        return self._cursor

    def region(self, name: str) -> ArenaRegion:
        return self._regions[name]

    def regions(self, kind: Optional[str] = None):
        return [r for r in self._regions.values()
                if kind is None or r.kind == kind]

    def check_disjoint(self) -> None:
        """In-arena regions tile [0, rows) with no overlap and no gap."""
        spans = sorted((r.offset, r.offset + r.rows, r.name)
                       for r in self._regions.values() if r.in_arena)
        at = 0
        for start, end, name in spans:
            if start != at:
                kind = ("overlaps the previous region" if start < at
                        else "leaves an unclaimed gap")
                raise ValueError(f"arena region {name!r} at [{start}, "
                                 f"{end}) {kind} (cursor was at {at})")
            at = end
        if at != self._cursor:
            raise ValueError(f"arena regions cover {at} rows but the cursor "
                             f"claims {self._cursor}")

    def describe(self):
        out = []
        for r in self._regions.values():
            if r.in_arena:
                out.append({"name": r.name, "kind": r.kind,
                            "offset": r.offset, "rows": r.rows})
            else:
                out.append({"name": r.name, "kind": r.kind,
                            "shape": list(r.shape), "dtype": r.dtype})
        return out


class ModelBuilder:
    """Builds the dense Qwen3 step as a megakernel.

    ``schedule``: ``"static"`` (per-core slot lists packed by ``strategy``
    onto ``num_cores`` queues, read in merged order) or ``"dynamic"`` (one
    comm-priority-ordered claim list). Both are topological orders; the
    CUDA kernel's blocks claim tasks in that order. ``seq`` > 1 builds a
    batched prefill of ``batch // seq`` slots; ``chunk=True`` a prefill
    chunk of ``batch == seq`` rows of one slot; ``qblock=True`` a verify
    block of K = ``seq`` rows for each of ``batch // seq`` slots (module
    docstring). ``kv_quant`` ("int8" | "fp8" | None) picks the pools'
    storage.

    MoE builds: ``counts_rows`` sizes the ``moe_counts`` region (the
    largest row count over an engine's builds, so that every build
    claims the same span); ``expert_load`` (per expert) biases the
    dynamic claim order toward hot experts' chains
    (:meth:`reprioritize`)."""

    def __init__(self, cfg: ModelConfig, *, batch: int, max_len: int,
                 tile_w: Optional[int] = None, t_tile: Optional[int] = None,
                 num_cores: int = 1, strategy: str = "round_robin",
                 schedule: str = "static", paged: bool = False,
                 page: Optional[int] = None, seq: int = 1,
                 chunk: bool = False, expert_load=None,
                 counts_rows: Optional[int] = None, qblock: bool = False,
                 kv_quant: Optional[str] = None, mesh=None, axis="tp"):
        if schedule not in ("static", "dynamic"):
            raise ValueError(f"schedule must be 'static' or 'dynamic', "
                             f"got {schedule!r}")
        if seq < 1 or batch % seq:
            raise ValueError(f"batch rows {batch} not divisible by "
                             f"seq {seq}")
        if qblock and chunk:
            raise ValueError("qblock and chunk are mutually exclusive "
                             "task-set selectors (verify rows vs prompt-chunk "
                             "rows)")
        if qblock:
            if seq < 2:
                raise ValueError(f"qblock builds verify K >= 2 candidates "
                                 f"per slot (seq={seq})")
            if not paged:
                raise ValueError("the Q-block verify task set addresses the "
                                 "cache through block tables: build with "
                                 "paged=True")
        from triton_dist_tpu_torch.serving.blocks import kv_quant_spec

        qdtype, qmax = kv_quant_spec(kv_quant)
        self.kv_quant = None if qdtype is None else kv_quant
        self.kv_qmax = 0.0 if qdtype is None else float(qmax)
        if self.kv_quant is not None:
            if not paged:
                raise ValueError("quantized megakernel KV needs paged=True "
                                 "(scales are per (layer, page, kv_head))")
            if seq > 1 and not (qblock or chunk):
                raise NotImplementedError(
                    "the batched-prefill bodies have no fused-quant write; "
                    "quantized engines stream prompts through the prefill "
                    "lane (decode kernel) or chunk tasks")
        if chunk:
            if batch != seq:
                raise ValueError(
                    "chunk builds run ONE prompt chunk per launch: "
                    f"batch ({batch}) must equal seq ({seq}), the chunk "
                    "rows are the batch rows")
            if not paged:
                raise ValueError("the prefill-chunk task set addresses "
                                 "the cache through block tables: build "
                                 "with paged=True")
        self.seq = seq
        self.chunk = bool(chunk)
        self.qblock = bool(qblock)
        self.mode = ("chunk" if self.chunk else "qblock" if self.qblock
                     else "prefill" if seq > 1 else "decode")
        # Slots the rows belong to: the chunk's one table row, or
        # batch // seq block-table rows (dense: cache rows).
        self.n_slots = 1 if self.chunk else batch // seq
        self.cfg = cfg
        self.mesh, self.axis = mesh, axis
        # Tensor-parallel ranks along ``axis`` (one without a mesh).
        self.n = 1 if mesh is None else tp_ranks(mesh, axis)
        if self.n > 1:
            if cfg.is_moe:
                raise NotImplementedError(
                    "a MoE megakernel at tp > 1 (JAX's in-kernel-tp expert "
                    "regime) is not ported: ROADMAP.md queue A item 8")
            if self.kv_quant is not None or qblock or (seq > 1
                                                       and not chunk):
                raise NotImplementedError(
                    "at tp > 1 the megakernel runs the decode and chunk "
                    "builds on bf16 pools; quantized pools (kv_dtype), the "
                    "Q-block verify build (spec_k) and the batched prefill "
                    "(prefill_seq) are ROADMAP.md queue A item 8")
        self.batch = batch
        self.max_len = max_len
        self.num_cores = num_cores
        self.strategy = strategy
        self.schedule = schedule
        self.expert_load = (list(expert_load) if expert_load is not None
                            else None)
        self.counts_rows = (int(counts_rows) if counts_rows is not None
                            else None)
        hd = cfg.head_dim
        self.w = tile_w or max(128, hd)
        if self.w % hd:
            raise ValueError(f"tile width {self.w} must be a multiple of "
                             f"head_dim {hd}")
        self.t_tile = t_tile or min(128, max_len)
        if max_len % self.t_tile:
            raise ValueError(f"t_tile={self.t_tile} must divide "
                             f"max_len={max_len}")
        self.paged = paged
        self.page = 0
        self.p_max = 0
        if paged:
            self.page = page or max(self.t_tile, seq)
            # A batched prefill's slot writes seq consecutive positions
            # from a seq-aligned base, which the JAX body stores as one
            # block inside one page; chunk and Q-block rows write one
            # position each.
            seq_align = seq > 1 and not (self.chunk or self.qblock)
            if (self.page % self.t_tile or (seq_align and self.page % seq)
                    or max_len % self.page):
                raise ValueError(
                    f"page={self.page} needs t_tile|page, seq|page and "
                    f"page|max_len (t_tile={self.t_tile}, seq={seq}, "
                    f"max_len={max_len})")
            self.p_max = max_len // self.page
        if cfg.num_attention_heads % cfg.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of "
                             "num_key_value_heads")
        n = self.n
        for name, size in (("num_attention_heads", cfg.num_attention_heads),
                           ("num_key_value_heads", cfg.num_key_value_heads),
                           ("intermediate_size", cfg.intermediate_size)):
            if size % n:
                raise ValueError(f"{name}={size} not divisible by tp={n}")
        self.h_loc = cfg.num_attention_heads // n
        self.kv_loc = cfg.num_key_value_heads // n
        self.d_tiles = _cdiv(cfg.hidden_size, self.w)
        self.hq_tiles = _cdiv(self.h_loc * hd, self.w)
        self.kv_tiles = _cdiv(self.kv_loc * hd, self.w)
        self.ff_tiles = _cdiv(cfg.intermediate_size // n, self.w)
        # MoE: every expert's ffn in ffe_tiles tiles; the router logits
        # must fit one tile.
        self.moe = cfg.is_moe
        if self.moe:
            if cfg.num_experts > self.w:
                raise ValueError(
                    f"megakernel MoE needs num_experts={cfg.num_experts}"
                    f" <= tile width {self.w} (router logits tile)")
            if cfg.num_experts_per_tok > cfg.num_experts:
                raise ValueError(
                    f"num_experts_per_tok={cfg.num_experts_per_tok} > "
                    f"num_experts={cfg.num_experts} (the static top-k "
                    "loop would pick zero-probability padded columns)")
            self.ffe_tiles = _cdiv(cfg.moe_intermediate_size, self.w)
        self._offsets: Dict[str, int] = {}
        self.schema = ArenaSchema(self.w)
        self.graph = Graph()
        self._device_tables = {}
        self._router_tasks = set()       # MoE: each layer's router LINEAR
        t0 = time.perf_counter()
        self._build()
        # Host time of the graph, its pruning and the schedule.
        self.build_seconds = time.perf_counter() - t0

    # ---------------- arena layout -------------------------------------
    def _alloc(self, name: str, rows: int, kind: str = "activation") -> int:
        off = self.schema.alloc(name, rows, kind)
        self._offsets[name] = off
        return off

    def _alloc_act(self, name: str, tiles: int) -> int:
        return self._alloc(name, tiles * self.batch)

    def _linear(self, in_off, w_off, out_off, k_tiles, n_tiles, *, layer,
                in_rows, w_rows, expert: int = -1):
        b = self.batch
        for j in range(n_tiles):
            self.graph.add(TaskType.LINEAR,
                           (in_off, w_off, out_off, k_tiles, n_tiles, j),
                           reads=[(in_off, in_rows), (w_off, w_rows)],
                           writes=[(out_off + j * b, b)], layer=layer,
                           expert=expert)

    def _build(self):
        cfg, b, w = self.cfg, self.batch, self.w
        d_t, hq_t, kv_t, ff_t = (self.d_tiles, self.hq_tiles, self.kv_tiles,
                                 self.ff_tiles)

        def walloc(name, k_tiles, n_tiles):
            return self._alloc(name, k_tiles * n_tiles * w, kind="weight")

        def vecalloc(name, tiles):
            return self._alloc(name, tiles, kind="weight")

        # lm_head and the embedding are vocab-sharded: vocab/n rows a rank.
        if cfg.vocab_size % self.n:
            raise ValueError(f"vocab_size={cfg.vocab_size} not divisible "
                             f"by tp={self.n}")
        self.vocab_loc = cfg.vocab_size // self.n
        self.vloc_tiles = _cdiv(self.vocab_loc, w)
        L = cfg.num_hidden_layers
        for li in range(L):
            walloc(f"l{li}.wq", d_t, hq_t)
            walloc(f"l{li}.wk", d_t, kv_t)
            walloc(f"l{li}.wv", d_t, kv_t)
            walloc(f"l{li}.wo", hq_t, d_t)
            if self.moe:
                walloc(f"l{li}.router", d_t, 1)
                for e in range(cfg.num_experts):
                    walloc(f"l{li}.e{e}.w_gate", d_t, self.ffe_tiles)
                    walloc(f"l{li}.e{e}.w_up", d_t, self.ffe_tiles)
                    walloc(f"l{li}.e{e}.w_down", self.ffe_tiles, d_t)
            else:
                walloc(f"l{li}.w_gate", d_t, ff_t)
                walloc(f"l{li}.w_up", d_t, ff_t)
                walloc(f"l{li}.w_down", ff_t, d_t)
            vecalloc(f"l{li}.ln_attn", d_t)
            vecalloc(f"l{li}.ln_mlp", d_t)
            vecalloc(f"l{li}.q_norm", 1)
            vecalloc(f"l{li}.k_norm", 1)
        vecalloc("ln_f", d_t)
        vecalloc("embed", self.vocab_loc * d_t)
        walloc("lm_head_T", d_t, self.vloc_tiles)

        # MoE expert counters: the JAX builder's (counts_rows, w) region,
        # right after the weights so that every build of an engine claims
        # the same span. The port counts exactly in an int32 buffer
        # beside the arena (kernels.moe_weights_body); the region keeps
        # every later offset the JAX package's.
        self.moe_counts_off = 0
        if self.moe:
            self.moe_counts_off = self._alloc(
                "moe_counts", max(b, self.counts_rows or 0), kind="counter")

        # The allreduce workspace: n slots of ar_max_tiles tiles, slot r
        # holding rank r's slab of the ALLREDUCE in flight (unused at one
        # rank, where the layout keeps it as the JAX package does).
        self.ar_max_tiles = max(d_t, 1)
        self.ar_ws_off = self._alloc("ar_ws", self.n * self.ar_max_tiles * b,
                                     kind="workspace")
        ar_ws = (self.ar_ws_off, self.n * self.ar_max_tiles * b)
        x_off = self._alloc_act("x", d_t)
        g, o = self.graph, self._offsets

        g.add(TaskType.GATHER, (o["embed"], x_off, d_t, self.vocab_loc),
              reads=[(o["embed"], self.vocab_loc * d_t)],
              writes=[(x_off, d_t * b)])
        g.add(TaskType.ALLREDUCE, (x_off, d_t), reads=[(x_off, d_t * b)],
              writes=[(x_off, d_t * b), ar_ws])

        for li in range(L):
            t0 = self._alloc_act(f"l{li}.t0", d_t)
            q = self._alloc_act(f"l{li}.q", hq_t)
            kx = self._alloc_act(f"l{li}.k", kv_t)
            vx = self._alloc_act(f"l{li}.v", kv_t)
            attn = self._alloc_act(f"l{li}.attn", hq_t)
            opart = self._alloc_act(f"l{li}.opart", d_t)
            x1 = self._alloc_act(f"l{li}.x1", d_t)
            t1 = self._alloc_act(f"l{li}.t1", d_t)
            if not self.moe:
                gx = self._alloc_act(f"l{li}.g", ff_t)
                ux = self._alloc_act(f"l{li}.u", ff_t)
                hx = self._alloc_act(f"l{li}.h", ff_t)
            mpart = self._alloc_act(f"l{li}.mpart", d_t)
            x2 = self._alloc_act(f"l{li}.x2", d_t)

            g.add(TaskType.RMSNORM, (x_off, o[f"l{li}.ln_attn"], t0, d_t),
                  reads=[(x_off, d_t * b), (o[f"l{li}.ln_attn"], d_t)],
                  writes=[(t0, d_t * b)], layer=li)
            self._linear(t0, o[f"l{li}.wq"], q, d_t, hq_t, layer=li,
                         in_rows=d_t * b, w_rows=d_t * hq_t * w)
            self._linear(t0, o[f"l{li}.wk"], kx, d_t, kv_t, layer=li,
                         in_rows=d_t * b, w_rows=d_t * kv_t * w)
            self._linear(t0, o[f"l{li}.wv"], vx, d_t, kv_t, layer=li,
                         in_rows=d_t * b, w_rows=d_t * kv_t * w)
            wk_type, at_type = CACHE_PAIRS[self.mode]
            g.add(wk_type, (kx, vx, li, o[f"l{li}.k_norm"]),
                  reads=[(kx, kv_t * b), (vx, kv_t * b),
                         (o[f"l{li}.k_norm"], 1)],
                  writes=[], layer=li)
            # ATTN reads the cache WRITE_KV wrote: an explicit edge, as
            # in the JAX builder (the pools are not arena regions).
            attn_task = g.add(at_type,
                              (q, attn, li, o[f"l{li}.q_norm"]),
                              reads=[(q, hq_t * b), (o[f"l{li}.q_norm"], 1)],
                              writes=[(attn, hq_t * b)], layer=li)
            attn_task.deps.append(g.tasks[-2].task_id)
            self._linear(attn, o[f"l{li}.wo"], opart, hq_t, d_t, layer=li,
                         in_rows=hq_t * b, w_rows=hq_t * d_t * w)
            g.add(TaskType.ALLREDUCE, (opart, d_t),
                  reads=[(opart, d_t * b)],
                  writes=[(opart, d_t * b), ar_ws], layer=li)
            g.add(TaskType.ADD, (x_off, opart, x1, d_t),
                  reads=[(x_off, d_t * b), (opart, d_t * b)],
                  writes=[(x1, d_t * b)], layer=li)
            g.add(TaskType.RMSNORM, (x1, o[f"l{li}.ln_mlp"], t1, d_t),
                  reads=[(x1, d_t * b), (o[f"l{li}.ln_mlp"], d_t)],
                  writes=[(t1, d_t * b)], layer=li)
            if self.moe:
                self._moe_ffn(li, t1, mpart)
            else:
                self._linear(t1, o[f"l{li}.w_gate"], gx, d_t, ff_t,
                             layer=li, in_rows=d_t * b,
                             w_rows=d_t * ff_t * w)
                self._linear(t1, o[f"l{li}.w_up"], ux, d_t, ff_t, layer=li,
                             in_rows=d_t * b, w_rows=d_t * ff_t * w)
                g.add(TaskType.SILU_MUL, (gx, ux, hx, ff_t),
                      reads=[(gx, ff_t * b), (ux, ff_t * b)],
                      writes=[(hx, ff_t * b)], layer=li)
                self._linear(hx, o[f"l{li}.w_down"], mpart, ff_t, d_t,
                             layer=li, in_rows=ff_t * b,
                             w_rows=ff_t * d_t * w)
            g.add(TaskType.ALLREDUCE, (mpart, d_t),
                  reads=[(mpart, d_t * b)],
                  writes=[(mpart, d_t * b), ar_ws], layer=li)
            g.add(TaskType.ADD, (x1, mpart, x2, d_t),
                  reads=[(x1, d_t * b), (mpart, d_t * b)],
                  writes=[(x2, d_t * b)], layer=li)
            x_off = x2

        out_off = self._alloc_act("x_final", d_t)
        g.add(TaskType.RMSNORM, (x_off, o["ln_f"], out_off, d_t),
              reads=[(x_off, d_t * b), (o["ln_f"], d_t)],
              writes=[(out_off, d_t * b)])
        logits_off = self._alloc("logits", self.vloc_tiles * b, kind="io")
        self._linear(out_off, o["lm_head_T"], logits_off, d_t,
                     self.vloc_tiles, layer=-1, in_rows=d_t * b,
                     w_rows=d_t * self.vloc_tiles * w)
        self.logits_off = logits_off
        self.arena_rows = self.schema.rows
        self.schema.check_disjoint()

        # Every ALLREDUCE moves ar_max_tiles tiles (its slot's size in
        # ar_ws), as the JAX kernel's body assumes.
        for t in g.tasks:
            if (t.task_type == TaskType.ALLREDUCE
                    and t.args[1] != self.ar_max_tiles):
                raise ValueError(
                    f"ALLREDUCE task {t.task_id} moves {t.args[1]} "
                    f"tiles but the kernel body is specialized to "
                    f"ar_max_tiles={self.ar_max_tiles}")
        src, dst = g.edges()
        pin = np.array([0 if t.task_type == TaskType.ALLREDUCE else -1
                        for t in g.tasks], np.int32)
        cost = np.array([self._task_units(t) for t in g.tasks], np.int32)
        if len(src):
            psrc, pdst = prune_deps(len(g.tasks), src, dst)
        else:
            psrc = pdst = np.zeros(0, np.int32)
        self._pruned_edges = (psrc, pdst)
        self._pin, self._cost = pin, cost
        if self.schedule == "dynamic":
            self._schedule_dynamic(psrc, pdst, pin, cost)
        else:
            self._schedule_static(psrc, pdst, pin, cost)
        self._emit_device_tables()

    def _moe_ffn(self, li: int, t1: int, mpart: int) -> None:
        """The MoE FFN of layer ``li``, as the JAX builder records it:
        router logits, combine weights (and counters), every expert's
        SwiGLU, and the combines chained through ``mpart`` in expert
        order (the first writes, the rest accumulate)."""
        cfg, b, w, g, o = self.cfg, self.batch, self.w, self.graph, \
            self._offsets
        d_t, E, ffe_t = self.d_tiles, cfg.num_experts, self.ffe_tiles
        rl = self._alloc_act(f"l{li}.rl", 1)
        wbe = self._alloc_act(f"l{li}.wbe", 1)
        self._linear(t1, o[f"l{li}.router"], rl, d_t, 1, layer=li,
                     in_rows=d_t * b, w_rows=d_t * w)
        self._router_tasks.add(len(g.tasks) - 1)
        # The counters' read + write chains the layers' MOE_WEIGHTS tasks.
        cnt = self.moe_counts_off
        g.add(TaskType.MOE_WEIGHTS, (rl, wbe, E, cnt),
              reads=[(rl, b), (cnt, b)], writes=[(wbe, b), (cnt, b)],
              layer=li)
        for e in range(E):
            ge = self._alloc_act(f"l{li}.e{e}.g", ffe_t)
            ue = self._alloc_act(f"l{li}.e{e}.u", ffe_t)
            he = self._alloc_act(f"l{li}.e{e}.h", ffe_t)
            pe = self._alloc_act(f"l{li}.e{e}.part", d_t)
            self._linear(t1, o[f"l{li}.e{e}.w_gate"], ge, d_t, ffe_t,
                         layer=li, in_rows=d_t * b, w_rows=d_t * ffe_t * w,
                         expert=e)
            self._linear(t1, o[f"l{li}.e{e}.w_up"], ue, d_t, ffe_t,
                         layer=li, in_rows=d_t * b, w_rows=d_t * ffe_t * w,
                         expert=e)
            g.add(TaskType.SILU_MUL, (ge, ue, he, ffe_t),
                  reads=[(ge, ffe_t * b), (ue, ffe_t * b)],
                  writes=[(he, ffe_t * b)], layer=li, expert=e)
            self._linear(he, o[f"l{li}.e{e}.w_down"], pe, ffe_t, d_t,
                         layer=li, in_rows=ffe_t * b,
                         w_rows=ffe_t * d_t * w, expert=e)
            g.add(TaskType.WEIGHTED_ADD,
                  (mpart, pe, wbe, e, d_t, 1 if e == 0 else 0),
                  reads=[(pe, d_t * b), (wbe, b), (mpart, d_t * b)],
                  writes=[(mpart, d_t * b)], layer=li, expert=e)

    def reprioritize(self, expert_load) -> None:
        """Recompute the DYNAMIC claim order under a new per-expert load
        vector (``graph.comm_priority``'s ``expert_load``; ``None`` is
        uniform). Host only: the graph, the arena and the bodies stay;
        the claim list and tables are re-emitted and uploaded again at
        the next launch."""
        if self.schedule != "dynamic":
            raise ValueError(
                "reprioritize() adjusts the dynamic claim order; this "
                f"builder runs schedule={self.schedule!r}")
        self.expert_load = (list(expert_load) if expert_load is not None
                            else None)
        psrc, pdst = self._pruned_edges
        self._schedule_dynamic(psrc, pdst, self._pin, self._cost)
        self._device_tables = {}

    def _schedule_static(self, src, dst, pin, cost):
        """Per-core slot lists packed by ``strategy``, NOOP-padded so the
        merged (q-major) order respects every dependency."""
        self.sched = schedule_mc(len(self.graph.tasks), src, dst,
                                 num_cores=self.num_cores,
                                 strategy=self.strategy, task_cost=cost,
                                 pin_core=pin, dep_opt=False)
        queue = self.sched["queue"]
        self.qlen = queue.shape[0]
        self._emit_slot_tables(queue.reshape(-1), queue.shape)

    def _schedule_dynamic(self, src, dst, pin, cost):
        """One comm-priority-ordered claim list (holes are -1)."""
        prio, bkt, _ = comm_priority(self.graph.tasks, n_ranks=self.n,
                                     task_cost=cost,
                                     expert_load=self.expert_load)
        dyn = schedule_dyn(len(self.graph.tasks), src, dst,
                           num_cores=self.num_cores, priority=prio,
                           bucket=bkt, task_cost=cost, pin_core=pin,
                           dep_opt=False)
        self.sched = dyn
        C = self.num_cores
        self.qlen = _cdiv(max(dyn["n_claims"], 1), C)
        claims = np.full(self.qlen * C, -1, np.int32)
        claims[:dyn["n_claims"]] = dyn["claim_order"]
        self.claims = claims.reshape(self.qlen, C)
        self._emit_slot_tables(claims, self.claims.shape)

    def _emit_slot_tables(self, qc, shape):
        """Flat slot list (static merged queue or dynamic claim order) ->
        the JAX kernel's per-slot type and arg tables, and the claim list
        both step forms here run: the slot list without its NOOP holes, a
        topological order of every task."""
        g = self.graph
        noop_args = [0] * ARGS_MAX
        self.task_types = np.array(
            [g.tasks[t].task_type if t >= 0 else int(TaskType.NOOP)
             for t in qc], np.int32).reshape(shape)
        self.task_args = np.array(
            [g.tasks[t].encoded_args() if t >= 0 else noop_args
             for t in qc], np.int32).reshape(*shape, ARGS_MAX)
        self.claim_list = np.asarray(
            [int(t) for t in np.asarray(qc).reshape(-1) if t >= 0], np.int32)

    def _task_units(self, t) -> int:
        """Static work-unit estimate per task (the JAX cost model)."""
        if t.task_type == TaskType.LINEAR:
            return int(t.args[3])
        if t.task_type == TaskType.ATTN_DECODE:
            return 4 * self.d_tiles
        if t.task_type == TaskType.ATTN_PREFILL:
            return 8 * self.d_tiles * max(self.seq // 8, 1)
        if t.task_type in (TaskType.ATTN_QBLOCK, TaskType.ATTN_CHUNK):
            return 4 * self.d_tiles * self.seq
        if t.task_type == TaskType.WRITE_KV_PREFILL:
            return 2 * max(self.seq // 8, 1)
        if t.task_type in (TaskType.WRITE_KV_QBLOCK, TaskType.WRITE_KV_CHUNK):
            return 2 * self.seq
        if t.task_type == TaskType.ALLREDUCE:
            return 2 * int(t.args[1])
        if t.task_type == TaskType.WEIGHTED_ADD:
            return int(t.args[4])
        return 1

    # ---------------- device contract ----------------------------------
    def _emit_device_tables(self):
        """Per task its type, its 8 args and its pruned predecessors as a
        CSR list; with :attr:`claim_list`, all the kernel reads."""
        tasks = self.graph.tasks
        n = len(tasks)
        self.type_of = np.array([int(t.task_type) for t in tasks], np.int32)
        self.args_of = np.array([t.encoded_args() for t in tasks], np.int32)
        # The kernel's ALLREDUCE reads its ordinal among the build's
        # ALLREDUCE tasks (its flags' slot) from arg 2, which the graph's
        # task leaves 0.
        ar = np.flatnonzero(self.type_of == int(TaskType.ALLREDUCE))
        self.args_of[ar, 2] = np.arange(len(ar))
        self.n_allreduce = len(ar)
        psrc, pdst = self._pruned_edges
        order = np.argsort(pdst, kind="stable")
        self.preds = np.ascontiguousarray(psrc[order], np.int32)
        self.pred_start = np.zeros(n + 1, np.int32)
        np.cumsum(np.bincount(pdst, minlength=n), out=self.pred_start[1:])

    def isolate(self, task_ids) -> "ModelBuilder":
        """A copy of this build whose launch (and plain step) runs only
        ``task_ids``, in that order, waiting on nothing: for holding one
        task's CUDA body against its plain body on the same inputs.
        Tasks of one launch run concurrently, so a task that reads
        another's output needs a launch of its own."""
        one = copy.copy(self)
        one.claim_list = np.asarray(task_ids, np.int32)
        one.pred_start = np.zeros_like(self.pred_start)
        one.preds = np.zeros(0, np.int32)
        one._device_tables = {}
        return one

    def routed_experts(self, arena: torch.Tensor) -> torch.Tensor:
        """(layers, batch, num_experts) bool: the experts each row of the
        last launch routed to in each layer, read off the combine-weight
        tiles (``MOE_WEIGHTS`` writes a nonzero weight exactly where it
        selected)."""
        E, b = self.cfg.num_experts, self.batch
        return torch.stack([
            arena[self._offsets[f"l{li}.wbe"]:][:b, :E] != 0
            for li in range(self.cfg.num_hidden_layers)])

    def describe_task(self, t: int) -> str:
        task = self.graph.tasks[t]
        return (f"task {t} ({TaskType(task.task_type).name}, layer "
                f"{task.layer}, args {list(task.args)})")

    # ---------------- arena packing ------------------------------------
    def pack_arena(self, params, *, dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
        """The (arena_rows, w) arena from a
        :class:`~triton_dist_tpu_torch.models.dense.DenseLM` (or a
        :class:`~triton_dist_tpu_torch.models.qwen_moe.MoELM` for a MoE
        build): the weight region in the JAX package's layout and order,
        the rest zeroed. At tp = n > 1 it is (n, arena_rows, w), rank r's
        slice packed from rank r's shards of the one model (the JAX
        ``pack_arena`` of rank r's ``param_specs`` shards).
        :meth:`pack_layer` and :meth:`pack_head` fill it piece by piece,
        for a caller that draws one layer at a time."""
        device = params.embed.device if device is None else device
        shape = (self.arena_rows, self.w)
        if self.n > 1:
            shape = (self.n, *shape)
        arena = torch.zeros(shape, dtype=dtype, device=device)
        for li, layer in enumerate(params.layers):
            self.pack_layer(arena, li, layer)
        self.pack_head(arena, params)
        return arena

    def rank_arenas(self, arena: torch.Tensor):
        """Each rank's (rows, w) arena: ``arena`` itself at one rank, its
        n slices at tp = n."""
        want = 2 if self.n == 1 else 3
        if arena.dim() != want or (self.n > 1 and arena.shape[0] != self.n):
            raise ValueError(f"arena {tuple(arena.shape)}: expected "
                             f"{'(rows, w)' if self.n == 1 else '(n, rows, w)'}"
                             f" for tp={self.n}")
        return [arena] if self.n == 1 else list(arena)

    def rank_pool(self, pool: torch.Tensor, r: int) -> torch.Tensor:
        """Rank r's KV heads of a pool that holds every rank's (a view)."""
        if self.n == 1:
            return pool
        return pool[:, :, :, r * self.kv_loc:(r + 1) * self.kv_loc]

    def _shard(self, w: torch.Tensor, r: int, *, rows: bool) -> torch.Tensor:
        """Rank r's shard of a full port weight (out, in): its output rows
        (column-parallel; ``rows=True``) or its input columns
        (row-parallel)."""
        if self.n == 1:
            return w
        return (column_shards(w, self.n) if rows
                else row_shards(w, self.n))[r]

    def _tile(self, arena, name, wt, k_tiles, n_tiles) -> None:
        """Weight block ``(kt, j)`` of region ``name`` holds
        ``W.T[kt*w:(kt+1)*w, j*w:(j+1)*w]`` for a port weight ``W`` of
        shape ``(out, in)``, zero-padded to whole tiles."""
        w = self.w
        n_out, n_in = wt.shape
        wt = wt.contiguous()                 # a row-parallel shard is strided
        if (n_out, n_in) != (n_tiles * w, k_tiles * w):
            padded = torch.zeros(n_tiles * w, k_tiles * w, dtype=wt.dtype,
                                 device=wt.device)
            padded[:n_out, :n_in] = wt
            wt = padded
        r = self.schema.region(name)
        arena[r.offset:r.offset + r.rows].view(
            k_tiles, n_tiles, w, w).copy_(
                wt.view(n_tiles, w, k_tiles, w).permute(2, 0, 3, 1))

    def _vec(self, arena, name, v) -> None:
        r = self.schema.region(name)
        arena[r.offset:r.offset + r.rows].view(-1)[:v.shape[0]] = v

    @torch.no_grad()
    def pack_layer(self, arena: torch.Tensor, li: int, layer) -> None:
        """Layer ``li``'s weights into their regions of ``arena`` (every
        rank's shards at tp > 1)."""
        for r, ar in enumerate(self.rank_arenas(arena)):
            self._pack_layer(ar, li, layer, r)

    def _pack_layer(self, arena: torch.Tensor, li: int, layer, r: int):
        d_t, hq_t, kv_t, ff_t = (self.d_tiles, self.hq_tiles, self.kv_tiles,
                                 self.ff_tiles)
        a = layer.attn
        for name, k_t, n_t, rows in (("wq", d_t, hq_t, True),
                                     ("wk", d_t, kv_t, True),
                                     ("wv", d_t, kv_t, True),
                                     ("wo", hq_t, d_t, False)):
            self._tile(arena, f"l{li}.{name}",
                       self._shard(getattr(a, name), r, rows=rows), k_t, n_t)
        if self.moe:
            m, ffe_t = layer.moe, self.ffe_tiles
            self._tile(arena, f"l{li}.router", m.router, d_t, 1)
            for e in range(self.cfg.num_experts):
                self._tile(arena, f"l{li}.e{e}.w_gate", m.w_gate[e], d_t,
                           ffe_t)
                self._tile(arena, f"l{li}.e{e}.w_up", m.w_up[e], d_t, ffe_t)
                self._tile(arena, f"l{li}.e{e}.w_down", m.w_down[e], ffe_t,
                           d_t)
        else:
            m = layer.mlp
            for name, k_t, n_t, rows in (("w_gate", d_t, ff_t, True),
                                         ("w_up", d_t, ff_t, True),
                                         ("w_down", ff_t, d_t, False)):
                self._tile(arena, f"l{li}.{name}",
                           self._shard(getattr(m, name), r, rows=rows),
                           k_t, n_t)
        self._vec(arena, f"l{li}.ln_attn", layer.ln_attn)
        self._vec(arena, f"l{li}.ln_mlp", layer.ln_mlp)
        self._vec(arena, f"l{li}.q_norm", a.q_norm)
        self._vec(arena, f"l{li}.k_norm", a.k_norm)

    @torch.no_grad()
    def pack_head(self, arena: torch.Tensor, params) -> None:
        """The final norm, the embedding rows and the lm_head (rank r's
        vocabulary rows of both at tp > 1)."""
        d_t = self.d_tiles
        reg = self.schema.region("embed")
        for r, ar in enumerate(self.rank_arenas(arena)):
            self._vec(ar, "ln_f", params.ln_f)
            ar[reg.offset:reg.offset + reg.rows].view(
                self.vocab_loc, d_t * self.w)[:, :self.cfg.hidden_size] = \
                self._shard(params.embed, r, rows=True)
            self._tile(ar, "lm_head_T",
                       self._shard(params.lm_head, r, rows=True), d_t,
                       self.vloc_tiles)

    # ---------------- the step -----------------------------------------
    def kernel_config(self) -> K.KernelConfig:
        return K.KernelConfig(
            w=self.w, batch=self.batch, h_loc=self.h_loc, kv_loc=self.kv_loc,
            hd=self.cfg.head_dim, rope_theta=self.cfg.rope_theta,
            rms_eps=self.cfg.rms_norm_eps, paged=self.paged, page=self.page,
            p_max=self.p_max, seq=self.seq,
            moe_topk=self.cfg.num_experts_per_tok if self.moe else 0,
            moe_norm=self.cfg.norm_topk_prob, kv_quant=self.kv_quant,
            qmax=self.kv_qmax, n_ranks=self.n, ar_ws_off=self.ar_ws_off,
            ar_max_tiles=self.ar_max_tiles)

    def logits(self, arena: torch.Tensor, rows=None) -> torch.Tensor:
        """fp32 logits of the last step, read out of the arena's logits
        region: (batch, vocab) for ``rows=None``, (len(rows), vocab) for a
        sequence of row indices, (vocab,) for one int row. Only the rows
        asked for are converted (a 512-row chunk holds 155 MB of bf16
        logits at Qwen3's vocab; the server needs one row). At tp > 1 the
        ranks' vocabulary shards are concatenated in rank order."""
        return torch.cat([self._rank_logits(a, rows)
                          for a in self.rank_arenas(arena)], dim=-1)

    def _rank_logits(self, arena: torch.Tensor, rows) -> torch.Tensor:
        b, w, lt = self.batch, self.w, self.vloc_tiles
        region = arena[self.logits_off:self.logits_off + lt * b].view(lt, b, w)
        if rows is None:
            out = region.permute(1, 0, 2).reshape(b, lt * w)
        elif isinstance(rows, (int, np.integer)):
            return region[:, int(rows)].reshape(lt * w)[
                :self.vocab_loc].float()
        else:
            idx = torch.as_tensor(np.asarray(rows, np.int64),
                                  device=arena.device)
            out = region[:, idx].permute(1, 0, 2).reshape(len(idx), lt * w)
        return out[:, :self.vocab_loc].float()

    def _row_positions(self, lens: np.ndarray) -> np.ndarray:
        """Each row's cache position under this build's row rule (the
        plain bodies' ``_*_rows``)."""
        if self.mode == "chunk":
            return np.maximum(np.where(lens >= 0, lens, -lens - 2), 0)
        if self.mode == "qblock":
            return np.maximum(lens, 0)
        if self.mode == "prefill":
            return lens + np.arange(self.batch) % self.seq
        return lens

    def _host_inputs(self, k_cache, token_ids, cache_len, block_table):
        b = self.batch
        toks = np.asarray(torch.as_tensor(token_ids).cpu(),
                          np.int64).reshape(-1)
        lens = np.array(np.broadcast_to(np.asarray(
            torch.as_tensor(cache_len).cpu(), np.int64).reshape(-1), (b,)))
        if toks.shape != (b,):
            raise ValueError(f"token_ids {toks.shape} != ({b},)")
        pos = self._row_positions(lens)
        if (self.mode not in ("chunk", "qblock") and lens.min() < 0) \
                or pos.max() >= self.max_len:
            raise ValueError(f"cache_len {lens.tolist()} puts a row "
                             f"outside [0, max_len={self.max_len})")
        if self.paged:
            if block_table is None:
                raise ValueError("a paged step needs its block table")
            table = np.asarray(torch.as_tensor(block_table).cpu(),
                               np.int64).reshape(-1)
            if table.shape != (self.n_slots * self.p_max,):
                raise ValueError(f"block table {table.shape} != "
                                 f"({self.n_slots * self.p_max},)")
            if table.min() < 0 or table.max() >= k_cache.shape[1]:
                raise ValueError(f"block table ids outside the pool of "
                                 f"{k_cache.shape[1]} pages")
        else:
            table = np.arange(self.n_slots, dtype=np.int64)
        return toks, lens, table

    def step(self, arena, k_cache, v_cache, token_ids, cache_len,
             block_table=None, *, rows=None, counts=None,
             timeout_s: float = DEFAULT_TIMEOUT_S, k_scale=None,
             v_scale=None) -> torch.Tensor:
        """One launch of this build, IN PLACE on ``arena`` and the pools.

        arena: (rows >= arena_rows, w), shared by every build of one
        engine; k_cache/v_cache: (layers, num_pages, page, kv, hd) paged
        or (layers, slots, max_len, kv, hd) dense; token_ids (batch,);
        cache_len: a scalar or (batch,) per-row values read by the row
        rule (decode: each row's position, where it writes its K/V and
        attends ``cache_len + 1`` keys; batched prefill: the shared base;
        chunk: the sign-encoded codes; Q-block: each row's position, < 0
        masking it); block_table: the flat (n_slots * p_max,) page ids
        when paged (a chunk's: its slot's (p_max,) row); counts: a MoE
        build's int32 expert counters (``moe_counts`` rows x w, on the
        arena's device), which the step adds to; k_scale/v_scale: a
        quantized build's (layers, num_pages, kv) fp32 scale tables,
        updated in place with the pools. Returns fp32 logits of ``rows``
        (see :meth:`logits`).

        CUDA tensors launch the megakernel on every block that fits on the
        card and wait for it (``timeout_s`` bounds each wait in the
        kernel, and one that runs out raises
        :class:`MegakernelTimeoutError`); CPU tensors run the plain
        interpreter."""
        if arena.device.type == "cpu":
            return self.plain_step(arena, k_cache, v_cache, token_ids,
                                   cache_len, block_table, rows=rows,
                                   counts=counts, k_scale=k_scale,
                                   v_scale=v_scale)
        toks, lens, table = self._host_inputs(k_cache, token_ids, cache_len,
                                              block_table)
        self.launch(arena, k_cache, v_cache, toks, lens, table,
                    counts=counts, timeout_s=timeout_s, k_scale=k_scale,
                    v_scale=v_scale)
        self.wait(arena.device)
        return self.logits(arena, rows)

    def plain_step(self, arena, k_cache, v_cache, token_ids, cache_len,
                   block_table=None, *, rows=None, counts=None,
                   route_from=None, k_scale=None,
                   v_scale=None) -> torch.Tensor:
        """The plain version of :meth:`step`, on tensors of any device:
        the claim list in order through the PyTorch task bodies.
        ``route_from`` (MoE): an arena of another run of this build whose
        router-logit tiles replace this run's, each right after its
        router ``LINEAR``, so that this run routes as that one did (a
        kernel run is then held to the plain bodies under its own
        routing: a router logit one bf16 unit off moves an expert's whole
        combine weight by about 1 %, and may swap its 8th and 9th
        expert)."""
        toks, lens, table = self._host_inputs(k_cache, token_ids, cache_len,
                                              block_table)
        self._check_counts(counts, arena.device)
        self._check_scales(k_cache, k_scale, v_scale, arena.device)
        self.interpret(arena, k_cache, v_cache, toks, lens, table, counts,
                       route_from=route_from, k_scale=k_scale,
                       v_scale=v_scale)
        return self.logits(arena, rows)

    def _check_scales(self, k_cache, k_scale, v_scale, device) -> None:
        """A quantized build needs its pools in the storage dtype and two
        contiguous fp32 (layers, num_pages, kv) scale tables on
        ``device``; an unquantized build takes none."""
        if self.kv_quant is None:
            if k_scale is not None or v_scale is not None:
                raise ValueError("an unquantized build takes no scales")
            return
        want = KV_QUANT_DTYPES[self.kv_quant]
        if k_cache.dtype != want:
            raise TypeError(f"a {self.kv_quant} build needs {want} pools, "
                            f"got {k_cache.dtype}")
        shape = (self.cfg.num_hidden_layers, k_cache.shape[1], self.kv_loc)
        for t in (k_scale, v_scale):
            if (t is None or t.dtype != torch.float32 or t.device != device
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(f"a quantized step needs contiguous fp32 "
                                 f"k_scale/v_scale {shape} on {device}")

    def _check_counts(self, counts, device) -> None:
        """A MoE build needs its int32 counters (``moe_counts`` rows x w)
        on ``device``; a dense build takes none."""
        if not self.moe:
            if counts is not None:
                raise ValueError("a dense build takes no expert counters")
            return
        rows = self.schema.region("moe_counts").rows
        if (counts is None or counts.dtype != torch.int32
                or counts.device != device or not counts.is_contiguous()
                or tuple(counts.shape) != (rows, self.w)):
            raise ValueError(f"a MoE step needs contiguous int32 expert "
                             f"counters ({rows}, {self.w}) on {device}")

    def interpret(self, arena, k_cache, v_cache, toks, lens, table,
                  counts=None, *, route_from=None, k_scale=None,
                  v_scale=None) -> None:
        """The plain version: the claim list in order through the PyTorch
        task bodies (:data:`kernels.BODIES`); ``route_from`` as in
        :meth:`plain_step`."""
        table = torch.as_tensor(table, dtype=torch.int64,
                                device=arena.device)
        states = [K.StepState(arena=a, k_cache=self.rank_pool(k_cache, r),
                              v_cache=self.rank_pool(v_cache, r),
                              tokens=[int(t) for t in toks],
                              lens=[int(x) for x in lens], table=table,
                              counts=counts, k_scale=k_scale,
                              v_scale=v_scale, rank=r)
                  for r, a in enumerate(self.rank_arenas(arena))]
        cfg = self.kernel_config()
        tasks = self.graph.tasks
        b = self.batch
        for t in self.claim_list:
            task = tasks[t]
            if task.task_type == TaskType.ALLREDUCE:
                # Every rank has run every task before this one: their
                # slabs are all written.
                K.allreduce_ranks(cfg, task.args, states)
                continue
            for st in states:
                K.BODIES[task.task_type](cfg, task.args, st)
            if route_from is not None and t in self._router_tasks:
                rl = task.args[2]
                arena[rl:rl + b] = route_from[rl:rl + b]

    def check_kernel_args(self, arena, k_cache, v_cache) -> None:
        """What ``csrc/megakernel.cu`` takes; raises on anything else."""
        dev = arena.device
        if dev.type != "cuda":
            raise RuntimeError(f"the megakernel runs on CUDA tensors (got "
                               f"{dev}); only CPU tensors take the plain "
                               "version")
        pool_dtype = KV_QUANT_DTYPES[self.kv_quant]
        for t, want in ((arena, torch.bfloat16), (k_cache, pool_dtype),
                        (v_cache, pool_dtype)):
            if t.device != dev or t.dtype != want:
                raise TypeError(f"expected a {want} tensor on {dev}, got "
                                f"{t.dtype} on {t.device}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("the arena and the pools must be "
                                 "contiguous and 16-byte aligned")
        cfg = self.cfg
        rep = self.h_loc // self.kv_loc
        for ok, what in (
                (self.w == KERNEL_TILE_W, f"tile width {self.w}"),
                (cfg.head_dim == KERNEL_HEAD_DIM, f"head_dim {cfg.head_dim}"),
                (rep <= KERNEL_MAX_GQA, f"{rep} query heads per KV head")):
            if not ok:
                raise ValueError(
                    f"{what}: csrc/megakernel.cu is compiled for tile width "
                    f"{KERNEL_TILE_W} = head_dim {KERNEL_HEAD_DIM} and <= "
                    f"{KERNEL_MAX_GQA} query heads per KV head")
        bad = set(TaskType(t) for t in np.unique(self.type_of)) - KERNEL_TYPES
        if bad:
            raise NotImplementedError(f"task types {sorted(bad)} have no "
                                      "CUDA body (ROADMAP.md)")
        lead = () if self.n == 1 else (self.n,)
        if (tuple(arena.shape[:-2]) != lead or arena.shape[-2] < self.arena_rows
                or arena.shape[-1] != self.w):
            raise ValueError(f"arena {tuple(arena.shape)} smaller than "
                             f"{(*lead, self.arena_rows, self.w)}")
        L, kv, hd = cfg.num_hidden_layers, self.n * self.kv_loc, cfg.head_dim
        want = ((L, k_cache.shape[1], self.page, kv, hd) if self.paged
                else (L, self.n_slots, self.max_len, kv, hd))
        if tuple(k_cache.shape) != want or k_cache.shape != v_cache.shape:
            raise ValueError(f"pools {tuple(k_cache.shape)} / "
                             f"{tuple(v_cache.shape)} != {want}")

    def _tables_on(self, device) -> dict:
        tabs = self._device_tables.get(device)
        if tabs is None:
            def up(a):
                return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                       device=device)
            tabs = {"claims": up(self.claim_list), "types": up(self.type_of),
                    "args": up(self.args_of),
                    "pred_start": up(self.pred_start),
                    "preds": up(self.preds if len(self.preds) else [0]),
                    # Per rank: the claim counter, the failure gate, the
                    # done flags.
                    "sync": torch.zeros(self.n * (2 + len(self.graph.tasks)),
                                        dtype=torch.int32, device=device)}
            self._device_tables[device] = tabs
        return tabs

    def launch(self, arena, k_cache, v_cache, toks, lens, table, *,
               counts=None, timeout_s: float = DEFAULT_TIMEOUT_S,
               task_ns: Optional[torch.Tensor] = None, k_scale=None,
               v_scale=None, fault: int = 0, fault_rank: int = 0,
               fault_ar: int = 0) -> None:
        """One launch of the CUDA megakernel on the current stream.
        ``counts``: a MoE build's int32 expert counters on the card;
        ``k_scale``/``v_scale``: a quantized build's scale tables.
        ``task_ns``: an optional int64 (n_tasks, 2) tensor on the card
        ((n, n_tasks, 2) at tp = n) that receives each task's start and
        end on the card's global timer (ns), for :meth:`task_ms`.

        At tp = n > 1 one launch runs every rank, each on its own share
        of the blocks; the ALLREDUCE tasks signal through epoch flags of
        a persistent workspace (per ALLREDUCE ordinal: one arrival flag
        per (receiver, sender) and one done flag per rank), and a wait
        past ``timeout_s`` aborts the launch, which :meth:`wait` turns
        into :class:`~triton_dist_tpu_torch.shmem.workspace.
        CommTimeoutError` naming the task. ``fault`` (a value of
        :data:`AR_FAULTS`) plants a fault into rank ``fault_rank``'s
        ``fault_ar``-th ALLREDUCE."""
        self.check_kernel_args(arena, k_cache, v_cache)
        self._check_counts(counts, arena.device)
        self._check_scales(k_cache, k_scale, v_scale, arena.device)
        dev = arena.device
        tabs = self._tables_on(dev)

        def up(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        tok_d, len_d, tbl_d = up(toks), up(lens), up(table)
        if self.paged:
            num_pages, page, p_max = k_cache.shape[1], self.page, self.p_max
        else:
            num_pages, page, p_max = self.n_slots, self.max_len, 1
        rec = 0
        if task_ns is not None:
            shape = (len(self.graph.tasks), 2)
            if self.n > 1:
                shape = (self.n, *shape)
            if (task_ns.device != dev or task_ns.dtype != torch.int64
                    or tuple(task_ns.shape) != shape
                    or not task_ns.is_contiguous()):
                raise ValueError("task_ns must be a contiguous int64 "
                                 f"{shape} tensor on {dev}")
            rec = task_ns.data_ptr()
        n = self.n
        flags = abort = epoch = 0
        if n > 1:
            if not (0 <= fault_rank < n and 0 <= fault_ar < self.n_allreduce):
                raise ValueError(f"fault_rank={fault_rank} / fault_ar="
                                 f"{fault_ar} outside {n} ranks x "
                                 f"{self.n_allreduce} ALLREDUCE tasks")
            # A record an earlier launch left raises first.
            shmem.check_errors(dev, sources=(KERNEL.source,))
            ws = shmem.workspace("megakernel", (self.n_allreduce,), n=n,
                                 device=dev,
                                 n_flags=self.n_allreduce * (n * n + n))
            epoch = ws.next_epoch()
            shmem.watch(KERNEL.source, epoch, self.describe_wait)
            flags, abort = ws.flags.data_ptr(), ws.abort_ptr
        elif fault:
            raise ValueError("the ALLREDUCE faults need tp > 1")
        cfg = self.cfg
        KERNEL.launch(
            arena.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            tok_d.data_ptr(), len_d.data_ptr(), tbl_d.data_ptr(),
            tabs["claims"].data_ptr(), tabs["types"].data_ptr(),
            tabs["args"].data_ptr(), tabs["pred_start"].data_ptr(),
            tabs["preds"].data_ptr(), tabs["sync"].data_ptr(), rec,
            0 if counts is None else counts.data_ptr(),
            len(self.claim_list), len(self.graph.tasks), self.batch,
            self.seq, self.w, cfg.head_dim, self.h_loc, self.kv_loc,
            num_pages, page, p_max, cfg.rms_norm_eps, cfg.rope_theta,
            int(timeout_s * 1e9), int(self.uses_tensor_cores),
            cfg.num_experts_per_tok if self.moe else 0,
            int(cfg.norm_topk_prob),
            0 if k_scale is None else k_scale.data_ptr(),
            0 if v_scale is None else v_scale.data_ptr(),
            KV_QUANT_CODES[self.kv_quant], self.kv_qmax,
            n, self.ar_ws_off, self.ar_max_tiles, k_cache.shape[3], fault,
            arena.shape[-2], flags, abort, epoch, fault_rank, fault_ar,
            self.n_allreduce, device=dev)
        MODE_LAUNCHES[self.launch_key] += 1

    def describe_wait(self, rank: int, task: int, slot: int) -> str:
        """The ALLREDUCE wait that timed out, from the kernel's record:
        the waiting rank, the task, and its flag slot (per ALLREDUCE
        ordinal k: n·n arrival flags [receiver][sender], then n done
        flags)."""
        n = self.n
        k, rem = divmod(slot, n * n + n)
        if rem < n * n:
            what = (f"rank {rem % n}'s slab (arrival flag [{rem // n}]"
                    f"[{rem % n}])")
        else:
            what = (f"rank {rem - n * n} to finish reading ALLREDUCE "
                    f"#{k - 1}")
        return (f"megakernel ALLREDUCE #{k}: rank {rank}, "
                f"{self.describe_task(task)}, waited for {what} (flag slot "
                f"{slot})")

    @property
    def launch_key(self) -> str:
        """This build's :data:`MODE_LAUNCHES` key: its row mode, with its
        pool storage for a quantized build ("chunk-int8")."""
        return self.mode + (f"-{self.kv_quant}" if self.kv_quant else "")

    @property
    def uses_tensor_cores(self) -> bool:
        """Whether a launch runs the kernel's tensor-core instantiation
        (prompt modes, or more than KERNEL_CUDA_CORE_ROWS rows)."""
        return (self.mode != "decode"
                or self.batch > KERNEL_CUDA_CORE_ROWS)

    def task_ms(self, task_ns: torch.Tensor) -> Dict[str, Tuple[float, float]]:
        """Per task type, the summed and the longest task time (ms) of a
        launch recorded into ``task_ns`` (:meth:`launch`; at tp > 1 the
        sum runs over every rank's tasks)."""
        ns = task_ns.cpu().numpy().reshape(-1, len(self.graph.tasks), 2)
        dur = (ns[..., 1] - ns[..., 0]) / 1e6
        out = {}
        for t, d in zip(np.tile(self.type_of, len(ns)), dur.reshape(-1)):
            name = TaskType(int(t)).name
            tot, top = out.get(name, (0.0, 0.0))
            out[name] = (tot + float(d), max(top, float(d)))
        return out

    def wait(self, device) -> None:
        """Wait for the launched step; a wait that timed out in the kernel
        raises :class:`MegakernelTimeoutError` naming the task, and, at
        tp > 1, an ALLREDUCE wait that timed out (the launch aborted)
        :class:`~triton_dist_tpu_torch.shmem.workspace.CommTimeoutError`
        naming it."""
        try:
            torch.cuda.current_stream(device).synchronize()
            if self.n > 1:
                shmem.check_errors(device, sources=(KERNEL.source,))
        except RuntimeError as e:
            if isinstance(e, shmem.CommTimeoutError):
                raise
            rec = (ctypes.c_int * 4)()
            read = load(KERNEL.source).tdt_megakernel_error
            read.argtypes = [ctypes.POINTER(ctypes.c_int)]
            read.restype = ctypes.c_int
            if read(rec):
                task, pred, claim = rec[1], rec[2], rec[3]
                if pred < 0:
                    raise MegakernelTimeoutError(
                        f"megakernel: {self.describe_task(task)} has no CUDA "
                        "body") from e
                raise MegakernelTimeoutError(
                    f"megakernel wait timed out: {self.describe_task(task)} "
                    f"(claim {claim}) waited on "
                    f"{self.describe_task(pred)}") from e
            raise


def grid_blocks(device, tensor_cores: bool = False) -> int:
    """Blocks in one megakernel launch on ``device`` (of the decode or
    the tensor-core instantiation): resident blocks per SM (the
    occupancy API) times the SMs. A launch of n ranks gives each rank
    ``grid_blocks // n`` of them."""
    fn = load(KERNEL.source).tdt_megakernel_grid
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    n = fn(torch.device(device).index or 0, int(tensor_cores))
    if n <= 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n
