"""Plain PyTorch task bodies of the megakernel (counterpart of
``triton_dist_tpu/megakernel/kernels.py``).

Each body computes what the JAX task body of the same name computes, on
the same arena layout: activations as consecutive ``(batch, w)`` tiles,
weights as tile-major ``(w, w)`` blocks, one ``(rows, w)`` arena. Math is
fp32 inside a task; every output is rounded to the arena's (or the
pool's) dtype when it is stored, as the CUDA kernel
(``csrc/megakernel.cu``) rounds it. :meth:`ModelBuilder.step
<triton_dist_tpu_torch.megakernel.builder.ModelBuilder.step>` runs these
bodies over the claim list for CPU tensors; the CUDA kernel replaces them
for CUDA tensors.

The port carries the dense decode set (``RMSNORM``, ``LINEAR``,
``ADD``, ``SILU_MUL``, ``WRITE_KV``, ``ATTN_DECODE``, ``GATHER``,
``ALLREDUCE`` at one rank, ``NOOP``), batched prefill
(``WRITE_KV_PREFILL``/``ATTN_PREFILL``), the prefill chunk
(``WRITE_KV_CHUNK``/``ATTN_CHUNK``), the speculative verify block
(``WRITE_KV_QBLOCK``/``ATTN_QBLOCK``) and the MoE pair (``MOE_WEIGHTS``,
the in-kernel router with its expert counters, and ``WEIGHTED_ADD``, the
per-expert combine), whose rows follow the build's ``batch`` in every
row mode. The four cache pairs differ only in
their row rule: which slot's block-table row a batch row reads, at which
position, and whether it writes (:func:`_decode_rows`,
:func:`_prefill_rows`, :func:`_chunk_rows`, :func:`_qblock_rows`); one
write core and one attention core serve all four.

Quantized pools (``cfg.kv_quant`` "int8"/"fp8", paged): the pools store
one byte per element with one fp32 scale per (layer, page, kv_head) in
``st.k_scale``/``st.v_scale``. Writes quantize token by token under a
running max-abs scale (:func:`_quant_store_token`), reads dequantize.
Only the hybrid GDN type raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from triton_dist_tpu_torch.megakernel.task import TaskType


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    w: int                  # arena lane width (tile size)
    batch: int              # decode batch B
    h_loc: int              # attention heads
    kv_loc: int             # KV heads
    hd: int                 # head dim (divides w)
    rope_theta: float
    rms_eps: float
    # KV addressing: paged pools (layers, num_pages, page, kv, hd) read
    # through a flat (batch * p_max,) block table, or dense caches
    # (layers, batch, max_len, kv, hd) indexed by batch row.
    paged: bool = False
    page: int = 0
    p_max: int = 0
    # Rows per slot of a batched-prefill build (batch = slots * seq,
    # slot-major); a chunk build has batch = seq = C rows of one slot.
    seq: int = 1
    # MoE routing: experts kept per row, and whether their combine
    # weights are renormalised to sum to one.
    moe_topk: int = 0
    moe_norm: bool = True
    # Quantized pools: "int8" | "fp8" (None: the pools' own dtype), and
    # the storage's largest code (127 or 448).
    kv_quant: Optional[str] = None
    qmax: float = 0.0


@dataclasses.dataclass
class StepState:
    """What one step reads and writes: the arena, the K/V pools, and the
    step's per-row scalars as host lists (tokens; per-row cache lengths,
    the shared base of a batched prefill, or a chunk's sign-encoded
    codes; the flat block table) and, for a MoE build, the int32
    expert counters."""
    arena: torch.Tensor
    k_cache: torch.Tensor
    v_cache: torch.Tensor
    tokens: List[int]
    lens: List[int]
    table: torch.Tensor      # flat int64 block table (paged) or unused
    counts: Optional[torch.Tensor] = None   # (counts_rows, w) int32
    # Quantized pools: (layers, num_pages, kv) fp32 dequant scales.
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _load(st: StepState, off: int, rows: int) -> torch.Tensor:
    return st.arena[off:off + rows].float()


def _store(st: StepState, off: int, x: torch.Tensor) -> None:
    st.arena[off:off + x.shape[0]] = x.to(st.arena.dtype)


def _heads(tiles: torch.Tensor, b: int, hd: int) -> torch.Tensor:
    """(n_tiles * b, w) activation tiles -> (b, n_tiles * w // hd, hd)."""
    n = tiles.shape[0] // b
    return tiles.view(n, b, -1).permute(1, 0, 2).reshape(b, -1, hd)


def _tiles(heads: torch.Tensor, w: int) -> torch.Tensor:
    """(b, heads, hd) -> (n_tiles * b, w), the inverse of :func:`_heads`."""
    b = heads.shape[0]
    return heads.reshape(b, -1, w).permute(1, 0, 2).reshape(-1, w)


def _kv_rows(cfg: KernelConfig, st: StepState, slot: int, positions):
    """(pool slot, in-page offset) of ``slot``'s cache ``positions``: a
    block-table lookup when paged, the slot's own row when dense (the JAX
    ``_kv_slice``)."""
    if not cfg.paged:
        return torch.full_like(positions, slot), positions
    pids = st.table[slot * cfg.p_max + torch.div(positions, cfg.page,
                                                 rounding_mode="floor")]
    return pids, positions % cfg.page


# Row rules: (slot, position, writes) of every batch row, as tensors.

def _decode_rows(cfg: KernelConfig, st: StepState):
    """Decode: row r is slot r, at its own length, and always writes."""
    dev = st.arena.device
    pos = torch.tensor(st.lens, dtype=torch.int64, device=dev)
    return (torch.arange(cfg.batch, device=dev), pos,
            torch.ones(cfg.batch, dtype=torch.bool, device=dev))


def _prefill_rows(cfg: KernelConfig, st: StepState):
    """Batched prefill: rows are (slot, s) pairs, slot-major; row r is
    slot ``r // seq`` at ``base + r % seq``, the base being the row's
    length entry (the same for every row: the JAX engine passes
    ``full((B*S,), start_pos)``)."""
    dev = st.arena.device
    r = torch.arange(cfg.batch, device=dev)
    base = torch.tensor(st.lens, dtype=torch.int64, device=dev)
    return (torch.div(r, cfg.seq, rounding_mode="floor"), base + r % cfg.seq,
            torch.ones(cfg.batch, dtype=torch.bool, device=dev))


def _chunk_apos(enc: torch.Tensor) -> torch.Tensor:
    """A chunk row's sign-encoded position decoded to the position it
    attends at, clamped to >= 0 (:func:`~triton_dist_tpu_torch.ops.
    chunked_prefill.chunk_row_codes`): ``enc >= 0`` writes and attends at
    ``enc``; ``enc <= -2`` attends only, at ``-enc - 2``; ``-1`` is a
    dead padding row, decoded to position 0, whose output the host
    discards and which writes nothing."""
    return torch.clamp(torch.where(enc >= 0, enc, -enc - 2), min=0)


def _chunk_rows(cfg: KernelConfig, st: StepState):
    """Prefill chunk: every row is the one slot whose (p_max,) table row
    the launch carries, at its decoded position; writes iff its code is
    >= 0."""
    dev = st.arena.device
    enc = torch.tensor(st.lens, dtype=torch.int64, device=dev)
    return (torch.zeros(cfg.batch, dtype=torch.int64, device=dev),
            _chunk_apos(enc), enc >= 0)


def _qblock_rows(cfg: KernelConfig, st: StepState):
    """Q-block (speculative verify): rows are (slot, j) pairs, slot-major,
    ``seq`` = K rows a slot; row r is slot ``r // K`` at its own position
    ``lens[r]``. A negative position masks the row: it writes no page and
    no scale (an over-budget candidate or a parked slot), and its output,
    attended at position 0, is garbage the host discards."""
    dev = st.arena.device
    r = torch.arange(cfg.batch, device=dev)
    pos = torch.tensor(st.lens, dtype=torch.int64, device=dev)
    return (torch.div(r, cfg.seq, rounding_mode="floor"),
            torch.clamp(pos, min=0), pos >= 0)


# Quantized pools: the JAX kernel's fused scheme, op for op.

def _quant_cast(x: torch.Tensor, qdtype: torch.dtype, qmax: float):
    """fp32 → storage dtype: int8 rounds half to even and clips to ±qmax;
    fp8 clips to ±qmax, then the cast rounds to nearest even."""
    if qdtype == torch.int8:
        return torch.clamp(torch.round(x), -qmax, qmax).to(torch.int8)
    return torch.clamp(x, -qmax, qmax).to(qdtype)


def _quant_store_token(cfg: KernelConfig, cache: torch.Tensor,
                       scales: torch.Tensor, layer: int, pid: int, off: int,
                       rows: torch.Tensor) -> None:
    """Quantize ONE token's (KV, hd) fp32 rows into page ``pid`` at
    ``off``, every KV head under its running max-abs scale: a page's first
    position (``off == 0``) resets the scale, so a reused page never
    inherits a stale one; a token whose amax exceeds the running amax
    grows the scale and first rescales the page's stored codes by
    ``s_old / s_new`` (rounding them twice, as the layer lane's merge
    does). Heads are independent, so all of them go at once."""
    qmax, qdtype = cfg.qmax, cache.dtype
    amax = rows.abs().amax(dim=-1)                       # (KV,)
    s_old = scales[layer, pid]
    zero = torch.zeros_like(amax)
    if off == 0:
        s_new = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    else:
        s_new = torch.maximum(s_old, torch.where(amax > 0, amax / qmax,
                                                 zero))
        grow = s_new > s_old
        if bool(grow.any()):
            ratio = (s_old / s_new)[None, :, None]          # (1, KV, 1)
            page = cache[layer, pid]                        # (page, KV, hd)
            cache[layer, pid] = torch.where(
                grow[None, :, None],
                _quant_cast(page.float() * ratio, qdtype, qmax), page)
    cache[layer, pid, off] = _quant_cast(rows / s_new[:, None], qdtype,
                                         qmax)
    scales[layer, pid] = s_new


def _rms_rows(x: torch.Tensor, w_row: torch.Tensor, eps: float):
    """RMSNorm over the last dim of fp32 ``x`` with weight ``w_row``."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w_row


def _rope_rows(x: torch.Tensor, pos: torch.Tensor, hd: int, theta: float):
    """Half-rotation rope of fp32 ``x`` (b, heads, hd) at per-row
    positions ``pos`` (b,), frequencies computed in fp32 as the JAX body
    computes them."""
    half = hd // 2
    idx = torch.arange(half, dtype=torch.float32, device=x.device) * 2.0
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device), idx / hd)
    ang = pos.to(torch.float32)[:, None] * inv            # (b, half)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rmsnorm_body(cfg: KernelConfig, args, st: StepState) -> None:
    """RMSNorm of (b, d_tiles * w) rows; the mean divides by
    ``d_tiles * w``, the padded width, as the JAX body does."""
    in_off, w_off, out_off, d_tiles = args[:4]
    b, w = cfg.batch, cfg.w
    x = _load(st, in_off, d_tiles * b).view(d_tiles, b, w)
    ssq = (x * x).sum(dim=(0, 2))
    inv = torch.rsqrt(ssq / float(d_tiles * w) + cfg.rms_eps)
    wt = _load(st, w_off, d_tiles)
    _store(st, out_off, (x * inv[None, :, None]
                         * wt[:, None, :]).reshape(-1, w))


def linear_body(cfg: KernelConfig, args, st: StepState) -> None:
    """Output tile ``j``: x (b, k_tiles * w) times weight blocks
    ``(kt, j)`` for every kt."""
    in_off, w_off, out_off, k_tiles, n_tiles, j = args[:6]
    b, w = cfg.batch, cfg.w
    x = _load(st, in_off, k_tiles * b).view(k_tiles, b, w)
    wt = st.arena[w_off:w_off + k_tiles * n_tiles * w].view(
        k_tiles, n_tiles, w, w)[:, j].float()
    out = x.permute(1, 0, 2).reshape(b, k_tiles * w) @ wt.reshape(-1, w)
    _store(st, out_off + j * b, out)


def add_body(cfg: KernelConfig, args, st: StepState) -> None:
    a_off, b_off, out_off, tiles = args[:4]
    n = tiles * cfg.batch
    _store(st, out_off, _load(st, a_off, n) + _load(st, b_off, n))


def silu_mul_body(cfg: KernelConfig, args, st: StepState) -> None:
    g_off, u_off, out_off, tiles = args[:4]
    n = tiles * cfg.batch
    g = _load(st, g_off, n)
    _store(st, out_off, torch.nn.functional.silu(g) * _load(st, u_off, n))


def gather_body(cfg: KernelConfig, args, st: StepState) -> None:
    """Embedding rows of each row's token; a token outside the table
    (this rank's vocab shard, which is all of it at one rank) gives
    zeros."""
    table_off, out_off, d_tiles, vocab_loc = args[:4]
    b, w = cfg.batch, cfg.w
    out = torch.zeros(d_tiles, b, w, dtype=torch.float32,
                      device=st.arena.device)
    for bb, tok in enumerate(st.tokens):
        if 0 <= tok < vocab_loc:
            out[:, bb] = _load(st, table_off + tok * d_tiles, d_tiles)
    _store(st, out_off, out.view(-1, w))


def allreduce_body(cfg: KernelConfig, args, st: StepState) -> None:
    """A no-op at one rank, as the JAX body is (``n == 1``); the port
    builds one-rank graphs only."""


def _write_kv_rowpos(cfg: KernelConfig, args, st: StepState, slots, pos,
                     writes) -> None:
    """The write core of every cache pair: each writing row's new K
    (k-norm, then rope at its position) and V go to its position through
    its slot's table row. A row that does not write touches no pool row."""
    k_off, v_off, layer, knorm_off = args[:4]
    b, hd, kv_loc = cfg.batch, cfg.hd, cfg.kv_loc
    kv_tiles = _cdiv(kv_loc * hd, cfg.w)
    wrow = st.arena[knorm_off, :hd].float()
    k = _heads(_load(st, k_off, kv_tiles * b), b, hd)[:, :kv_loc]
    v = _heads(_load(st, v_off, kv_tiles * b), b, hd)[:, :kv_loc]
    k = _rope_rows(_rms_rows(k, wrow, cfg.rms_eps), pos, hd, cfg.rope_theta)
    # In row order: a later row wins a clash (parked decode rows share
    # the scratch page); a quantized page takes its tokens in ascending
    # position, as the rows come.
    for bb in torch.nonzero(writes).flatten().tolist():
        pid, off = _kv_rows(cfg, st, int(slots[bb]), pos[bb:bb + 1])
        if cfg.kv_quant:
            for cache, scales, x in ((st.k_cache, st.k_scale, k),
                                     (st.v_cache, st.v_scale, v)):
                _quant_store_token(cfg, cache, scales, layer, int(pid),
                                   int(off), x[bb])
            continue
        st.k_cache[layer, pid, off] = k[bb:bb + 1].to(st.k_cache.dtype)
        st.v_cache[layer, pid, off] = v[bb:bb + 1].to(st.v_cache.dtype)


def _attn_rowpos_body(cfg: KernelConfig, args, st: StepState, slots,
                      pos) -> None:
    """The attention core of every cache pair: GQA attention of each
    row's query heads (q-norm, rope at the row's position, then
    ``1/sqrt(hd)``) over its slot's keys at positions ``<= pos``, this
    launch's writes included. Query head ``h`` reads KV head
    ``h // (h_loc // kv_loc)``; padding heads of the last tile are zero.
    Rows of one slot are scored together under their per-row horizon."""
    q_off, out_off, layer, qnorm_off = args[:4]
    b, hd, h_loc, kv_loc = cfg.batch, cfg.hd, cfg.h_loc, cfg.kv_loc
    q_tiles = _cdiv(h_loc * hd, cfg.w)
    dev = st.arena.device
    qn = st.arena[qnorm_off, :hd].float()
    q = _heads(_load(st, q_off, q_tiles * b), b, hd)
    q = _rope_rows(_rms_rows(q, qn, cfg.rms_eps), pos, hd, cfg.rope_theta)
    q = q / math.sqrt(hd)
    kv_of = torch.arange(h_loc, device=dev) // (h_loc // kv_loc)
    out = torch.zeros_like(q)
    for slot in torch.unique(slots).tolist():
        rows = torch.nonzero(slots == slot).flatten()
        keys = torch.arange(int(pos[rows].max()) + 1, device=dev)
        pid, off = _kv_rows(cfg, st, slot, keys)
        kk = st.k_cache[layer, pid, off].float()             # (n, kv, hd)
        vv = st.v_cache[layer, pid, off].float()
        if cfg.kv_quant:                       # dequantize as it is read
            kk = kk * st.k_scale[layer, pid][..., None]
            vv = vv * st.v_scale[layer, pid][..., None]
        kk, vv = kk[:, kv_of], vv[:, kv_of]                  # (n, h_loc, hd)
        s = torch.einsum("rhd,nhd->rhn", q[rows, :h_loc], kk)
        s = s.masked_fill(keys[None, None, :] > pos[rows][:, None, None],
                          float("-inf"))
        m = s.max(dim=-1, keepdim=True).values
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.where(torch.isfinite(s), torch.exp(s - m),
                        torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True)
        out[rows, :h_loc] = (torch.einsum("rhn,nhd->rhd", p, vv)
                             / torch.clamp(l, min=1e-30))
    _store(st, out_off, _tiles(out, cfg.w))


def write_kv_body(cfg: KernelConfig, args, st: StepState) -> None:
    """Decode: append each row's K/V at its own position ``lens[bb]``."""
    _write_kv_rowpos(cfg, args, st, *_decode_rows(cfg, st))


def attn_decode_body(cfg: KernelConfig, args, st: StepState) -> None:
    """Decode: each row attends its ``lens[bb] + 1`` keys, this launch's
    WRITE_KV included."""
    slots, pos, _ = _decode_rows(cfg, st)
    _attn_rowpos_body(cfg, args, st, slots, pos)


def write_kv_prefill_body(cfg: KernelConfig, args, st: StepState) -> None:
    """Batched prefill: row r writes position ``base + r % seq`` of slot
    ``r // seq``."""
    _write_kv_rowpos(cfg, args, st, *_prefill_rows(cfg, st))


def attn_prefill_body(cfg: KernelConfig, args, st: StepState) -> None:
    """Batched causal prefill attention: row s of a slot attends that
    slot's positions ``<= base + s``."""
    slots, pos, _ = _prefill_rows(cfg, st)
    _attn_rowpos_body(cfg, args, st, slots, pos)


def write_kv_chunk_body(cfg: KernelConfig, args, st: StepState) -> None:
    """Prefill chunk: store row r's K/V iff its code is >= 0;
    attend-only rows (prefix-resident positions) and dead padding rows
    touch no page."""
    _write_kv_rowpos(cfg, args, st, *_chunk_rows(cfg, st))


def attn_chunk_body(cfg: KernelConfig, args, st: StepState) -> None:
    """Prefill chunk: row r attends keys at positions ``<= apos[r]``,
    earlier chunks, the shared prefix and this chunk's earlier rows alike
    (the paired WRITE_KV_CHUNK wrote them first), so chunk boundaries
    are invisible to the math. Dead rows compute garbage the host
    discards."""
    slots, pos, _ = _chunk_rows(cfg, st)
    _attn_rowpos_body(cfg, args, st, slots, pos)


def write_kv_qblock_body(cfg: KernelConfig, args, st: StepState) -> None:
    """Q-block verify: row r writes its candidate's K/V at ``lens[r]`` of
    slot ``r // K``; a masked row (``lens[r] < 0``) touches no page and no
    scale."""
    _write_kv_rowpos(cfg, args, st, *_qblock_rows(cfg, st))


def attn_qblock_body(cfg: KernelConfig, args, st: StepState) -> None:
    """Q-block verify: each candidate row attends its slot's keys at
    positions ``<= lens[r]`` (its history and the candidates through
    itself), the same per-row stream as decode, so an accepted
    candidate's logits are those a sequential decode would give."""
    slots, pos, _ = _qblock_rows(cfg, st)
    _attn_rowpos_body(cfg, args, st, slots, pos)


def moe_weights_body(cfg: KernelConfig, args, st: StepState) -> None:
    """Router epilogue: the fp32 softmax of each row's router logits over
    the first ``e_n`` columns (later columns masked to ``-inf`` before it
    and to 0 after), the top-``moe_topk`` columns by repeated argmax (the
    lowest column wins a tie, as ``jnp.argmax``), renormalised over
    ``max(sum, 1e-30)`` when ``moe_norm``; writes the (batch, w)
    combine-weight tile and adds 1 per selected (row, expert) to row r of
    the int32 counters. The JAX body accumulates its counts in the fp32
    arena's ``moe_counts`` region (``cnt_off``); the port keeps them
    exact in ``st.counts`` on every device and leaves that region as it
    is."""
    rl_off, wout_off, e_n = args[:3]
    b, w = cfg.batch, cfg.w
    lg = _load(st, rl_off, b)
    real = torch.arange(w, device=lg.device)[None] < e_n
    p = torch.softmax(lg.masked_fill(~real, float("-inf")), dim=-1)
    p = torch.where(real, p, torch.zeros_like(p))
    mask = torch.zeros(b, w, dtype=torch.bool, device=lg.device)
    work = p.clone()
    for _ in range(cfg.moe_topk):
        pick = torch.zeros_like(mask)
        pick.scatter_(1, torch.argmax(work, dim=-1, keepdim=True), True)
        mask |= pick
        work = work.masked_fill(pick, float("-inf"))
    wbe = torch.where(mask, p, torch.zeros_like(p))
    if cfg.moe_norm:
        wbe = wbe / torch.clamp(wbe.sum(dim=-1, keepdim=True), min=1e-30)
    _store(st, wout_off, wbe)
    st.counts[:b] += mask.to(st.counts.dtype)


def weighted_add_body(cfg: KernelConfig, args, st: StepState) -> None:
    """The per-expert combine: ``acc = part * wbe[:, e]`` when ``init``,
    else ``acc += part * wbe[:, e]``, over ``tiles`` (batch, w) tiles,
    in fp32."""
    acc_off, part_off, wbe_off, e_idx, tiles, init = args[:6]
    b, w = cfg.batch, cfg.w
    wcol = _load(st, wbe_off, b)[:, e_idx].view(1, b, 1)
    term = _load(st, part_off, tiles * b).view(tiles, b, w) * wcol
    if not init:
        term = _load(st, acc_off, tiles * b).view(tiles, b, w) + term
    _store(st, acc_off, term.view(-1, w))


def _not_ported(item: str):
    def body(cfg, args, st):
        raise NotImplementedError(
            f"this megakernel task set is not ported yet: {item} "
            "(ROADMAP.md, queue A)")
    return body


def _noop(cfg, args, st) -> None:
    return None


# Task type -> plain body; the CUDA kernel implements the same set.
BODIES = {
    TaskType.RMSNORM: rmsnorm_body,
    TaskType.LINEAR: linear_body,
    TaskType.ADD: add_body,
    TaskType.SILU_MUL: silu_mul_body,
    TaskType.ATTN_DECODE: attn_decode_body,
    TaskType.WRITE_KV: write_kv_body,
    TaskType.ALLREDUCE: allreduce_body,
    TaskType.GATHER: gather_body,
    TaskType.NOOP: _noop,
    TaskType.WRITE_KV_PREFILL: write_kv_prefill_body,
    TaskType.ATTN_PREFILL: attn_prefill_body,
    TaskType.WRITE_KV_CHUNK: write_kv_chunk_body,
    TaskType.ATTN_CHUNK: attn_chunk_body,
    TaskType.MOE_WEIGHTS: moe_weights_body,
    TaskType.WEIGHTED_ADD: weighted_add_body,
    TaskType.GDN_DECODE: _not_ported("the hybrid GDN task set"),
    TaskType.ATTN_QBLOCK: attn_qblock_body,
    TaskType.WRITE_KV_QBLOCK: write_kv_qblock_body,
}
