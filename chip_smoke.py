#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``triton_dist_tpu_torch``) on one
NVIDIA H100 and check it.

Run from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):

1. Build the CUDA kernels from ``triton_dist_tpu_torch/csrc`` with nvcc
   and print what ``-Xptxas -v`` reports (registers, shared memory).
2. Kernel vs plain: each kernel on the card at the serving shapes of
   Qwen3-8B (bf16, 4 slots, 32 query / 8 KV heads, head_dim 128, page 32,
   ragged lengths crossing page boundaries, a parked slot; chunks of 512
   and 128 queries, the two buckets, with and without padded rows), held
   against its plain PyTorch version on the same inputs. The outputs are
   bf16 and the plain version rounds probabilities to bf16 before P·V
   where the kernels keep them in fp32, so the limits are:
   decode |got - want| <= 5e-3 + 2**-7 |want| (one bf16 unit of last
   place, 2**-7 relative, on top of 5e-3, about 2.5x the error measured
   on the card) and, per slot, RMS error <= 1e-2 x the RMS of that slot's
   output (a dropped 32-key tile moves a 1025-key slot by about 0.3 of
   it); Q-block |got - want| <= 2e-2 + 2**-6 |want| (two units of last
   place: a query near the chunk start averages few V rows, so its
   outputs reach [2, 4), where one unit is 1.6e-2).
   Each is timed with CUDA events, L2 flushed between launches.
3. Serve: full-width 36-layer Qwen3-8B with random weights from seed 0,
   4 slots, page 32, prefill buckets (128, 512), four prompts of 1000,
   700, 300 and 60 tokens, 64 greedy tokens each. The kernel launch
   counts are set to zero just before and read just after: every layer
   of every decode step and prefill chunk must have gone through them.
   Then torch.profiler splits the device time of a prefill tick and of
   five decode ticks by kernel family, on a fresh server.
4. End to end: the same geometry cut to 2 layers; the first two tokens'
   logits of the served path (Q-block kernel for the first, decode kernel
   for the second) against a plain forward of the same weights (dense
   causal attention over unpaged K/V, whole prompt at once), within an
   absolute 0.1 (the logits have a standard deviation of about 1.3; bf16
   activations round at different points in the two paths).
5. Megakernel vs plain: one step of the megakernel at Qwen3-8B widths cut
   to 2 layers, batch 4, t_tile = page = 128, a shuffled block table and
   per-row lengths 0 (parked, table row 0), 1025, 700 and 130, against
   its plain interpreter on copies of the same arena and pools. Both
   round every task's output to bf16 but sum in different orders, so a
   value may land one bf16 unit of last place (2**-7 relative at most)
   away, and each later norm and projection carries such flips on: over
   the two layers' 30 task boundaries they add up like a random walk (the
   phase prints the largest difference of every activation region: one
   or two units at each, and 0.047 at most on the logits, whose standard
   deviation is 1.28, on an H100 80GB HBM3 at 700 W). So: logits within 0.1 + 2**-6 |want|
   (two units of the logit on top of twice that drift) and each row's
   RMS error within 2e-2 of its logits' RMS (the drift reads 0.3-0.7 %);
   written K/V rows within 3e-2 + 2**-6 |want| (two units at |K| < 4);
   every other pool row unchanged bit for bit. Controls: the kernel is
   run again with one fault planted in its inputs (a page of another
   row, a length one off, layer 0's KV heads 0 and 1 swapped) and must
   fail those limits against the sound plain logits. On the same card
   they read max |dlogit| 2.0-6.5 and 38-104 % RMS error on the faulted
   rows, so both limits sit between the sound run and the faults.
6. Serve on the megakernel lane: full-width 36-layer Qwen3-8B, random
   weights from seed 0, 4 slots, page 128; four prompts of 300, 200, 100
   and 60 tokens streamed one token per tick through the prefill lane,
   then 64 greedy tokens each. Every tick must be one megakernel launch
   and the layer lane's kernels must not launch. Then torch.profiler over
   five decode ticks, and the step's time at lengths 0/1025/700/130
   against its bound and its plain interpreter.
7. Megakernel end to end: the lane at 2 layers and full width; the
   logits of the first two generated tokens against the plain forward of
   phase 4, within an absolute 0.15: the layer lane's 0.1, plus the
   megakernel's logits, which it stores in the bf16 arena (half a unit
   of last place, up to 0.016 at |logit| < 8), and its bf16 rounding of
   every norm and residual output.
8. Megakernel prompt modes vs plain, at Qwen3-8B widths cut to 2 layers,
   page 128, a shuffled block table over random history: a 512-row chunk
   from position 0 with 300 valid rows (212 dead), a 128-row chunk at
   position 640 with positions below 700 attend-only, and a batched
   prefill of 4 slots x 32 rows at start 0 and at 128, driven through
   ``MegaKernelEngine.prefill``. Phase 5's limits (logits 0.1 + 2**-6
   |want| on every row, row RMS 2 %, written K/V 3e-2 + 2**-6 |want|),
   exactly the rows the mode writes written, every other pool row
   unchanged bit for bit; and the 128-row chunk run on a table row holding
   a page of another slot, or on codes shifted by one position, must fail
   those limits.
9. Serve on the chunked megakernel lane: full-width 36-layer Qwen3-8B,
   random weights from seed 0, 4 slots, page 128, buckets (128, 512); the
   layer lane's four prompts (1000/700/300/60 tokens) and 64 greedy tokens
   each. Megakernel launches must be the 12 chunk launches plus the decode
   ticks, and the layer lane's kernels must not launch. Then the chunk
   launch at 512 rows from position 0 and at 128 rows from 512, and a
   batched prefill of 4 x 32 rows, each timed against its bound and its
   plain interpreter, with per-task times from the card's global timer
   (the longest ATTN_CHUNK task must stay under the 5 s wait bound).
10. The chunked lane end to end: phase 7 with buckets (128, 512); the
   first token's logits come from the last chunk's last valid row, within
   0.15 of the plain forward, as phase 7's.
11. MoE megakernel vs plain: Qwen3-30B-A3B widths (d 2048, 32/4 heads,
   128 experts, top-8, expert ffn 768) cut to 2 layers, page 128, a
   shuffled block table over random history: the decode step at lengths
   0/1025/700/130, a 128-row chunk at position 640 with positions below
   700 attend-only, and a 4 x 32 batched prefill (an engine of its own).
   The router logits land in the bf16 arena after a LINEAR that sums in
   another order than the plain interpreter, so a one-unit difference
   can swap a row's 8th and 9th expert: a routing flip, which moves that
   row by far more than phase 5's limits and is no fault if the two
   experts were all but tied. So every (row, layer) pair whose selected
   expert set differs from the free-running plain run's is printed with
   the plain run's gap between the experts only one run chose, in bf16
   units at its 8th-largest logit. A row's first flip must lie within 4
   units (twice the 2-unit layer-0 router-logit drift the sound runs
   read), and fails otherwise; a later layer's flip in that row follows
   from the first, whose other expert's output feeds it, and is printed.
   Every row is held to phase 5's limits against a plain run that routes
   as the kernel did (it takes the kernel's router-logit tiles).
   MOE_WEIGHTS also runs alone, kernel and plain, on the identical
   logit tile: the same experts, weights within one bf16 unit, equal
   counters. The expert counters must sum to rows x layers x 8, per
   expert equal to the experts each run routed to; layer 0's router
   logits (upstream of any routing) within phase 5's K/V limit.
   Two planted faults in the decode step must fail those limits: layer
   1's two most-routed experts' w_down regions swapped, and every
   WEIGHTED_ADD reading the combine tile one column over.
12. Serve on the MoE megakernel lane: full-width, full-depth (48 layers)
   Qwen3-30B-A3B, random weights from seed 0 drawn and packed one layer
   at a time, 4 slots, page 128, bucket 128 (the arena of a 512-row
   chunk build would not fit beside the weights; PERF.md); the prompts
   1000/700/300/60 tokens, 64 greedy tokens each. Megakernel launches
   must be the 18 chunk launches plus the decode ticks, the paged
   kernels must not launch, and the expert counters must grow by exactly
   (4 x decode ticks + 128 x chunk launches) x 48 x 8. Then the decode
   step at 0/1025/700/130 and the 128-row chunk from 0, each against its
   bound and its plain interpreter (in place: activations are scratch),
   with per-task times by type.
13. Serve the MoE layer lane: the megakernel engine freed (allocated
   memory must drop below a tenth), the same model and prompts through
   ``Engine(cfg).serving(num_slots=4, page=32, prefill_buckets=(128,
   512))``; the paged decode kernel must launch 48 times per decode tick
   and the Q-block kernel 48 times per chunk.
14. MoE end to end at 2 layers: each prompt (700 and 60 tokens) served
   alone on both lanes; the first two tokens' logits against a plain
   forward of qwen_moe (whole prompt, dense K/V) within phase 7's 0.15
   wherever the served row routed like the plain forward in both layers,
   every routing flip judged by phase 11's near-tie rule against the
   plain forward's fp32 router logits.

15. Prefill kernels vs plain, at the shapes the dense-cache engine gives
   them (bf16): the flash-attention kernel (``csrc/flash_attention.cu``)
   at S 512 and 1000, GQA 4 and 8, head_dim 128 and 8, within the
   Q-block limit 2e-2 + 2**-6 |want| (its plain version rounds normalised
   probabilities to bf16 before P·V, the kernel unnormalised ones); the
   row-tile grouped GEMM (``csrc/group_gemm.cu``) at Qwen3-30B-A3B widths
   on a real routing of 60, 700 and 2048 tokens (row tiles 8, 32, 128),
   gate/up as one launch over both weights and down, within one bf16
   unit of last place, 1e-3 + 2**-7 |want| (both sum in fp32 and round
   once). Controls: a key tile of another KV head planted in K, and a
   tile->expert map shifted by one, must fail those limits. Times at the
   Engine.serve prefill shapes against the bound, the plain version and
   one library call (causal SDPA with enable_gqa; ``torch._grouped_mm``
   over the same segments where this torch has it).
16. The dense-cache engine at full depth, on phase 3's Qwen3-8B weights
   and on phase 13's Qwen3-30B-A3B weights (one copy of each):
   ``Engine(cfg, mode="fused", max_len=2048).serve`` of a (4, 512) batch
   for 64 tokens, then monolithic serving (``serving(num_slots=4,
   page=32)``, no buckets) of the 1000/700/300/60-token prompts for 64
   tokens each. Counts set to zero just before each run: every prefill
   layer launched ``flash_attention`` once and, for MoE,
   ``group_gemm_tiles`` twice; monolithic decode ticks the paged decode
   kernel once per layer. Prefill and decode-step times, and a
   torch.profiler split of one prefill and one decode step.
17. The same at 2 layers against the plain forward: monolithic serving's
   first two tokens and ``Engine.prefill`` of a (2, 512) batch within
   phase 4's 0.1 (dense, in phase 4); the MoE monolithic lane beside the
   two lanes of phase 14, under its routing-flip rule and 0.15.
18. The committed HF fixtures (``tests/fixtures/qwen3_tiny``,
   ``qwen3_moe_tiny``) through ``load_hf_checkpoint`` onto the card in
   bf16: ``Engine(mode="fused").serve`` with every layer's kernel
   launches counted and prefill logits within phase 4's 0.1 of the plain
   forward (not the paged server: the paged kernels take head_dim 128
   only, the fixtures have 8).
19. Rows 15 and 16 on quantized pools (int8 and fp8) against their plain
   versions at phase 2's shapes: pools and per-page scales written by
   the plain writer (``PagedKVCache.write_prompt``) from seeded K/V; the
   decode kernel at 1/1025/736/333, the Q-block kernel on a 512-query
   chunk from 0 and on a verify block of K = 4 per slot at those lengths;
   phase 2's limits (both attend in fp32 and round the output to bf16
   once). Planted fault: the scale table of the next page id. Times
   against a bound of one byte an element plus the scales, q and out.
20. The megakernel's quantized write task alone (Qwen3-8B widths, 2
   layers, page 128) in decode rows (a parked row, one at a reused
   page's first offset, two mid-page), a 512-row chunk from 0, a 100-row
   chunk from 130 (ends mid-page) and a 4 x 4 verify block with masked
   rows, against the plain ``_quant_store_token`` sequence on the same
   seeded K/V rows and codes: int8 codes within one step, fp8 codes
   within two units of last place (a one-step tie flip carried into a
   lower binade by a rescale), scales within 1e-6 relative (the two runs
   quantize the same rows up to the ulps of two rope spellings). Planted
   fault: the plain run's table row shifted by one page. Its time alone.
21. Qwen3-8B at full depth (phase 3's weights, seed 0) on both lanes,
   four prompts (two repetitive) within one 128-row chunk, 32 tokens:
   bf16, int8, fp8 pools and bf16 with spec_k = 4 (n-gram 3). Counts
   set to zero around each run: every new form launched exactly as often
   as the layers x dispatches / chunks say, and nothing else. Spec
   tokens against the non-spec run of the same lane: a request's first
   divergence must sit where the non-spec top-2 logits are within 4 bf16
   units (verify runs the Q-block kernel or the tensor-core LINEAR where
   decode does not). Printed: tokens/s, acceptance, dispatches per token,
   pool bytes and capacity, greedy agreement and first-decode logit gap
   against bf16 pools beside the JAX CPU battery's 0.05 / 0.15. At 2
   layers: the quantized lanes' served logits (first two tokens) within
   0.1 (int8) and 0.15 (fp8) of the same serving through the plain
   versions (the layer lane's plain paged attention; the megakernel's
   plain interpreter), and every new megakernel form (int8/fp8 decode,
   chunk and verify, bf16 verify) against its plain interpreter from the
   same state within phase 5's limits, the dequantized pools within 0.1
   (int8) and 0.25 (fp8, 3.5 steps of its top binade) of each page's
   max-abs (the K rows differ by bf16 units, so the
   running scales grow at different tokens and codes round a different
   number of times: 5 int8 codes measured in a 128-row chunk; a misplaced
   row is off by the order of the max-abs). Full depth times of each
   form against its bound.
22. Qwen3-30B-A3B cut to 4 layers on both lanes with int8 pools and
   spec_k = 4, against the int8 run without spec under the near-tie
   rule; at 2 layers its chunk and verify launches against the plain
   interpreter, routing judged by phase 14's rule.
23. Qwen3-32B (the rider) at full width, 8 of 64 layers, on the layer
   lane with int8 pools: GQA 8 through the int8 forms of rows 15 and 16,
   launches counted, the first two served tokens' logits within 0.1 of
   the plain quantized run. (Every plain run of phases 21-23 is fed the
   kernel run's tokens, so both compute each step on the same inputs.)

The last lines of output: one JSON object with every kernel's numbers
(the megakernel once per row mode, and once per MoE row mode), the
card's name and power limit as
nvidia-smi gives them, then ``{"ok": true, "device": {...}}``.
"""

import contextlib
import copy
import ctypes
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

MEM_BPS = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
TOL_DECODE = (5e-3, 2.0 ** -7)       # (absolute, relative to |want|)
TOL_DECODE_SLOT_RMS = 1e-2
TOL_QBLOCK = (2e-2, 2.0 ** -6)
TOL_LOGITS = 0.1
TOL_CKPT_LOGITS = 5e-3     # HF fixtures: logit std ~0.12, sound ~2e-3
TOL_MK_LOGITS = (1e-1, 2.0 ** -6)
TOL_MK_ROW_RMS = 2e-2
TOL_MK_KV = (3e-2, 2.0 ** -6)
TOL_MK_SERVED = 0.15
TOL_MOE_TIE = 4.0          # bf16 units: a routing flip's reference gap
MK_LENS = (0, 1025, 700, 130)      # row 0 parked on the scratch page


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int = 30) -> float:
    """Per-launch device time from CUDA events around ``reps`` launches,
    each after a 64 MB write that evicts the 50 MB L2 (36 layers of KV
    pools would), less the same run of writes alone."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()

    def run(with_fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            flush.zero_()
            if with_fn:
                fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    return (run(True) - run(False)) / reps


def bound(nbytes: float, flops: float):
    """Least time (ms) for the work, and which of the two limits it."""
    t_bytes, t_ops = nbytes / MEM_BPS, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(label, got, want, tol) -> float:
    """Fail unless ``got`` is finite and within ``tol = (atol, rtol)`` of
    ``want`` everywhere; returns the max absolute error."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= atol + rtol * want.float().abs()).all())
    print(f"[{label}] max_abs_err {err:.3e} "
          f"(tol {atol} + {rtol}|want|) ok={ok}")
    if not ok:
        fail(f"{label}: the kernel disagrees with its plain version")
    return err


def build_kernels():
    from triton_dist_tpu_torch.megakernel import builder as mkb
    from triton_dist_tpu_torch.utils import build

    t0 = time.perf_counter()
    cuda = ("paged_attention.cu", "megakernel.cu", "flash_attention.cu",
            "group_gemm.cu")
    logs = build.build_all([*cuda, "megakernel_scheduler.cc"])
    print(f"[build] nvcc x{len(cuda)} + g++ in parallel "
          f"{time.perf_counter() - t0:.1f} s -> {build.BUILD_DIR}")
    for source in cuda:
        for line in logs[source].splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line):
                print(f"[ptxas] {source}: {line.strip()}")
    mk_smem = build.load("megakernel.cu").tdt_megakernel_smem_bytes()
    print(f"[smem] megakernel_kernel {mk_smem} B/block (dynamic); "
          f"{mkb.grid_blocks(0)} blocks per decode launch, "
          f"{mkb.grid_blocks(0, tensor_cores=True)} per tensor-core launch "
          "(resident on every SM)")
    # Both kernels take their shared memory dynamically (ptxas does not
    # report it): rows = 4 query heads per KV head for decode, 32 (query,
    # head) rows for the Q-block kernel; bf16 pools, then int8/fp8 ones.
    smem = build.load("paged_attention.cu").tdt_paged_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_int
    print(f"[smem] paged_decode_kernel {smem(4, 0)} / {smem(4, 1)} B/block, "
          f"paged_qblock_kernel {smem(32, 0)} / {smem(32, 1)} B/block "
          "(dynamic; bf16 / int8-fp8 pools)")


def kernel_phase():
    """Kernel vs plain at the slice shapes; returns per-kernel numbers."""
    from triton_dist_tpu_torch.ops import paged_flash_decode as pfd
    from triton_dist_tpu_torch.ops import paged_flash_qblock as pfq
    from triton_dist_tpu_torch.ops.chunked_prefill import gather_pages_dense

    dev = torch.device("cuda", 0)
    S, H, KV, HD, PAGE, P_MAX = 4, 32, 8, 128, 32, 128
    num_pages = 1 + S * P_MAX
    g = torch.Generator(device=dev).manual_seed(1)
    bf = dict(device=dev, dtype=torch.bfloat16)
    kp = torch.randn(num_pages, KV, PAGE, HD, generator=g, **bf)
    vp = torch.randn(num_pages, KV, PAGE, HD, generator=g, **bf)
    perm = torch.randperm(num_pages - 1, generator=g, device=dev) + 1
    table = perm.view(S, P_MAX).to(torch.int32).contiguous()
    table[0] = 0                                     # parked slot
    out = {}

    # Decode: parked (clamped to 1), one past a page boundary, exactly on
    # one, and ragged.
    kv_len = torch.tensor([1, 1025, 736, 333], dtype=torch.int32, device=dev)
    q = torch.randn(S, H, HD, generator=g, **bf)
    got = pfd.paged_flash_decode(q, kp, vp, table, kv_len)
    want = pfd.paged_flash_decode_ref(q, kp, vp, table, kv_len)
    torch.cuda.synchronize()
    err = check_close("decode", got, want, TOL_DECODE)
    d = (got.float() - want.float()).flatten(1)
    rel = (d.pow(2).mean(1).sqrt()
           / want.float().flatten(1).pow(2).mean(1).sqrt())
    print(f"[decode] per-slot RMS error / RMS output "
          f"{[f'{r:.2e}' for r in rel.tolist()]} "
          f"(tol {TOL_DECODE_SLOT_RMS})")
    if not bool((rel <= TOL_DECODE_SLOT_RMS).all()):
        fail("decode: a slot's output strays from its plain version")
    n = kv_len.clamp(min=1).double()
    nbytes = (2 * q.numel() * 2 + n.sum().item() * KV * HD * 2 * 2
              + S * 4 + (n / PAGE).ceil().sum().item() * 4)
    flops = 4 * H * HD * n.sum().item()
    k_ms = time_ms(lambda: pfd.paged_flash_decode(q, kp, vp, table, kv_len))
    p_ms = time_ms(lambda: pfd.paged_flash_decode_ref(q, kp, vp, table,
                                                      kv_len))
    b_ms, b_by = bound(nbytes, flops)
    # Yardstick, NOT the same function: SDPA over already-dense K/V (no
    # page table), masked to the same lengths. The port never calls it.
    t_max = int(kv_len.max())
    kd = gather_pages_dense(kp, table)[:, :t_max].transpose(1, 2)
    vd = gather_pages_dense(vp, table)[:, :t_max].transpose(1, 2)
    mask = (torch.arange(t_max, device=dev)[None, None, None, :]
            < kv_len.clamp(min=1)[:, None, None, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    y_ms = time_ms(lambda: sdpa(q[:, :, None], kd, vd, attn_mask=mask,
                                enable_gqa=True))
    print(f"[decode] kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
          f"bound_ms {b_ms:.4f} ({b_by}) yardstick sdpa over dense K/V "
          f"(not the same function) {y_ms:.4f}")
    out["decode"] = dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by)

    # Q-block, both buckets of the serve phase: a full 512-query chunk at
    # the start of a prompt, one starting at 512 with 212 padded rows, and
    # 128-query chunks for a 60-token prompt and for the last 104 tokens
    # of a 1000-token one.
    row = table[1:2]
    errs = []
    for C, start, valid in ((512, 0, 512), (512, 512, 300), (128, 0, 60),
                            (128, 896, 104)):
        qc = torch.randn(1, C, H, HD, generator=g, **bf)
        pos = start + torch.arange(C, dtype=torch.int32, device=dev)
        pos = torch.where(torch.arange(C, device=dev) < valid, pos,
                          torch.full_like(pos, start + valid - 1))[None]
        got = pfq.paged_flash_qblock(qc, kp, vp, row, pos)
        want = pfq.paged_flash_qblock_ref(qc, kp, vp, row, pos)
        torch.cuda.synchronize()
        errs.append(check_close(f"qblock C {C} start {start} valid {valid}",
                                got, want, TOL_QBLOCK))
    C = 512
    qc = torch.randn(1, C, H, HD, generator=g, **bf)
    pos0 = torch.arange(C, dtype=torch.int32, device=dev)[None]
    keys = C
    nbytes = (2 * qc.numel() * 2 + keys * KV * HD * 2 * 2 + C * 4
              + math.ceil(keys / PAGE) * 4)
    flops = 4 * H * HD * (C * (C + 1) / 2)
    k_ms = time_ms(lambda: pfq.paged_flash_qblock(qc, kp, vp, row, pos0))
    p_ms = time_ms(lambda: pfq.paged_flash_qblock_ref(qc, kp, vp, row, pos0))
    b_ms, b_by = bound(nbytes, flops)
    kd = gather_pages_dense(kp, row)[:, :C].transpose(1, 2)
    vd = gather_pages_dense(vp, row)[:, :C].transpose(1, 2)
    y_ms = time_ms(lambda: sdpa(qc.transpose(1, 2), kd, vd, is_causal=True,
                                enable_gqa=True))
    print(f"[qblock] kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
          f"bound_ms {b_ms:.4f} ({b_by}) yardstick causal sdpa over dense "
          f"K/V (not the same function) {y_ms:.4f}")
    out["qblock"] = dict(err=max(errs), ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by)
    return out


def record_logits(srv, steps):
    """Wrap ``srv._pick`` to keep each request's logits rows of ``steps``."""
    seen = {}
    pick = srv._pick

    def recording_pick(row, req, step):
        if step in steps:
            seen[(req.request_id, step)] = np.array(row, np.float32)
        return pick(row, req, step)

    srv._pick = recording_pick
    return seen


def serve_phase():
    from triton_dist_tpu_torch import Engine, ModelConfig

    cfg = ModelConfig.qwen3_8b()
    serve_kw = dict(num_slots=4, page=32, prefill_buckets=(128, 512))
    t0 = time.perf_counter()
    eng = Engine(cfg, device="cuda", dtype=torch.bfloat16, max_len=4096,
                 seed=0)
    torch.cuda.synchronize()
    print(f"[serve] Qwen3-8B weights on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # Warm-up (cuBLAS handles, kernel modules) on a throwaway server.
    eng.serving(**serve_kw).generate([[7] * 130], max_new_tokens=2)
    torch.cuda.empty_cache()

    rng = np.random.RandomState(0)
    lens = (1000, 700, 300, 60)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in lens]
    srv = eng.serving(**serve_kw)
    first = record_logits(srv, {0})
    zero_counts()
    t0 = time.perf_counter()
    outs = srv.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    st = srv.stats()
    print(f"[serve] {st['completed']} requests in {wall:.2f} s; "
          f"decode dispatches {st['decode_dispatches']}, prefill chunks "
          f"{st['prefill_chunks']}, kernel launches {launches}")
    print(f"[serve] {torch.cuda.get_device_name(0)}: decode "
          f"{st['tokens_per_s']:.1f} tokens/s over "
          f"{st['decode_time_s']:.2f} s; prefill "
          f"{st['prefill_tokens_per_s']:.1f} tokens/s over "
          f"{st['prefill_time_s']:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if [len(o) for o in outs] != [64] * 4:
        fail(f"requests did not finish with 64 tokens: {[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        fail("token id out of range")
    if len(first) != 4 or not all(np.isfinite(v).all() and v.shape ==
                                  (cfg.vocab_size,) for v in first.values()):
        fail("first-token logits missing, misshapen or not finite")
    L = cfg.num_hidden_layers
    if (launches["decode"] != L * st["decode_dispatches"]
            or launches["qblock"] != L * st["prefill_chunks"]
            or launches["megakernel"] != 0
            or min(launches["decode"], launches["qblock"]) == 0):
        fail(f"main path bypassed a kernel: launches {launches}, "
             f"{L} layers x {st['decode_dispatches']} decode steps / "
             f"{st['prefill_chunks']} chunks")
    profile_serving(eng, prompts, serve_kw)
    del srv
    dense_engine = engine_phase("dense", cfg, eng.params)
    del eng
    torch.cuda.empty_cache()
    return launches, st, dense_engine


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by the kernels line's key."""
    from triton_dist_tpu_torch.megakernel import builder as mkb
    from triton_dist_tpu_torch.ops import flash_attention as fa
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import paged_flash_decode as pfd
    from triton_dist_tpu_torch.ops import paged_flash_qblock as pfq

    return {"decode": pfd.KERNEL, "qblock": pfq.KERNEL,
            "decode-int8": pfd.KERNELS[torch.int8],
            "decode-fp8": pfd.KERNELS[torch.float8_e4m3fn],
            "qblock-int8": pfq.KERNELS[torch.int8],
            "qblock-fp8": pfq.KERNELS[torch.float8_e4m3fn],
            "megakernel": mkb.KERNEL, "flash": fa.KERNEL,
            "group_gemm": gg.KERNEL}


def zero_counts() -> None:
    from triton_dist_tpu_torch.megakernel import builder as mkb

    for kernel in launch_counters().values():
        kernel.launches = 0
    for mode in mkb.MODE_LAUNCHES:
        mkb.MODE_LAUNCHES[mode] = 0


def read_counts() -> dict:
    """Launches by kernel, and the megakernel's by row mode
    (``mk_decode``, ``mk_prefill``, ``mk_chunk``)."""
    from triton_dist_tpu_torch.megakernel import builder as mkb

    out = {key: k.launches for key, k in launch_counters().items()}
    out.update({f"mk_{m}": n for m, n in mkb.MODE_LAUNCHES.items()})
    return out


def profile_serving(eng, prompts, serve_kw, ticks: int = 5):
    """Where the time goes, on a fresh server with the same four prompts:
    the first tick (four prefill chunks: 512, 512, 128 and 128 rows, and
    one decode), then ``ticks`` decode ticks once all four slots run."""
    srv = eng.serving(**serve_kw)
    for p in prompts:
        srv.submit(p, max_new_tokens=64)
    torch.cuda.synchronize()
    profile_window(srv.step, 1, "first tick (4 prefill chunks)")
    while any(h.status != "running" for h in srv.sched.running()) or \
            srv.sched.queue:
        srv.step()
    profile_window(srv.step, ticks, "decode ticks")


def profile_window(step, ticks: int, label: str) -> dict:
    """Trace ``ticks`` calls of ``step`` (a serving tick, a prefill) with
    torch.profiler and split device time by kernel family; idle share =
    1 - device busy time / host wall time of the window (the profiler
    slows the host, so it overstates the idle share of an unprofiled
    run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = {"megakernel": 0.0, "attention": 0.0, "group_gemm": 0.0,
           "gemm": 0.0, "other": 0.0}
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    for ev in kernels:
        t = ev.self_device_time_total / 1e3
        name = ev.key.lower()
        if "megakernel" in name:
            fam["megakernel"] += t
        elif "paged_" in name or "flash_attention" in name:
            fam["attention"] += t
        elif "group_gemm" in name:
            fam["group_gemm"] += t
        elif any(k in name for k in ("gemm", "gemv", "xmma", "nvjet",
                                     "cutlass", "splitk")):
            fam["gemm"] += t
        else:
            fam["other"] += t
    busy = sum(fam.values())
    print(f"[profile] {label}: {ticks} tick(s), "
          f"{sum(e.count for e in kernels) // ticks} launches/tick, wall "
          f"{wall_ms / ticks:.2f} ms/tick, device busy {busy / ticks:.2f} "
          f"ms/tick, idle share {1 - busy / wall_ms:.3f}; by family "
          "(ms/tick): "
          + ", ".join(f"{k} {v / ticks:.2f}" for k, v in fam.items()))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for ev in top[:6]:
        print(f"[profile]   {ev.self_device_time_total / 1e3 / ticks:8.3f} "
              f"ms/tick  x{ev.count // ticks:<4d} {ev.key[:90]}")
    return {"launches_per_tick": sum(e.count for e in kernels) / ticks,
            "wall_ms": wall_ms / ticks, "busy_ms": busy / ticks,
            "idle_share": 1 - busy / wall_ms,
            "megakernel_ms": fam["megakernel"] / ticks,
            "families": {k: v / ticks for k, v in fam.items()}}


def plain_last_logits(params, cfg, toks, ffn=None):
    """Plain forward of one sequence: dense causal attention over unpaged
    K/V (``chunk_attend``), whole sequence at once; fp32 logits of the
    last token. ``ffn(layer, h)`` replaces the dense MLP (the MoE
    block)."""
    from triton_dist_tpu_torch.layers import tp_attn, tp_mlp
    from triton_dist_tpu_torch.layers.norm import rms_norm
    from triton_dist_tpu_torch.models.dense import lm_head_logits
    from triton_dist_tpu_torch.ops.chunked_prefill import chunk_attend

    dev = params.embed.device
    ids = torch.tensor(toks, device=dev)
    pos = torch.arange(len(toks), dtype=torch.int32, device=dev)
    x = params.embed[ids]
    for layer in params.layers:
        h = rms_norm(x, layer.ln_attn, cfg.rms_norm_eps)
        q, k, v = tp_attn.decode_project(layer.attn, h, cfg, pos)
        o = chunk_attend(q[:, 0], k[:, 0], v[:, 0], pos)
        x = x + tp_attn.decode_output(layer.attn, o.reshape(len(toks), -1))
        h = rms_norm(x, layer.ln_mlp, cfg.rms_norm_eps)
        x = x + (tp_mlp.fwd(layer.mlp, h) if ffn is None else ffn(layer, h))
    x = rms_norm(x[-1:], params.ln_f, cfg.rms_norm_eps)
    return lm_head_logits(x, params.lm_head)[0]


def parity_phase():
    """Phases 4 and 17 (dense): the first two served tokens' logits of the
    chunked layer lane and of monolithic serving (``Engine(mode="fused")``,
    no buckets), and ``Engine.prefill``'s last-position logits of a
    (2, 512) batch, against the plain forward, within TOL_LOGITS."""
    from triton_dist_tpu_torch import Engine, ModelConfig

    cfg = dataclasses.replace(ModelConfig.qwen3_8b(), num_hidden_layers=2)
    eng = Engine(cfg, device="cuda", dtype=torch.bfloat16, max_len=4096,
                 seed=1)
    fused = Engine(cfg, mode="fused", params=eng.params, device="cuda",
                   dtype=torch.bfloat16, max_len=4096)
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (700, 60)]
    worst = 0.0

    def check(label, served, seq):
        nonlocal worst
        plain = plain_last_logits(eng.params, cfg, seq).cpu().numpy()
        err = float(np.abs(served - plain).max())
        worst = max(worst, err)
        print(f"[parity] {label}: max |dlogit| {err:.4f} (tol {TOL_LOGITS}),"
              f" logit std {plain.std():.3f}, argmax served "
              f"{int(served.argmax())} plain {int(plain.argmax())}")
        if not (np.isfinite(served).all() and err <= TOL_LOGITS):
            fail(f"served logits disagree with the plain forward: {err}")

    for lane, srv in (("chunked", eng.serving(
            num_slots=4, page=32, prefill_buckets=(128, 512))),
                      ("monolithic", fused.serving(num_slots=4, page=32))):
        seen = record_logits(srv, {0, 1})
        handles = [srv.submit(p, max_new_tokens=2) for p in prompts]
        srv.run()
        for h, p in zip(handles, prompts):
            for step, seq in ((0, p), (1, p + h.tokens[:1])):
                check(f"{lane} prompt {len(p)} step {step}",
                      seen[(h.request.request_id, step)], seq)
    ids = rng.randint(0, cfg.vocab_size, (2, 512))
    logits, _ = fused.prefill(ids)
    for r in range(2):
        check(f"Engine.prefill (2, 512) row {r}", logits[r].cpu().numpy(),
              ids[r].tolist())
    del srv, eng, fused
    torch.cuda.empty_cache()
    return worst


def time_events(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time (ms) between CUDA events recorded just before and
    just after each call of ``fn`` (each call is a whole decode step,
    whose weights do not fit the 50 MB L2, so no flush is needed)."""
    for _ in range(warmup):
        fn()
    spans = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / reps


def mk_inputs(mb, num_pages, dev, seed):
    """Random bf16 pools (history for the rows to attend), a shuffled
    block table whose row 0 (the parked row) is all scratch page, random
    tokens, and the per-row lengths MK_LENS."""
    cfg = mb.cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.num_hidden_layers, num_pages, mb.page,
             cfg.num_key_value_heads, cfg.head_dim)
    kc = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    vc = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    rng = np.random.RandomState(seed)
    table = (rng.permutation(num_pages - 1)[:mb.batch * mb.p_max]
             + 1).astype(np.int32)
    table[:mb.p_max] = 0
    toks = rng.randint(0, cfg.vocab_size, mb.batch).astype(np.int32)
    return kc, vc, toks, np.array(MK_LENS, np.int32), table


def mk_kernel_phase():
    """The megakernel against its plain interpreter, one step at Qwen3-8B
    widths cut to 2 layers."""
    from triton_dist_tpu_torch import ModelConfig
    from triton_dist_tpu_torch.megakernel import builder as mkb
    from triton_dist_tpu_torch.models import dense

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(ModelConfig.qwen3_8b(), num_hidden_layers=2)
    mb = mkb.ModelBuilder(cfg, batch=4, max_len=2048, t_tile=128,
                          paged=True, page=128)
    params = dense.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(2),
        device=dev, dtype=torch.bfloat16)
    arena = mb.pack_arena(params, dtype=torch.bfloat16, device=dev)
    del params
    kc, vc, toks, lens, table = mk_inputs(mb, 1 + 4 * mb.p_max, dev, 3)
    k0, v0 = kc.clone(), vc.clone()
    a2, k2, v2 = arena.clone(), kc.clone(), vc.clone()
    got = mb.step(arena, kc, vc, toks, lens, table)
    want = mb.plain_step(a2, k2, v2, toks, lens, table)
    torch.cuda.synchronize()
    print(f"[mk-kernel] {len(mb.graph.tasks)} tasks at 2 layers, lengths "
          f"{list(MK_LENS)}, logit std {want.std().item():.3f}")
    # Where the two drift apart: every activation region, in task order.
    drift = []
    for r in mb.schema.regions():
        if r.kind == "activation":
            d = (arena[r.offset:r.offset + r.rows].float()
                 - a2[r.offset:r.offset + r.rows].float()).abs().max()
            drift.append(f"{r.name} {d.item():.3g}")
    print("[mk-kernel] max |kernel - plain| by activation: "
          + ", ".join(drift))
    err = check_close("mk-kernel logits", got, want, TOL_MK_LOGITS)
    rel = row_rms(got, want)
    print(f"[mk-kernel] per-row RMS error / RMS logits "
          f"{[f'{r:.2e}' for r in rel.tolist()]} (tol {TOL_MK_ROW_RMS})")
    if not bool((rel <= TOL_MK_ROW_RMS).all()):
        fail("megakernel: a row's logits stray from the plain version")
    written = (k2 != k0) | (v2 != v0)
    errs = [check_close(f"mk-kernel {name} rows", got_p[written],
                        want_p[written], TOL_MK_KV)
            for name, got_p, want_p in (("K", kc, k2), ("V", vc, v2))]
    rows = int(written.any(-1).sum())
    if not (torch.equal(kc[~written], k0[~written])
            and torch.equal(vc[~written], v0[~written])
            and rows <= 2 * 4 * cfg.num_key_value_heads):
        fail(f"megakernel wrote pool rows the plain version did not ({rows})")
    del a2, kc, vc, k2, v2
    mk_fault_controls(mb, arena, k0, v0, toks, lens, table, want)
    del arena, k0, v0
    torch.cuda.empty_cache()
    return dict(err=max([err] + errs))


def row_rms(got, want):
    """Each row's RMS error over the RMS of its plain logits."""
    return ((got - want).pow(2).mean(1).sqrt()
            / want.pow(2).mean(1).sqrt())


def mk_fault_controls(mb, arena, k0, v0, toks, lens, table, want):
    """The limits above must catch a wrong page, position or head: the
    kernel runs on inputs with one such fault planted, and its logits are
    held against the plain version's on the sound inputs (``want``).
    Fails if a fault passes both the logit and the row-RMS limit."""
    b, p_max = mb.batch, mb.p_max
    bad_table = table.reshape(b, p_max).copy()
    bad_table[1, 2] = bad_table[2, 2]     # row 1 reads one of row 2's pages
    bad_lens = lens.copy()
    bad_lens[3] += 1                      # row 3 one position off
    swap = [1, 0] + list(range(2, mb.kv_loc))
    faults = (
        ("page", k0, v0, lens, bad_table.reshape(-1)),
        ("position", k0, v0, bad_lens, table),
        # Layer 0's KV heads 0 and 1 trade places: a wrong GQA head.
        ("head", torch.cat([k0[:1, :, :, swap], k0[1:]]),
         torch.cat([v0[:1, :, :, swap], v0[1:]]), lens, table))
    for name, kc, vc, lens_f, table_f in faults:
        got = mb.step(arena, kc.clone(), vc.clone(), toks, lens_f, table_f)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = diff.max().item()
        atol, rtol = TOL_MK_LOGITS
        logits_ok = bool((diff <= atol + rtol * want.abs()).all())
        rel = row_rms(got, want)
        rows_ok = bool((rel <= TOL_MK_ROW_RMS).all())
        print(f"[mk-control] {name} fault: max |dlogit| {err:.3e} (limit "
              f"{atol} + {rtol}|want|: {'passes' if logits_ok else 'caught'})"
              f", per-row RMS error / RMS logits "
              f"{[f'{r:.2e}' for r in rel.tolist()]} (limit {TOL_MK_ROW_RMS}"
              f": {'passes' if rows_ok else 'caught'})")
        if logits_ok and rows_ok:
            fail(f"megakernel limits do not catch a planted {name} fault")


def mk_step_bound(mb, lens):
    """Least time of one launch of ``mb`` at per-row ``lens`` (decode
    lengths, a prefill's base, or a chunk's codes): the weight rows (the
    embedding only for the launch's rows), each slot's attended K/V rows
    once, the K/V rows written, and the bf16 logits, over 3.35 TB/s; the
    projections' and attention's operations over 989 TFLOP/s."""
    return bound(*mk_step_work(mb, lens))


def mk_step_work(mb, lens):
    """(bytes, operations) of ``mk_step_bound``."""
    cfg, b = mb.cfg, mb.batch
    lens = np.asarray(lens, np.int64)
    pos = mb._row_positions(lens)
    writes = ((lens >= 0) if mb.mode in ("chunk", "qblock")
              else np.ones(b, bool))
    slots = {"decode": np.arange(b), "prefill": np.arange(b) // mb.seq,
             "qblock": np.arange(b) // mb.seq,
             "chunk": np.zeros(b, np.int64)}[mb.mode]
    keys = [int(pos[slots == s].max()) + 1 for s in np.unique(slots)]
    weight_rows = sum(r.rows for r in mb.schema.regions("weight")
                      if r.name != "embed")
    kv_row = cfg.num_hidden_layers * cfg.num_key_value_heads * cfg.head_dim
    # A quantized pool: one byte an element, and the fp32 K and V scales
    # of every attended page.
    elem = 1 if mb.kv_quant else 2
    scales = (sum(-(-k // mb.page) for k in keys) * cfg.num_hidden_layers
              * cfg.num_key_value_heads * 4 * 2 if mb.kv_quant else 0)
    nbytes = (weight_rows * mb.w * 2 + b * cfg.hidden_size * 2
              + (sum(keys) + int(writes.sum())) * kv_row * elem * 2 + scales
              + b * mb.vloc_tiles * mb.w * 2)
    flops = (2 * b * weight_rows * mb.w
             + 4 * int((pos + 1).sum()) * cfg.num_attention_heads
             * cfg.head_dim * cfg.num_hidden_layers)
    return nbytes, flops


def mk_serve_phase(layer_st):
    """Serve Qwen3-8B at full depth on the megakernel lane."""
    from triton_dist_tpu_torch import ModelConfig, ServingEngine
    from triton_dist_tpu_torch.megakernel import MegaKernelEngine

    cfg = ModelConfig.qwen3_8b()
    t0 = time.perf_counter()
    eng = MegaKernelEngine(cfg, batch=4, max_len=2048, t_tile=128,
                           paged=True, page=128, num_pages=1 + 4 * 16,
                           device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    mb = eng.builder
    print(f"[mk-serve] Qwen3-8B megakernel engine in "
          f"{time.perf_counter() - t0:.1f} s: {len(mb.graph.tasks)} tasks, "
          f"{len(mb.preds)} pruned edges, arena {mb.arena_rows} x {mb.w} "
          f"bf16, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ServingEngine(eng).generate([[7] * 3], max_new_tokens=2)   # warm-up

    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (300, 200, 100, 60)]
    srv = ServingEngine(eng)
    zero_counts()
    t0 = time.perf_counter()
    outs = srv.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    st = srv.stats()
    print(f"[mk-serve] {st['completed']} requests in {wall:.2f} s; "
          f"decode dispatches {st['decode_dispatches']}, kernel launches "
          f"{launches}")
    print(f"[mk-serve] {torch.cuda.get_device_name(0)}: "
          f"{st['tokens_per_s']:.1f} tokens/s (stats(): emitted tokens over "
          f"dispatch time, {st['decode_time_s']:.2f} s for "
          f"{st['decode_dispatches']} ticks, "
          f"{1e3 * st['decode_time_s'] / st['decode_dispatches']:.2f} ms per "
          f"tick with the prompts' lane ticks); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[mk-serve] yardstick, NOT the same function: the layer lane's "
          f"decode tick took "
          f"{1e3 * layer_st['decode_time_s'] / layer_st['decode_dispatches']:.2f}"
          f" ms on average in this call (36 layers x ~100 launches)")
    if [len(o) for o in outs] != [64] * 4:
        fail(f"requests did not finish with 64 tokens: {[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        fail("token id out of range")
    if (launches["megakernel"] != st["decode_dispatches"]
            or launches["megakernel"] == 0
            or launches["decode"] != 0 or launches["qblock"] != 0):
        fail(f"megakernel lane bypassed its kernel: launches {launches}, "
             f"{st['decode_dispatches']} decode dispatches")

    # Five decode ticks with all four slots running, on a fresh server.
    srv = ServingEngine(eng)
    for p in prompts:
        srv.submit(p, max_new_tokens=64)
    while any(h.status != "running" for h in srv.sched.running()) or \
            srv.sched.queue:
        srv.step()
    prof = profile_window(srv.step, 5, "megakernel decode ticks")

    dev = torch.device("cuda", 0)
    _, _, toks, lens, table = mk_inputs(mb, eng.num_pages, dev, 4)
    host = mb._host_inputs(eng.k_cache, toks, lens, table)
    k_ms = time_events(lambda: mb.launch(eng.arena, eng.k_cache, eng.v_cache,
                                         *host), reps=10)
    p_ms = time_events(lambda: mb.plain_step(eng.arena, eng.k_cache,
                                             eng.v_cache, toks, lens, table),
                       reps=2)
    b_ms, b_by = mk_step_bound(mb, lens)
    print(f"[mk-step] full-depth step at lengths {list(MK_LENS)}: kernel_ms "
          f"{k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); "
          f"{mb.batch} rows x {len(mb.claim_list)} claims per launch")
    # The same step with (almost) nothing to attend: what is not attention.
    short = np.array([0, 1, 2, 3], np.int32)
    host = mb._host_inputs(eng.k_cache, toks, short, table)
    s_ms = time_events(lambda: mb.launch(eng.arena, eng.k_cache, eng.v_cache,
                                         *host), reps=10)
    print(f"[mk-step] full-depth step at lengths {short.tolist()}: kernel_ms "
          f"{s_ms:.4f} bound_ms {mk_step_bound(mb, short)[0]:.4f}; so "
          f"attention costs {(k_ms - s_ms) / (sum(MK_LENS) - 6):.4f} ms per "
          "attended key per step")
    del srv, eng
    torch.cuda.empty_cache()
    return dict(launches=launches, st=st, prof=prof, ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by)


def mk_parity_phase():
    """Served megakernel logits against the plain forward, 2 layers."""
    from triton_dist_tpu_torch import ModelConfig, ServingEngine
    from triton_dist_tpu_torch.megakernel import MegaKernelEngine

    cfg = dataclasses.replace(ModelConfig.qwen3_8b(), num_hidden_layers=2)
    eng = MegaKernelEngine(cfg, batch=4, max_len=1024, t_tile=128,
                           paged=True, page=128, num_pages=1 + 4 * 8,
                           device="cuda", dtype=torch.bfloat16, seed=1,
                           keep_params=True)
    srv = ServingEngine(eng)
    seen = record_logits(srv, {0, 1})
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (700, 60)]
    handles = [srv.submit(p, max_new_tokens=2) for p in prompts]
    srv.run()
    worst = 0.0
    for h, p in zip(handles, prompts):
        for step, seq in ((0, p), (1, p + h.tokens[:1])):
            served = seen[(h.request.request_id, step)]
            plain = plain_last_logits(eng.params, cfg, seq).cpu().numpy()
            err = float(np.abs(served - plain).max())
            worst = max(worst, err)
            print(f"[mk-parity] prompt {len(p)} step {step}: max |dlogit| "
                  f"{err:.4f} (tol {TOL_MK_SERVED}), logit std "
                  f"{plain.std():.3f}, argmax served {int(served.argmax())} "
                  f"plain {int(plain.argmax())}")
            if not (np.isfinite(served).all() and err <= TOL_MK_SERVED):
                fail(f"megakernel logits disagree with the plain forward: "
                     f"{err}")
    del srv, eng
    torch.cuda.empty_cache()
    return worst


def mk_pools(eng, seed):
    """Random bf16 history in an engine's pools and a shuffled block table
    over pages 1.. (page 0 stays the scratch page)."""
    g = torch.Generator(device=eng.device).manual_seed(seed)
    eng.k_cache.copy_(torch.randn(eng.k_cache.shape, generator=g,
                                  device=eng.device, dtype=eng.dtype))
    eng.v_cache.copy_(torch.randn(eng.v_cache.shape, generator=g,
                                  device=eng.device, dtype=eng.dtype))
    n = eng.batch * eng.builder.p_max
    eng.block_table = (np.random.RandomState(seed).permutation(
        eng.num_pages - 1)[:n] + 1).astype(np.int32)
    return eng.block_table.reshape(eng.batch, -1)


def check_mode(label, got, want, pools, plain_pools, before, expect):
    """Phase 5's limits for one launch of a prompt mode: logits on every
    row, written K/V rows; ``expect`` is the (layers, pages, page) mask of
    the rows the mode writes, which must be exactly the rows written, all
    other pool rows unchanged bit for bit. Returns the max error."""
    err = check_close(f"{label} logits", got, want, TOL_MK_LOGITS)
    rel = row_rms(got, want)
    print(f"[{label}] rows {got.shape[0]}, logit std {want.std().item():.3f}, "
          f"worst row RMS error / RMS {rel.max().item():.2e} "
          f"(tol {TOL_MK_ROW_RMS})")
    if not bool((rel <= TOL_MK_ROW_RMS).all()):
        fail(f"{label}: a row's logits stray from the plain version")
    written = torch.zeros_like(expect)
    for name, kc, k2, k0 in zip("KV", pools, plain_pools, before):
        err = max(err, check_close(f"{label} {name} rows",
                                   kc[expect], k2[expect], TOL_MK_KV))
        written |= (k2 != k0).any(-1).any(-1)
        if not torch.equal(kc[~expect], k0[~expect]):
            fail(f"{label}: the kernel wrote {name} pool rows it must not")
    if not torch.equal(written, expect):
        fail(f"{label}: the plain version wrote {int(written.sum())} pool "
             f"rows, not the {int(expect.sum())} the mode writes")
    return err


def chunk_case(eng, c, start, valid, wfrom, table_row, seed):
    """Tokens and codes of one chunk, and the (layers, pages, page) mask
    of the pool rows it writes."""
    from triton_dist_tpu_torch.ops.chunked_prefill import chunk_row_codes

    rng = np.random.RandomState(seed)
    toks = np.zeros(c, np.int32)
    toks[:valid] = rng.randint(0, eng.cfg.vocab_size, valid)
    codes = chunk_row_codes(start, c, valid, wfrom)
    expect = torch.zeros(eng.k_cache.shape[:3], dtype=torch.bool,
                         device=eng.device)
    page = eng.builder.page
    for p in codes[codes >= 0]:
        expect[:, int(table_row[p // page]), int(p % page)] = True
    return toks, codes, expect


def mk_prompt_kernel_phase():
    """Phase 8: the chunk and batched-prefill modes against their plain
    interpreter at Qwen3-8B widths, 2 layers."""
    from triton_dist_tpu_torch import ModelConfig
    from triton_dist_tpu_torch.megakernel import MegaKernelEngine
    from triton_dist_tpu_torch.models import dense

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(ModelConfig.qwen3_8b(), num_hidden_layers=2)
    params = dense.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(5),
        device=dev, dtype=torch.bfloat16)
    kw = dict(batch=4, max_len=2048, t_tile=128, paged=True, page=128,
              num_pages=1 + 4 * 16, device=dev, dtype=torch.bfloat16,
              params=params)
    eng = MegaKernelEngine(cfg, prefill_buckets=(128, 512), **kw)
    table = mk_pools(eng, 6)
    out = {"chunk": 0.0}
    # (bucket, start, valid, wfrom, slot): the first chunk of a prompt with
    # 212 dead rows; a chunk past a 700-token resident prefix.
    for c, start, valid, wfrom, slot in ((512, 0, 300, 0, 1),
                                         (128, 640, 128, 700, 2)):
        mb = eng.chunk_builders[c]
        toks, codes, expect = chunk_case(eng, c, start, valid, wfrom,
                                         table[slot], 7 + c)
        label = f"mk-chunk C {c} start {start} valid {valid} wfrom {wfrom}"
        before = eng.k_cache.clone(), eng.v_cache.clone()
        a2, k2, v2 = eng.arena.clone(), *[t.clone() for t in before]
        task_ns = torch.zeros(len(mb.graph.tasks), 2, dtype=torch.int64,
                              device=dev)
        host = mb._host_inputs(eng.k_cache, toks, codes, table[slot])
        mb.launch(eng.arena, eng.k_cache, eng.v_cache, *host,
                  task_ns=task_ns)
        mb.wait(dev)
        got = mb.logits(eng.arena)
        want = mb.plain_step(a2, k2, v2, toks, codes, table[slot])
        out["chunk"] = max(out["chunk"], check_mode(
            label, got, want, (eng.k_cache, eng.v_cache), (k2, v2), before,
            expect))
        attn = mb.task_ms(task_ns)["ATTN_CHUNK"]
        print(f"[{label}] ATTN_CHUNK tasks {attn[0]:.2f} ms in all, longest "
              f"{attn[1]:.2f} ms")
        del a2, k2, v2, got
        # Restore the history for the next case and the controls.
        eng.k_cache.copy_(before[0])
        eng.v_cache.copy_(before[1])
    mk_chunk_fault_controls(eng, table)
    del eng
    torch.cuda.empty_cache()

    eng = MegaKernelEngine(cfg, prefill_seq=32, **kw)
    mk_pools(eng, 8)
    pb = eng.prefill_builder
    rng = np.random.RandomState(9)
    out["prefill"], launches = 0.0, 0
    for start in (0, 128):
        prompt = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int32)
        lens = np.full(4 * 32, start, np.int32)
        before = eng.k_cache.clone(), eng.v_cache.clone()
        a2, k2, v2 = eng.arena.clone(), *[t.clone() for t in before]
        zero_counts()
        last = eng.prefill(prompt, start_pos=start)
        torch.cuda.synchronize()
        launches += read_counts()["mk_prefill"]
        got = pb.logits(eng.arena)
        want = pb.plain_step(a2, k2, v2, prompt.reshape(-1), lens,
                             eng.block_table)
        if not torch.equal(last, got[31::32]):
            fail("MegaKernelEngine.prefill returned other rows than each "
                 "slot's last")
        table = eng.block_table.reshape(4, -1)
        expect = torch.zeros(eng.k_cache.shape[:3], dtype=torch.bool,
                             device=dev)
        for sl in range(4):
            for p in range(start, start + 32):
                expect[:, int(table[sl][p // 128]), p % 128] = True
        out["prefill"] = max(out["prefill"], check_mode(
            f"mk-prefill 4 x 32 from {start}", got, want,
            (eng.k_cache, eng.v_cache), (k2, v2), before, expect))
        del a2, k2, v2
    out["prefill_launches"] = launches
    del eng, params
    torch.cuda.empty_cache()
    return out


def mk_chunk_fault_controls(eng, table):
    """The limits above must catch a wrong page or wrong positions in a
    chunk: the 128-row chunk at 640 runs with a page of another slot in
    its table row (the page of positions 256-383, which every row
    attends), then with every code shifted by one position, each held
    against the plain version on the sound inputs."""
    mb = eng.chunk_builders[128]
    toks, codes, _ = chunk_case(eng, 128, 640, 128, 700, table[2], 7 + 128)
    k0, v0 = eng.k_cache.clone(), eng.v_cache.clone()
    want = mb.plain_step(eng.arena.clone(), k0.clone(), v0.clone(), toks,
                         codes, table[2])
    bad_row = table[2].copy()
    bad_row[2] = table[3][2]
    shifted = np.where(codes >= 0, codes + 1,
                       np.where(codes == -1, -1, codes - 1)).astype(np.int32)
    for name, row, cds in (("page", bad_row, codes),
                           ("codes", table[2], shifted)):
        got = mb.step(eng.arena, k0.clone(), v0.clone(), toks, cds, row)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        atol, rtol = TOL_MK_LOGITS
        logits_ok = bool((diff <= atol + rtol * want.abs()).all())
        rel = row_rms(got, want)
        rows_ok = bool((rel <= TOL_MK_ROW_RMS).all())
        print(f"[mk-chunk-control] {name} fault: max |dlogit| "
              f"{diff.max().item():.3e} ({'passes' if logits_ok else 'caught'}"
              f"), worst row RMS error / RMS {rel.max().item():.2e} "
              f"({'passes' if rows_ok else 'caught'})")
        if logits_ok and rows_ok:
            fail(f"megakernel chunk limits do not catch a planted {name} "
                 "fault")


def mk_chunk_serve_phase(layer_st):
    """Phase 9: Qwen3-8B at full depth on the chunked megakernel lane."""
    from triton_dist_tpu_torch import ModelConfig, ServingEngine
    from triton_dist_tpu_torch.megakernel import MegaKernelEngine, ModelBuilder
    from triton_dist_tpu_torch.megakernel.builder import DEFAULT_TIMEOUT_S

    cfg = ModelConfig.qwen3_8b()
    buckets = (128, 512)
    t0 = time.perf_counter()
    eng = MegaKernelEngine(cfg, batch=4, max_len=2048, t_tile=128,
                           paged=True, page=128, num_pages=1 + 4 * 16,
                           prefill_buckets=buckets, device="cuda",
                           dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    print(f"[mk-chunk-serve] engine with chunk builds {list(buckets)} in "
          f"{time.perf_counter() - t0:.1f} s: arena {eng.arena.shape[0]} x "
          f"{eng.arena.shape[1]} bf16 (decode build {eng.builder.arena_rows} "
          f"rows), {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ServingEngine(eng, prefill_buckets=buckets).generate(
        [[7] * 130], max_new_tokens=2)                     # warm-up

    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (1000, 700, 300, 60)]
    srv = ServingEngine(eng, prefill_buckets=buckets)
    zero_counts()
    t0 = time.perf_counter()
    outs = srv.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    st = srv.stats()
    print(f"[mk-chunk-serve] {st['completed']} requests in {wall:.2f} s; "
          f"{st['prefill_chunks']} chunks, {st['decode_dispatches']} decode "
          f"ticks, kernel launches {launches}")
    print(f"[mk-chunk-serve] {torch.cuda.get_device_name(0)}: prefill "
          f"{st['prefill_tokens_per_s']:.1f} tokens/s over "
          f"{st['prefill_time_s']:.2f} s (layer lane in this call: "
          f"{layer_st['prefill_tokens_per_s']:.1f} tokens/s over "
          f"{layer_st['prefill_time_s']:.2f} s); decode "
          f"{st['tokens_per_s']:.1f} tokens/s, "
          f"{1e3 * st['decode_time_s'] / st['decode_dispatches']:.2f} ms per "
          f"tick; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    brief = {k: v for k, v in st.items() if k not in ("plan", "pool")}
    print(f"[mk-chunk-serve] stats() {json.dumps(brief)}")
    if [len(o) for o in outs] != [64] * 4:
        fail(f"requests did not finish with 64 tokens: {[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        fail("token id out of range")
    if (st["prefill_chunks"] != 12
            or launches["mk_chunk"] != st["prefill_chunks"]
            or launches["mk_decode"] != st["decode_dispatches"]
            or launches["megakernel"] != launches["mk_chunk"]
            + launches["mk_decode"]
            or launches["decode"] != 0 or launches["qblock"] != 0):
        fail(f"chunked megakernel lane bypassed its kernel: launches "
             f"{launches}, {st['prefill_chunks']} chunks, "
             f"{st['decode_dispatches']} decode ticks")

    dev = torch.device("cuda", 0)
    table = mk_pools(eng, 10)
    timed = {}
    for c, start in ((512, 0), (128, 512)):
        mb = eng.chunk_builders[c]
        toks, codes, _ = chunk_case(eng, c, start, c, 0, table[1], 11)
        host = mb._host_inputs(eng.k_cache, toks, codes, table[1])
        task_ns = torch.zeros(len(mb.graph.tasks), 2, dtype=torch.int64,
                              device=dev)
        k_ms = time_events(lambda: mb.launch(eng.arena, eng.k_cache,
                                             eng.v_cache, *host,
                                             task_ns=task_ns), reps=3)
        per = mb.task_ms(task_ns)
        p_ms = time_events(lambda: mb.plain_step(
            eng.arena, eng.k_cache, eng.v_cache, toks, codes, table[1]),
            reps=1, warmup=0)
        b_ms, b_by = mk_step_bound(mb, codes)
        attn_sum, attn_max = per["ATTN_CHUNK"]
        lin = per["LINEAR"][0] / grid_blocks()
        print(f"[mk-chunk-step] {c} rows from {start}, "
              f"{cfg.num_hidden_layers} layers: kernel_ms "
              f"{k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); "
              f"ATTN_CHUNK {attn_sum:.2f} ms in all, longest task "
              f"{attn_max:.2f} ms (wait bound {DEFAULT_TIMEOUT_S:.0f} s); "
              f"LINEAR {lin:.2f} ms per block on {grid_blocks()} blocks")
        print("[mk-chunk-step]   task ms by type (sum, longest): " + ", ".join(
            f"{k} {v[0]:.2f}/{v[1]:.3f}" for k, v in sorted(
                per.items(), key=lambda kv: -kv[1][0])))
        if attn_max * 1e-3 >= DEFAULT_TIMEOUT_S:
            fail(f"an ATTN_CHUNK task took {attn_max:.0f} ms, past the "
                 "wait bound")
        timed[c] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                        attn_max_ms=attn_max)

    # The batched prefill at full depth: a 4 x 32 build on the same arena
    # (the same weight region, a smaller activation tail).
    pb = ModelBuilder(cfg, batch=4 * 32, seq=32, max_len=2048, t_tile=128,
                      paged=True, page=128)
    if ([(r.name, r.offset) for r in pb.schema.regions("weight")]
            != [(r.name, r.offset) for r in
                eng.builder.schema.regions("weight")]):
        fail("the batched-prefill build lays out another weight region")
    toks = np.random.RandomState(12).randint(0, cfg.vocab_size, 128)
    lens = np.zeros(128, np.int32)
    host = pb._host_inputs(eng.k_cache, toks, lens, eng.block_table)
    k_ms = time_events(lambda: pb.launch(eng.arena, eng.k_cache, eng.v_cache,
                                         *host), reps=3)
    p_ms = time_events(lambda: pb.plain_step(eng.arena, eng.k_cache,
                                             eng.v_cache, toks, lens,
                                             eng.block_table),
                       reps=1, warmup=0)
    b_ms, b_by = mk_step_bound(pb, lens)
    print(f"[mk-prefill-step] 4 x 32 rows from 0, {cfg.num_hidden_layers} "
          "layers: kernel_ms "
          f"{k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
    timed["prefill"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                            bound_by=b_by)
    del srv, eng
    torch.cuda.empty_cache()
    return dict(launches=launches, st=st, timed=timed)


def mk_chunk_parity_phase():
    """Phase 10: the chunked lane's served logits against the plain
    forward, 2 layers."""
    from triton_dist_tpu_torch import ModelConfig, ServingEngine
    from triton_dist_tpu_torch.megakernel import MegaKernelEngine

    cfg = dataclasses.replace(ModelConfig.qwen3_8b(), num_hidden_layers=2)
    eng = MegaKernelEngine(cfg, batch=4, max_len=1024, t_tile=128,
                           paged=True, page=128, num_pages=1 + 4 * 8,
                           prefill_buckets=(128, 512), device="cuda",
                           dtype=torch.bfloat16, seed=1, keep_params=True)
    srv = ServingEngine(eng, prefill_buckets=(128, 512))
    seen = record_logits(srv, {0, 1})
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (700, 60)]
    handles = [srv.submit(p, max_new_tokens=2) for p in prompts]
    srv.run()
    worst = 0.0
    for h, p in zip(handles, prompts):
        for step, seq in ((0, p), (1, p + h.tokens[:1])):
            served = seen[(h.request.request_id, step)]
            plain = plain_last_logits(eng.params, cfg, seq).cpu().numpy()
            err = float(np.abs(served - plain).max())
            worst = max(worst, err)
            print(f"[mk-chunk-parity] prompt {len(p)} step {step}: max "
                  f"|dlogit| {err:.4f} (tol {TOL_MK_SERVED}), argmax served "
                  f"{int(served.argmax())} plain {int(plain.argmax())}")
            if not (np.isfinite(served).all() and err <= TOL_MK_SERVED):
                fail(f"chunked megakernel logits disagree with the plain "
                     f"forward: {err}")
    if srv.stats()["prefill_chunks"] != 4:
        fail("the 700- and 60-token prompts did not take 3 + 1 chunks")
    del srv, eng
    torch.cuda.empty_cache()
    return worst


# ---- Qwen3-MoE (phases 11-14) -------------------------------------------

MOE_BUCKET = 128


def judge_flips(label, rows, k, pairs) -> int:
    """Routing flips against a reference run. ``rows`` maps a row's name
    to one ``(served ids, reference ids, served router logits (E,),
    reference router logits (E,))`` per layer. A row's first flipped
    layer must be a near-tie: the reference logits of the experts that
    only one run selected lie within ``TOL_MOE_TIE`` bf16 units, a unit
    taken at the reference's k-th largest logit. A flip in a later layer
    of the same row follows from the first (its input carries another
    expert's output) and is printed. Fails on any other flip; returns the
    number of flipped (row, layer) pairs among ``pairs``."""
    n = 0
    for name, layers in rows.items():
        first = None
        for li, (s_ids, r_ids, s_log, r_log) in enumerate(layers):
            if s_ids == r_ids:
                continue
            n += 1
            ref = np.asarray(r_log, np.float64)
            kth = abs(float(np.sort(ref)[-k]))
            unit = 2.0 ** (math.floor(math.log2(max(kth, 2.0 ** -126))) - 7)
            gap = (max(ref[e] for e in r_ids - s_ids)
                   - min(ref[e] for e in s_ids - r_ids)) / unit
            drift = float(np.abs(np.asarray(s_log, np.float64) - ref).max()
                          ) / unit
            what = (f"[{label}] {name} layer {li}: reference-only experts "
                    f"{sorted(r_ids - s_ids)}, served-only "
                    f"{sorted(s_ids - r_ids)}; reference gap {gap:.2f} bf16 "
                    f"units, router-logit drift {drift:.2f} units")
            if first is not None:
                print(f"{what}: follows the flip in layer {first}")
                continue
            first = li
            print(f"{what} (near-tie limit {TOL_MOE_TIE}): "
                  f"{'near-tie' if gap <= TOL_MOE_TIE else 'NOT a near-tie'}")
            if gap > TOL_MOE_TIE:
                fail(f"{label}: {name} routes away from the reference in "
                     f"layer {li} by {gap:.2f} bf16 units, no near-tie")
    print(f"[{label}] routing flips: {n} of {pairs} (row, layer) pairs, "
          f"every first flip of a row a near-tie")
    return n


def ids_of(mask) -> set:
    return set(torch.nonzero(mask).flatten().tolist())


def router_logits(mb, arena, row) -> np.ndarray:
    """(layers, E) fp32: one row's router logits from ``arena``."""
    E = mb.cfg.num_experts
    return torch.stack([
        arena[mb._offsets[f"l{li}.rl"] + row, :E]
        for li in range(mb.cfg.num_hidden_layers)]).float().cpu().numpy()


def moe_limits(label, got, want, fault=False) -> bool:
    """Phase 5's logit and row-RMS limits on every row; a sound run fails
    the script when it misses them, a faulted one reports."""
    atol, rtol = TOL_MK_LOGITS
    diff = (got - want).abs()
    logits_ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= atol + rtol * want.abs()).all())
    rel = row_rms(got, want)
    rows_ok = bool((rel <= TOL_MK_ROW_RMS).all())
    ok = logits_ok and rows_ok
    print(f"[{label}] rows {got.shape[0]}: max |dlogit| "
          f"{diff.max().item():.3e} (limit {atol} + {rtol}|want|: "
          f"{'ok' if logits_ok else 'exceeded'}), worst row RMS error / RMS "
          f"{rel.max().item():.2e} (limit {TOL_MK_ROW_RMS}: "
          f"{'ok' if rows_ok else 'exceeded'})"
          + (f" -> {'passes' if ok else 'caught'}" if fault else ""))
    if not fault and not ok:
        fail(f"{label}: the MoE megakernel strays from its plain version")
    return ok


def moe_routing(label, mb, arena, free_arena, counts, free_counts,
                routed_rows):
    """Routing of a kernel run against the free-running plain run (its
    own router logits): layer 0's router logits (upstream of every
    expert) within phase 5's K/V limit; every (row, layer) pair whose
    routed expert set differs printed and judged by ``judge_flips``;
    each run's counters summing to rows x layers x top-k and, per
    expert, to the (layer, row) pairs that routed there. Returns the
    flips."""
    got, ref = mb.routed_experts(arena), mb.routed_experts(free_arena)
    flips = (got != ref).any(-1)                               # (L, rows)
    rows = {}
    for r in torch.nonzero(flips.any(0)).flatten().tolist():
        s_log = router_logits(mb, arena, r)
        r_log = router_logits(mb, free_arena, r)
        rows[f"row {r}"] = [(ids_of(got[li, r]), ids_of(ref[li, r]),
                             s_log[li], r_log[li])
                            for li in range(mb.cfg.num_hidden_layers)]
    n = judge_flips(label, rows, mb.cfg.num_experts_per_tok, flips.numel())
    rl = mb._offsets["l0.rl"]
    b, E = mb.batch, mb.cfg.num_experts
    check_close(f"{label} layer-0 router logits", arena[rl:rl + b, :E],
                free_arena[rl:rl + b, :E], TOL_MK_KV)
    cfg = mb.cfg
    want_sum = routed_rows * cfg.num_hidden_layers * cfg.num_experts_per_tok
    exact = []
    for c, run_arena in ((counts, arena), (free_counts, free_arena)):
        per_expert = c.sum(0, dtype=torch.int64)[:E]
        exact.append(int(c.sum()) == want_sum and torch.equal(
            per_expert, mb.routed_experts(run_arena).sum((0, 1))))
    print(f"[{label}] expert counters: kernel {int(counts.sum())}, plain "
          f"{int(free_counts.sum())}, expected {want_sum}; each run's per "
          f"expert equal to the experts it routed to: {exact}")
    if not all(exact):
        fail(f"{label}: the expert counters are not exact")
    return n


def moe_pools(label, pools, plain_pools, before):
    """Every pool row the plain run wrote within phase 5's K/V limit, and
    every other one unchanged bit for bit."""
    written = ((plain_pools[0] != before[0]) | (plain_pools[1] != before[1])
               ).any(-1, keepdim=True).expand_as(before[0])
    err = 0.0
    for name, kc, k2, k0 in zip("KV", pools, plain_pools, before):
        err = max(err, check_close(f"{label} {name} rows", kc[written],
                                   k2[written], TOL_MK_KV))
        if not torch.equal(kc[~written], k0[~written]):
            fail(f"{label}: the kernel wrote {name} pool rows it must not")
    return err


def moe_weights_alone(label, mb, arena, plain_arena, dev):
    """MOE_WEIGHTS of layer 0 alone, kernel and plain, on the identical
    logit tile the kernel's step left in the arena: the same experts
    selected, weights within one bf16 unit, counters equal."""
    from triton_dist_tpu_torch.megakernel import TaskType

    t = next(x.task_id for x in mb.graph.tasks
             if x.task_type == TaskType.MOE_WEIGHTS)
    rl, wbe = mb.graph.tasks[t].args[:2]
    b = mb.batch
    plain_arena[rl:rl + b] = arena[rl:rl + b]
    one = mb.isolate([t])
    rows = mb.schema.region("moe_counts").rows
    c1, c2 = (torch.zeros(rows, mb.w, dtype=torch.int32, device=dev)
              for _ in range(2))
    kv = torch.zeros(mb.cfg.num_hidden_layers, 2, mb.page,
                     mb.cfg.num_key_value_heads, mb.cfg.head_dim,
                     dtype=torch.bfloat16, device=dev)
    lens = (np.full(b, -1, np.int32) if mb.chunk else np.zeros(b, np.int32))
    one.launch(arena, kv, kv.clone(), np.zeros(b, np.int32), lens,
               np.ones(mb.n_slots * mb.p_max, np.int32), counts=c1)
    one.wait(dev)
    zeros = np.zeros(b, np.int64)
    one.interpret(plain_arena, None, None, zeros, zeros,
                  np.zeros(1, np.int64), c2)
    got = arena[wbe:wbe + b].float()
    want = plain_arena[wbe:wbe + b].float()
    same = torch.equal(got != 0, want != 0) and torch.equal(c1, c2)
    err = (got - want).abs().max().item()
    unit = bool(((got - want).abs() <= 2.0 ** -8 * want.abs() + 1e-6).all())
    print(f"[{label}] MOE_WEIGHTS alone on one logit tile: selections and "
          f"counters equal {same}, max |dweight| {err:.3e} (one bf16 unit: "
          f"{unit})")
    if not (same and unit):
        fail(f"{label}: MOE_WEIGHTS disagrees with its plain body")
    return err


def moe_cfg(layers=None):
    from triton_dist_tpu_torch import ModelConfig

    cfg = ModelConfig.qwen3_moe_30b_a3b()
    return cfg if layers is None else dataclasses.replace(
        cfg, num_hidden_layers=layers)


def moe_kernel_phase():
    """Phase 11: the MoE megakernel against its plain interpreter at
    Qwen3-30B-A3B widths cut to 2 layers: decode, a 128-row chunk and a
    4 x 32 batched prefill, with the routing-flip rule and two planted
    faults."""
    from triton_dist_tpu_torch.megakernel import MegaKernelEngine
    from triton_dist_tpu_torch.models import qwen_moe
    from triton_dist_tpu_torch.ops.chunked_prefill import chunk_row_codes

    dev = torch.device("cuda", 0)
    cfg = moe_cfg(2)
    params = qwen_moe.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(21),
        device=dev, dtype=torch.bfloat16)
    kw = dict(batch=4, max_len=2048, t_tile=128, paged=True, page=128,
              num_pages=1 + 4 * 16, device=dev, dtype=torch.bfloat16,
              params=params)
    eng = MegaKernelEngine(cfg, prefill_buckets=(MOE_BUCKET,), **kw)
    table = mk_pools(eng, 22)
    out = {}

    def run(label, mb, toks, lens, tbl, routed_rows):
        """One launch against two plain runs on copies: free-running (its
        own routing: flips counted) and under the kernel's routing (every
        row held to phase 5's limits). Returns (max error, flips, the
        plain logits under the kernel's routing)."""
        before = eng.k_cache.clone(), eng.v_cache.clone()
        free = eng.arena.clone(), *[t.clone() for t in before]
        forced = eng.arena.clone(), *[t.clone() for t in before]
        c_free, c_forced = (torch.zeros_like(eng.counts) for _ in range(2))
        eng.counts.zero_()
        got = mb.step(eng.arena, eng.k_cache, eng.v_cache, toks, lens, tbl,
                      counts=eng.counts)
        mb.plain_step(*free, toks, lens, tbl, counts=c_free)
        want = mb.plain_step(*forced, toks, lens, tbl, counts=c_forced,
                             route_from=eng.arena)
        torch.cuda.synchronize()
        n = moe_routing(label, mb, eng.arena, free[0], eng.counts, c_free,
                        routed_rows)
        if not torch.equal(eng.counts, c_forced):
            fail(f"{label}: the kernel's counters differ from the plain "
                 "version's under the same routing")
        moe_limits(f"{label} under the kernel's routing", got, want)
        err = max(check_close(f"{label} logits", got, want, TOL_MK_LOGITS),
                  moe_pools(label, (eng.k_cache, eng.v_cache), forced[1:],
                            before),
                  moe_weights_alone(label, mb, eng.arena, forced[0], dev))
        eng.k_cache.copy_(before[0])
        eng.v_cache.copy_(before[1])
        return err, n, want

    mb = eng.builder
    rng = np.random.RandomState(23)
    toks = rng.randint(0, cfg.vocab_size, 4).astype(np.int32)
    lens = np.array(MK_LENS, np.int32)
    flat = eng.block_table
    out["decode"], _, want = run("moe-mk decode", mb, toks, lens, flat, 4)
    moe_fault_controls(eng, mb, toks, lens, flat, want)
    del want

    cb = eng.chunk_builders[MOE_BUCKET]
    ctoks = rng.randint(0, cfg.vocab_size, MOE_BUCKET).astype(np.int32)
    codes = chunk_row_codes(640, MOE_BUCKET, MOE_BUCKET, 700)
    out["chunk"], _, _ = run("moe-mk chunk 128 at 640 wfrom 700", cb,
                             ctoks, codes, table[2], MOE_BUCKET)
    del eng
    torch.cuda.empty_cache()

    eng = MegaKernelEngine(cfg, prefill_seq=32, **kw)
    mk_pools(eng, 24)
    pb = eng.prefill_builder
    prompt = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    out["prefill"], _, _ = run("moe-mk prefill 4 x 32 from 0", pb,
                               prompt.reshape(-1), np.zeros(128, np.int32),
                               eng.block_table, 128)
    del eng, params
    torch.cuda.empty_cache()
    return out


def moe_fault_controls(eng, mb, toks, lens, table, want):
    """Phase 11's limits must catch a wrong expert or a wrong combine
    weight: the decode step runs with layer 1's two most-routed experts'
    w_down regions swapped, then with every WEIGHTED_ADD reading the
    combine tile one column over, each against the sound plain run
    under the sound kernel run's routing (``want``)."""
    from triton_dist_tpu_torch.megakernel import TaskType

    routed = mb.routed_experts(eng.arena)[1]                # (rows, E)
    e1, e2 = torch.argsort(routed.sum(0), descending=True,
                           stable=True)[:2].tolist()
    r1 = mb.schema.region(f"l1.e{e1}.w_down")
    r2 = mb.schema.region(f"l1.e{e2}.w_down")
    k0, v0 = eng.k_cache.clone(), eng.v_cache.clone()
    arena = eng.arena

    def swap():
        tmp = arena[r1.offset:r1.offset + r1.rows].clone()
        arena[r1.offset:r1.offset + r1.rows] = arena[
            r2.offset:r2.offset + r2.rows]
        arena[r2.offset:r2.offset + r2.rows] = tmp

    shifted = copy.copy(mb)
    shifted.args_of = mb.args_of.copy()
    wa = mb.type_of == int(TaskType.WEIGHTED_ADD)
    shifted.args_of[wa, 3] = (shifted.args_of[wa, 3] + 1) % \
        mb.cfg.num_experts
    shifted._device_tables = {}
    for name, build, plant in ((f"experts {e1}/{e2} w_down swapped", mb,
                                swap),
                               ("combine tile one column over", shifted,
                                None)):
        if plant:
            plant()
        got = build.step(arena, k0.clone(), v0.clone(), toks, lens, table,
                         counts=eng.counts)
        torch.cuda.synchronize()
        if plant:
            plant()
        if moe_limits(f"moe-mk-control {name}", got, want, fault=True):
            fail(f"MoE megakernel limits do not catch a planted fault: "
                 f"{name}")


def moe_step_bound(mb, lens, routed):
    """Least time of one MoE launch for what this run's routing needs
    (``routed``: (layers, rows, E) bool, read off the launch): as
    ``mk_step_bound``, but an expert's weights count only in the layers
    where some row routed to it, and its operations only for the rows
    that routed to it (every other expert's output is scaled by a
    combine weight of 0). Returns (ms, what limits it, the (layer,
    expert) pairs routed to)."""
    elems = mb.w * sum(mb.schema.region(f"l0.e0.{m}").rows
                       for m in ("w_gate", "w_up", "w_down"))
    used = routed.any(1)
    nbytes, flops = mk_step_work(mb, lens)
    ms, by = bound(nbytes - int((~used).sum()) * elems * 2,
                   flops - 2 * int((~routed).sum()) * elems)
    return ms, by, int(used.sum())


def moe_mk_serve_phase():
    """Phase 12: Qwen3-30B-A3B at full width and depth on the MoE
    megakernel lane with bucket 128."""
    from triton_dist_tpu_torch import ServingEngine
    from triton_dist_tpu_torch.megakernel import MegaKernelEngine
    from triton_dist_tpu_torch.ops.chunked_prefill import chunk_row_codes

    cfg = moe_cfg()
    buckets = (MOE_BUCKET,)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = MegaKernelEngine(cfg, batch=4, max_len=2048, t_tile=128,
                           paged=True, page=128, num_pages=1 + 4 * 16,
                           prefill_buckets=buckets, device="cuda",
                           dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    mb, cb = eng.builder, eng.chunk_builders[MOE_BUCKET]
    print(f"[moe-serve] Qwen3-30B-A3B megakernel engine in "
          f"{time.perf_counter() - t0:.1f} s: host builds decode "
          f"{mb.build_seconds:.1f} s ({len(mb.graph.tasks)} tasks, "
          f"{len(mb.preds)} pruned edges), chunk-128 {cb.build_seconds:.1f} s "
          f"({len(cb.graph.tasks)} tasks); arena {eng.arena.shape[0]} x "
          f"{eng.arena.shape[1]} bf16 ({eng.arena.numel() * 2 / 1e9:.2f} GB; "
          f"decode build {mb.arena_rows} rows); "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ServingEngine(eng, prefill_buckets=buckets).generate(
        [[7] * 130], max_new_tokens=2)                     # warm-up

    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (1000, 700, 300, 60)]
    srv = ServingEngine(eng, prefill_buckets=buckets)
    counts0 = eng.expert_counts()
    zero_counts()
    t0 = time.perf_counter()
    outs = srv.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    routed = int((eng.expert_counts() - counts0).sum())
    st = srv.stats()
    print(f"[moe-serve] {st['completed']} requests in {wall:.2f} s; "
          f"{st['prefill_chunks']} chunks, {st['decode_dispatches']} decode "
          f"ticks, kernel launches {launches}")
    print(f"[moe-serve] {torch.cuda.get_device_name(0)}: prefill "
          f"{st['prefill_tokens_per_s']:.1f} tokens/s over "
          f"{st['prefill_time_s']:.2f} s; decode {st['tokens_per_s']:.1f} "
          f"tokens/s, {1e3 * st['decode_time_s'] / st['decode_dispatches']:.2f}"
          f" ms per tick; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want_routed = ((4 * st["decode_dispatches"]
                    + MOE_BUCKET * st["prefill_chunks"])
                   * cfg.num_hidden_layers * cfg.num_experts_per_tok)
    load = np.asarray(st["expert_load"])
    print(f"[moe-serve] routed (row, layer, expert) picks {routed} (expected "
          f"{want_routed}); server expert totals {sum(st['expert_totals'])} "
          f"over the decode ticks, load EWMA max/mean "
          f"{load.max() / load.mean():.2f}; dispatch_transport "
          f"{st['dispatch_transport']}")
    if [len(o) for o in outs] != [64] * 4:
        fail(f"requests did not finish with 64 tokens: {[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        fail("token id out of range")
    if (st["prefill_chunks"] != 18
            or launches["mk_chunk"] != st["prefill_chunks"]
            or launches["mk_decode"] != st["decode_dispatches"]
            or launches["megakernel"] != launches["mk_chunk"]
            + launches["mk_decode"]
            or launches["decode"] != 0 or launches["qblock"] != 0):
        fail(f"MoE megakernel lane bypassed its kernel: launches {launches}, "
             f"{st['prefill_chunks']} chunks, {st['decode_dispatches']} "
             "decode ticks")
    if routed != want_routed:
        fail(f"expert_counts() is not exact: {routed} != {want_routed}")

    dev = torch.device("cuda", 0)
    table = mk_pools(eng, 25)
    timed = {}
    toks = rng.randint(0, cfg.vocab_size, 4).astype(np.int32)
    lens = np.array(MK_LENS, np.int32)
    tbl = eng.block_table
    host = mb._host_inputs(eng.k_cache, toks, lens, tbl)
    task_ns = torch.zeros(len(mb.graph.tasks), 2, dtype=torch.int64,
                          device=dev)
    k_ms = time_events(lambda: mb.launch(eng.arena, eng.k_cache, eng.v_cache,
                                         *host, counts=eng.counts,
                                         task_ns=task_ns), reps=5)
    per = mb.task_ms(task_ns)
    a_ms, _ = mk_step_bound(mb, lens)
    b_ms, b_by, n_routed = moe_step_bound(mb, lens,
                                          mb.routed_experts(eng.arena))
    p_ms = time_events(lambda: mb.plain_step(eng.arena, eng.k_cache,
                                             eng.v_cache, toks, lens, tbl,
                                             counts=eng.counts),
                       reps=1, warmup=0)
    print(f"[moe-mk-step] full-depth decode step at lengths {list(MK_LENS)}:"
          f" kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} "
          f"({b_by}, the {n_routed} (layer, expert) pairs routed to); "
          f"{a_ms:.4f} ms over every expert, as the JAX design reads them")
    print("[moe-mk-step]   task ms by type (sum, longest): " + ", ".join(
        f"{k} {v[0]:.2f}/{v[1]:.3f}" for k, v in sorted(
            per.items(), key=lambda kv: -kv[1][0])))
    timed["decode"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by)

    ctoks = rng.randint(0, cfg.vocab_size, MOE_BUCKET).astype(np.int32)
    codes = chunk_row_codes(0, MOE_BUCKET, MOE_BUCKET, 0)
    host = cb._host_inputs(eng.k_cache, ctoks, codes, table[1])
    task_ns = torch.zeros(len(cb.graph.tasks), 2, dtype=torch.int64,
                          device=dev)
    k_ms = time_events(lambda: cb.launch(eng.arena, eng.k_cache, eng.v_cache,
                                         *host, counts=eng.counts,
                                         task_ns=task_ns), reps=3)
    per = cb.task_ms(task_ns)
    a_ms, _ = mk_step_bound(cb, codes)
    b_ms, b_by, n_routed = moe_step_bound(cb, codes,
                                          cb.routed_experts(eng.arena))
    p_ms = time_events(lambda: cb.plain_step(
        eng.arena, eng.k_cache, eng.v_cache, ctoks, codes, table[1],
        counts=eng.counts), reps=1, warmup=0)
    lin = per["LINEAR"][0] / grid_blocks()
    print(f"[moe-mk-chunk-step] {MOE_BUCKET} rows from 0, "
          f"{cfg.num_hidden_layers} layers: kernel_ms {k_ms:.4f} plain_ms "
          f"{p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}, the {n_routed} (layer, "
          f"expert) pairs routed to; {a_ms:.4f} ms over every expert); "
          f"LINEAR {lin:.2f} ms per block on {grid_blocks()} blocks")
    print("[moe-mk-chunk-step]   task ms by type (sum, longest): " + ", ".join(
        f"{k} {v[0]:.2f}/{v[1]:.3f}" for k, v in sorted(
            per.items(), key=lambda kv: -kv[1][0])))
    timed["chunk"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by)
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    del srv, eng, mb, cb, host
    torch.cuda.empty_cache()
    return dict(launches=launches, st=st, timed=timed, peak=peak, held=held)


def moe_layer_serve_phase(held_before):
    """Phase 13: the same model and prompts on the layer lane, buckets
    (128, 512), after the megakernel engine is freed."""
    from triton_dist_tpu_torch import Engine

    now = torch.cuda.memory_allocated()
    print(f"[moe-layer-serve] megakernel engine freed: "
          f"{held_before / 2**30:.2f} -> {now / 2**30:.2f} GiB allocated")
    if now > 0.1 * held_before:
        fail("the MoE megakernel engine's memory was not released")
    cfg = moe_cfg()
    serve_kw = dict(num_slots=4, page=32, prefill_buckets=(128, 512))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, device="cuda", dtype=torch.bfloat16, max_len=2048,
                 seed=0)
    torch.cuda.synchronize()
    print(f"[moe-layer-serve] Qwen3-30B-A3B weights on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eng.serving(**serve_kw).generate([[7] * 130], max_new_tokens=2)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (1000, 700, 300, 60)]
    srv = eng.serving(**serve_kw)
    zero_counts()
    t0 = time.perf_counter()
    outs = srv.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    st = srv.stats()
    print(f"[moe-layer-serve] {st['completed']} requests in {wall:.2f} s; "
          f"decode dispatches {st['decode_dispatches']}, prefill chunks "
          f"{st['prefill_chunks']}, kernel launches {launches}")
    print(f"[moe-layer-serve] {torch.cuda.get_device_name(0)}: decode "
          f"{st['tokens_per_s']:.1f} tokens/s over "
          f"{st['decode_time_s']:.2f} s; prefill "
          f"{st['prefill_tokens_per_s']:.1f} tokens/s over "
          f"{st['prefill_time_s']:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if [len(o) for o in outs] != [64] * 4:
        fail(f"requests did not finish with 64 tokens: {[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        fail("token id out of range")
    L = cfg.num_hidden_layers
    if (launches["decode"] != L * st["decode_dispatches"]
            or launches["qblock"] != L * st["prefill_chunks"]
            or launches["megakernel"] != 0
            or min(launches["decode"], launches["qblock"]) == 0):
        fail(f"MoE layer lane bypassed a kernel: launches {launches}, "
             f"{L} layers x {st['decode_dispatches']} decode steps / "
             f"{st['prefill_chunks']} chunks")
    del srv
    # Phase 16 on the same weights: a second copy of 61 GB would not fit.
    moe_engine = engine_phase("moe", cfg, eng.params)
    del eng
    torch.cuda.empty_cache()
    return moe_engine


class RouteLog:
    """Records the expert ids and the fp32 router logits of every
    ``tp_moe.route`` call (the layer lane's and the plain forward's
    router) while active."""

    def __init__(self):
        self.calls, self.logits = [], []

    def __enter__(self):
        from triton_dist_tpu_torch.layers import tp_moe

        self._orig = orig = tp_moe.route

        def recording(router_w, x, *a, **kw):
            ids, w = orig(router_w, x, *a, **kw)
            self.calls.append(ids.cpu().numpy())
            self.logits.append((x.float() @ router_w.float().T).cpu().numpy())
            return ids, w

        tp_moe.route = recording
        return self

    def __exit__(self, *exc):
        from triton_dist_tpu_torch.layers import tp_moe

        tp_moe.route = self._orig


def moe_parity_phase():
    """Phase 14: the first two served tokens' logits on both MoE lanes at
    2 layers against a plain forward of qwen_moe (whole prompt, dense
    K/V), within 0.15 on every (prompt, step) whose routing equals the
    plain forward's in both layers; routing flips judged by
    ``judge_flips``."""
    from triton_dist_tpu_torch import Engine, ServingEngine
    from triton_dist_tpu_torch.megakernel import MegaKernelEngine
    from triton_dist_tpu_torch.models import qwen_moe

    dev = torch.device("cuda", 0)
    cfg = moe_cfg(2)
    params = qwen_moe.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(31),
        device=dev, dtype=torch.bfloat16)
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (700, 60)]

    def ffn(layer, h):
        return qwen_moe.moe_ffn_decode(layer.moe, h, cfg)

    eng = MegaKernelEngine(cfg, batch=4, max_len=1024, t_tile=128,
                           paged=True, page=128, num_pages=1 + 4 * 8,
                           prefill_buckets=(MOE_BUCKET,), params=params,
                           device=dev, dtype=torch.bfloat16)
    log = []
    chunk, decode = eng.prefill_chunk, eng.decode_step

    def rec_chunk(toks, codes, table_row, *, row=None):
        out = chunk(toks, codes, table_row, row=row)
        b = eng.chunk_builders[len(toks)]
        log.append(("chunk", b.routed_experts(eng.arena)[:, row],
                    router_logits(b, eng.arena, row)))
        return out

    def rec_decode(toks, lens):
        out = decode(toks, lens)
        log.append(("decode", eng.builder.routed_experts(eng.arena)[:, 0],
                    router_logits(eng.builder, eng.arena, 0)))
        return out

    eng.prefill_chunk, eng.decode_step = rec_chunk, rec_decode
    lanes = {"mk": ServingEngine(eng, prefill_buckets=(MOE_BUCKET,))}
    layer = Engine(cfg, params=params, device=dev, dtype=torch.bfloat16,
                   max_len=1024)
    lanes["layer"] = layer.serving(num_slots=4, page=32,
                                   prefill_buckets=(128, 512))
    # Phase 17: monolithic serving on the fused engine (the grouped GEMM
    # kernel in every prefill layer).
    fused = Engine(cfg, mode="fused", params=params, device=dev,
                   dtype=torch.bfloat16, max_len=1024)
    lanes["mono"] = fused.serving(num_slots=4, page=32)
    worst, flips = 0.0, {name: {} for name in lanes}
    plain = {}

    def plain_run(seq):
        """The plain forward's last-row logits, routed sets and router
        logits."""
        if tuple(seq) not in plain:
            with RouteLog() as rl:
                want = plain_last_logits(params, cfg, seq, ffn).cpu().numpy()
            plain[tuple(seq)] = (want, [set(rl.calls[li][-1].tolist())
                                        for li in range(2)],
                                 [rl.logits[li][-1] for li in range(2)])
        return plain[tuple(seq)]

    for p in prompts:
        for name, srv in lanes.items():
            seen = record_logits(srv, {0, 1})
            log.clear()
            with RouteLog() as rl:
                h = srv.submit(p, max_new_tokens=2)
                srv.run()
            # The last chunk's last valid row and the first decode tick's
            # slot-0 row (one request on a drained server takes slot 0).
            if name == "mk":
                steps = ([e for e in log if e[0] == "chunk"][-1],
                         [e for e in log if e[0] == "decode"][0])
                routes = [[ids_of(m[li]) for li in range(2)]
                          for _, m, _ in steps]
                served = [lg for _, _, lg in steps]
            else:
                # The last prompt row: of the last chunk, or of the one
                # monolithic prefill.
                last = (h.chunks[-1][2] if name == "layer" else len(p)) - 1
                routes = [[set(rl.calls[-4 + li][last].tolist())
                           for li in range(2)],
                          [set(rl.calls[-2 + li][0].tolist())
                           for li in range(2)]]
                served = [[rl.logits[-4 + li][last] for li in range(2)],
                          [rl.logits[-2 + li][0] for li in range(2)]]
            for step, seq in ((0, p), (1, p + h.tokens[:1])):
                got = seen[(h.request.request_id, step)]
                want, want_sets, want_rl = plain_run(seq)
                flipped = [li for li in range(2)
                           if routes[step][li] != want_sets[li]]
                flips[name][f"prompt {len(p)} step {step}"] = [
                    (routes[step][li], want_sets[li], served[step][li],
                     want_rl[li]) for li in range(2)]
                err = float(np.abs(got - want).max())
                print(f"[moe-parity] {name} lane, prompt {len(p)} step {step}"
                      f": routing flips in layers {flipped}, max |dlogit| "
                      f"{err:.4f} (tol {TOL_MK_SERVED}), logit std "
                      f"{want.std():.3f}, argmax served {int(got.argmax())} "
                      f"plain {int(want.argmax())}")
                if not np.isfinite(got).all():
                    fail("served MoE logits are not finite")
                if not flipped:
                    worst = max(worst, err)
                    if err > TOL_MK_SERVED:
                        fail(f"MoE served logits disagree with the plain "
                             f"forward: {err}")
    for name, rows in flips.items():
        judge_flips(f"moe-parity {name} lane", rows,
                    cfg.num_experts_per_tok, 2 * len(rows))
    del lanes, eng, layer, fused, params
    torch.cuda.empty_cache()
    return worst


# ---- The dense-cache engine (phases 15-17) -------------------------------

TOL_FLASH = TOL_QBLOCK
TOL_GG = (1e-3, 2.0 ** -7)       # one bf16 unit: both sum in fp32, round once
ENGINE_IDS = (4, 512)            # Engine.serve's prompt batch


def fault_control(label, got, want, tol) -> None:
    """A planted fault must fail ``tol`` against the sound plain output."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    caught = bool((diff > atol + rtol * want.float().abs()).any()) or \
        not bool(torch.isfinite(got).all())
    print(f"[{label}] planted fault: max_abs_err {diff.max().item():.3e}, "
          f"caught={caught}")
    if not caught:
        fail(f"{label}: the limit does not catch a planted fault")


def flash_kernel_phase():
    """Phase 15a: the prefill flash-attention kernel against its plain
    version: S 512 and 1000, GQA 4 and 8, head_dim 128 and 8; a key tile
    of another KV head planted in K must fail the limit; times at the
    dense Engine.serve shape (4 x 512, 32/8 heads, head_dim 128)."""
    from triton_dist_tpu_torch.ops import flash_attention as fa
    from triton_dist_tpu_torch.utils import build

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(41)
    bf = dict(device=dev, dtype=torch.bfloat16)
    errs, out = [], {}
    for b, s, h, kv, hd in ((4, 512, 32, 8, 128), (1, 1000, 32, 4, 128),
                            (1, 1000, 32, 8, 128), (2, 512, 8, 1, 8),
                            (1, 1000, 8, 2, 8)):
        q = torch.randn(b, s, h, hd, generator=g, **bf)
        k = torch.randn(b, s, kv, hd, generator=g, **bf)
        v = torch.randn(b, s, kv, hd, generator=g, **bf)
        got = fa.flash_attention(q, k, v, sm_scale=hd ** -0.5)
        want = fa.flash_attention_ref(q, k, v, sm_scale=hd ** -0.5)
        torch.cuda.synchronize()
        label = f"flash B {b} S {s} H {h} KV {kv} hd {hd}"
        errs.append(check_close(label, got, want, TOL_FLASH))
        if not out:
            bad = k.clone()
            bad[:, 64:128, 0] = k[:, 64:128, 1]
            fault_control(label, fa.flash_attention(
                q, bad, v, sm_scale=hd ** -0.5), want, TOL_FLASH)
        if s == 1000 and kv == 4 or not out:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            k_ms = time_ms(lambda: fa.flash_attention(q, k, v,
                                                      sm_scale=hd ** -0.5))
            p_ms = time_ms(lambda: fa.flash_attention_ref(
                q, k, v, sm_scale=hd ** -0.5))
            y_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                        enable_gqa=True))
            nbytes = 2 * (q.numel() + k.numel()) * 2   # q, out; k, v
            flops = 4 * b * h * hd * s * (s + 1) / 2
            b_ms, b_by = bound(nbytes, flops)
            print(f"[flash] {label}: kernel_ms {k_ms:.4f} plain_ms "
                  f"{p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms "
                  f"(causal SDPA, enable_gqa) {y_ms:.4f}; "
                  f"{flops / k_ms / 1e9:.1f} TFLOP/s")
            if not out:
                out = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=y_ms)
    smem = build.load("flash_attention.cu").tdt_flash_attention_smem_bytes
    print(f"[smem] flash_attention_kernel {smem(128)} B/block at head_dim "
          f"128, {smem(8)} at 8 (dynamic)")
    out["err"] = max(errs)
    return out


def grouped_mm_ms(xs, w, te, tm):
    """Yardstick: ``torch._grouped_mm`` over the same expert segments
    (every tile's rows, weights (E, out, in) read as (E, in, out)), or
    None where the card's torch has no such call or refuses the shapes.
    The port never calls it."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        print("[group_gemm] library: this torch has no torch._grouped_mm")
        return None
    offs = (torch.cumsum(torch.bincount(te.long(), minlength=w.shape[0]), 0)
            * tm).to(torch.int32)
    wt = w.transpose(1, 2)
    try:
        fn(xs, wt, offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        print(f"[group_gemm] library: torch._grouped_mm refused: {e}")
        return None
    return time_ms(lambda: fn(xs, wt, offs=offs))


def group_gemm_kernel_phase():
    """Phase 15b: the row-tile grouped GEMM against its plain version at
    Qwen3-30B-A3B widths (E 128, top-8, d 2048, expert ffn 768) on a real
    routing of 60, 700 and 2048 tokens (row tiles 8, 32, 128): gate/up as
    one launch over the two weights, then down; a tile->expert map
    shifted by one must fail the limit; times at 2048 tokens (the MoE
    Engine.serve prefill)."""
    from triton_dist_tpu_torch.layers.ep_moe import route
    from triton_dist_tpu_torch.layers.norm import rms_norm
    from triton_dist_tpu_torch.ops import ag_moe
    from triton_dist_tpu_torch.ops import group_gemm as gg

    cfg = moe_cfg()
    d, f = cfg.hidden_size, cfg.moe_intermediate_size
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(43)
    bf = dict(device=dev, dtype=torch.bfloat16)
    wg = torch.randn(e, f, d, generator=g, **bf) * d ** -0.5
    wu = torch.randn(e, f, d, generator=g, **bf) * d ** -0.5
    wd = torch.randn(e, d, f, generator=g, **bf) * f ** -0.5
    router = torch.randn(e, d, generator=g, **bf) * d ** -0.5
    errs, out = [], {}
    for t, want_tm in ((60, 8), (700, 32), (2048, 128)):
        x = rms_norm(torch.randn(t, d, generator=g, **bf),
                     torch.ones(d, **bf))
        ids, _ = route(router, x, k)
        tm = ag_moe.suggested_block_m(t, k, e, 256)
        if tm != want_tm:
            fail(f"suggested_block_m({t}) = {tm}, expected {want_tm}")
        xs, te, row_src = ag_moe.prepare_grouped_tokens(x, ids, e, tm)
        h = gg.grouped_gemm_tiles(xs, (wg, wu), te)
        want = gg.grouped_gemm_tiles_ref(xs, (wg, wu), te)
        torch.cuda.synchronize()
        label = f"group_gemm T {t} tm {tm} ({te.numel()} tiles)"
        errs.append(check_close(label + " gate/up", h, want, TOL_GG))
        act = (torch.nn.functional.silu(h[:, :f].float())
               * h[:, f:].float()).to(torch.bfloat16)
        y = gg.grouped_gemm_tiles(act, wd, te)
        y_want = gg.grouped_gemm_tiles_ref(act, wd, te)
        torch.cuda.synchronize()
        errs.append(check_close(label + " down", y, y_want, TOL_GG))
        if t != 2048:
            continue
        fault_control(label + " gate/up", gg.grouped_gemm_tiles(
            xs, (wg, wu), torch.roll(te, 1)), want, TOL_GG)
        owned = torch.unique(te[(row_src.view(-1, tm) >= 0).any(1)]).numel()
        rows = t * k
        w_gu = torch.cat([wg, wu], 1)
        for name, a, w, fo, wl in (("gate/up", xs, (wg, wu), 2 * f, w_gu),
                                   ("down", act, wd, d, wd)):
            fi = a.shape[1]
            nbytes = (rows * fi + owned * fo * fi + rows * fo) * 2
            b_ms, b_by = bound(nbytes, 2 * rows * fi * fo)
            k_ms = time_ms(lambda: gg.grouped_gemm_tiles(a, w, te))
            p_ms = time_ms(lambda: gg.grouped_gemm_tiles_ref(a, w, te),
                           reps=5)
            y_ms = grouped_mm_ms(a, wl, te, tm)
            print(f"[group_gemm] {name} T {t}: {xs.shape[0]} sorted rows "
                  f"({rows} routed), {owned} experts own a tile: kernel_ms "
                  f"{k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} "
                  f"({b_by}; {nbytes / 1e6:.0f} MB, "
                  f"{2 * rows * fi * fo / 1e9:.0f} GFLOP routed) library_ms "
                  f"(torch._grouped_mm) {y_ms}")
            out[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=y_ms)
    out["err"] = max(errs)
    return out


def engine_phase(label, cfg, params):
    """Phase 16: ``Engine(cfg, mode="fused").serve`` of a (4, 512) prompt
    batch for 64 tokens and monolithic serving (``serving(num_slots=4,
    page=32)``, no buckets) of the 1000/700/300/60-token prompts for 64
    tokens each, on ``params`` at full depth. Every prefill layer must
    launch the flash-attention kernel once and, for MoE, the grouped GEMM
    twice; monolithic decode ticks run the paged decode kernel."""
    from triton_dist_tpu_torch import Engine

    eng = Engine(cfg, mode="fused", params=params, device="cuda",
                 dtype=torch.bfloat16, max_len=2048)
    L = cfg.num_hidden_layers
    gg_per = 2 if cfg.is_moe else 0
    rng = np.random.RandomState(2)
    eng.serve(rng.randint(0, cfg.vocab_size, (1, 64)), gen_len=2)
    ids = rng.randint(0, cfg.vocab_size, ENGINE_IDS)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng.serve(ids, gen_len=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = read_counts()
    print(f"[{label}-engine] Engine.serve {ENGINE_IDS} + 64 tokens in "
          f"{wall:.2f} s; kernel launches {n}")
    if tuple(toks.shape) != (4, 64) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"Engine.serve gave {tuple(toks.shape)} tokens or ids out of "
             "range")
    if (n["flash"] != L or n["group_gemm"] != gg_per * L
            or n["decode"] or n["qblock"] or n["megakernel"]):
        fail(f"Engine.serve bypassed a kernel: launches {n}, {L} layers")
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        logits, cache = eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3 / reps
    tok = torch.argmax(logits, -1).to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(8):
        logits, cache = eng.decode(tok, cache)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / 8
    tokens = int(np.prod(ENGINE_IDS))
    print(f"[{label}-engine] {torch.cuda.get_device_name(0)}: prefill of "
          f"{ENGINE_IDS} {prefill_ms:.1f} ms "
          f"({tokens / prefill_ms * 1e3:.0f} tokens/s), decode step at "
          f"512 {decode_ms:.2f} ms ({4 / decode_ms * 1e3:.1f} tokens/s over "
          "4 rows)")
    prof_dec = profile_window(lambda: eng.decode(tok, cache), 1,
                              f"{label} Engine.decode step at 520")
    del logits, cache
    prof = profile_window(lambda: eng.prefill(ids), 1,
                          f"{label} Engine.prefill {ENGINE_IDS}")

    srv = eng.serving(num_slots=4, page=32)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, m)]
               for m in (1000, 700, 300, 60)]
    zero_counts()
    t0 = time.perf_counter()
    outs = srv.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = read_counts()
    st = srv.stats()
    print(f"[{label}-mono] {st['completed']} requests in {wall:.2f} s; "
          f"prefill calls {st['prefill_calls']}, decode dispatches "
          f"{st['decode_dispatches']}, kernel launches {m}; decode "
          f"{st['tokens_per_s']:.1f} tokens/s, prefill "
          f"{st['prefill_tokens_per_s']:.1f} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if [len(o) for o in outs] != [64] * 4 or st["prefill_calls"] != 4:
        fail(f"monolithic serving: {[len(o) for o in outs]} tokens, "
             f"{st['prefill_calls']} prefill calls")
    if (m["flash"] != L * 4 or m["group_gemm"] != gg_per * L * 4
            or m["decode"] != L * st["decode_dispatches"] or m["qblock"]
            or m["megakernel"]):
        fail(f"monolithic serving bypassed a kernel: launches {m}")
    del srv, eng
    torch.cuda.empty_cache()
    return dict(serve=n, mono=m, prefill_ms=prefill_ms, decode_ms=decode_ms,
                prof=prof, prof_dec=prof_dec)


def checkpoint_phase():
    """Phase 18: the committed HF fixtures (``tests/fixtures/qwen3_tiny``,
    ``qwen3_moe_tiny``) loaded onto the card in bf16 by
    ``load_hf_checkpoint`` and served: ``Engine(mode="fused").serve`` of a
    (2, 8) batch for 8 tokens through both kernels, every layer counted,
    its prefill logits within TOL_CKPT_LOGITS of the plain forward. A
    planted fault, the last layer's attention output scaled by 0.9 (about
    1e-2 of logit), must fail that limit. (Not the paged server: the
    paged kernels are compiled for head_dim 128 only, the fixtures have
    8.)"""
    import pathlib

    from triton_dist_tpu_torch import Engine
    from triton_dist_tpu_torch.models import qwen_moe
    from triton_dist_tpu_torch.models.hf_loader import load_hf_checkpoint

    root = pathlib.Path(__file__).resolve().parent / "tests" / "fixtures"
    ids = np.array([[3, 17, 250, 9, 77, 1, 128, 64],
                    [5, 5, 200, 11, 0, 42, 7, 99]], np.int32)
    for name in ("qwen3_tiny", "qwen3_moe_tiny"):
        cfg, params = load_hf_checkpoint(str(root / name), torch.bfloat16,
                                         "cuda")
        eng = Engine(cfg, mode="fused", params=params, max_len=64)
        L = cfg.num_hidden_layers
        zero_counts()
        toks = eng.serve(ids, gen_len=8)
        n = read_counts()
        if (n["flash"] != L or n["group_gemm"] != (2 * L if cfg.is_moe
                                                   else 0)
                or tuple(toks.shape) != (2, 8)
                or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
            fail(f"{name}: Engine.serve gave {tuple(toks.shape)} tokens, "
                 f"launches {n}")
        ffn = ((lambda layer, h: qwen_moe.moe_ffn_decode(layer.moe, h, cfg))
               if cfg.is_moe else None)
        want = [plain_last_logits(params, cfg, ids[r].tolist(), ffn)
                for r in range(2)]

        def served_err():
            logits, _ = eng.prefill(ids)
            return logits, max(float((logits[r] - want[r]).abs().max())
                               for r in range(2))

        logits, err = served_err()
        wo = params.layers[-1].attn.wo
        keep = wo.detach().clone()
        with torch.no_grad():
            wo.mul_(0.9)
        _, planted = served_err()
        with torch.no_grad():
            wo.copy_(keep)
        print(f"[checkpoint] {name}: {L} layers, Engine.serve tokens "
              f"{toks.tolist()}, launches {n}; prefill logits max |dlogit| "
              f"{err:.2e} against the plain forward (tol {TOL_CKPT_LOGITS},"
              f" logit std {float(logits.float().std()):.3f}); planted "
              f"fault (last layer's attention x0.9) {planted:.2e}")
        if not err <= TOL_CKPT_LOGITS:
            fail(f"{name}: served logits disagree with the plain forward")
        if not planted > TOL_CKPT_LOGITS:
            fail(f"{name}: the planted attention fault passed the limit")
        del eng, params
    torch.cuda.empty_cache()


# ---- Quantized pools and speculative decoding (phases 19-23) -------------

KV_QUANT = ("int8", "fp8")
# Quantized served logits against the plain quantized run (the layer
# lane's limits), and the JAX CPU battery's bounds of a quantized pool's
# first-decode logits against a bf16 pool's (printed, not gated).
TOL_QUANT_LOGITS = {"int8": 0.1, "fp8": 0.15}
JAX_CPU_BOUND = {"int8": 0.05, "fp8": 0.15}
SPEC_K, SPEC_NGRAM = 4, 3
# Code steps the write task alone may stray from the plain sequence. The
# two quantize the same rows up to the ulps of two rope spellings, so a
# token's code may land one step off at a rounding tie; a later rescale
# carries that step on, and for fp8, whose steps halve in each lower
# binade, a step of the binade above can become two below (measured on
# an H100: 1.6 of the plain value's step in a 512-row chunk).
WRITE_STEPS = {"int8": 1, "fp8": 2}


def quant_pools(dev, kvd, num_pages, kvh, page, hd, seed):
    """One layer's quantized page pool written by the plain writer
    (``PagedKVCache.write_prompt``: one fresh max-abs scale per page and
    head) from seeded bf16 K/V; page 0 stays the zero scratch page.
    Returns (K codes, V codes, K scales, V scales)."""
    from triton_dist_tpu_torch.serving.blocks import PagedKVCache

    g = torch.Generator(device=dev).manual_seed(seed)
    cache = PagedKVCache.empty(1, num_pages, page, kvh, hd, num_slots=1,
                               p_max=1, device=dev, kv_dtype=kvd)
    n = (num_pages - 1) * page
    k, v = (torch.randn(1, n, kvh, hd, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    cache.write_prompt(k, v, list(range(1, num_pages)))
    return (cache.k_pages[0], cache.v_pages[0], cache.k_scale[0],
            cache.v_scale[0])


def quant_kernel_phase():
    """Phase 19: the int8 and fp8 forms of rows 15 and 16 against their
    plain versions at the serve shapes, with a planted fault each."""
    from triton_dist_tpu_torch.ops import paged_flash_decode as pfd
    from triton_dist_tpu_torch.ops import paged_flash_qblock as pfq

    dev = torch.device("cuda", 0)
    S, H, KV, HD, PAGE, P_MAX = 4, 32, 8, 128, 32, 128
    num_pages = 1 + S * P_MAX
    g = torch.Generator(device=dev).manual_seed(19)
    bf = dict(device=dev, dtype=torch.bfloat16)
    perm = torch.randperm(num_pages - 1, generator=g, device=dev) + 1
    table = perm.view(S, P_MAX).to(torch.int32).contiguous()
    table[0] = 0                                     # parked slot
    kv_len = torch.tensor([1, 1025, 736, 333], dtype=torch.int32, device=dev)
    n = kv_len.clamp(min=1).double()
    out = {}
    for kvd in KV_QUANT:
        kc, vc, ks, vs = quant_pools(dev, kvd, num_pages, KV, PAGE, HD, 19)
        sc = dict(k_scale=ks, v_scale=vs)
        # The scale table of the next page id: every page misread.
        bad = dict(k_scale=ks.roll(-1, 0).contiguous(),
                   v_scale=vs.roll(-1, 0).contiguous())
        q = torch.randn(S, H, HD, generator=g, **bf)
        got = pfd.paged_flash_decode(q, kc, vc, table, kv_len, **sc)
        want = pfd.paged_flash_decode_ref(q, kc, vc, table, kv_len, ks, vs)
        torch.cuda.synchronize()
        err = check_close(f"decode-{kvd}", got, want, TOL_DECODE)
        fault_control(f"decode-{kvd} next page's scales",
                      pfd.paged_flash_decode(q, kc, vc, table, kv_len, **bad),
                      want, TOL_DECODE)
        pages = (n / PAGE).ceil().sum().item()
        # One byte an element, the K and V scales of every page read.
        nbytes = (2 * q.numel() * 2 + n.sum().item() * KV * HD * 2
                  + pages * KV * 4 * 2 + S * 4 + pages * 4)
        flops = 4 * H * HD * n.sum().item()
        k_ms = time_ms(lambda: pfd.paged_flash_decode(q, kc, vc, table,
                                                      kv_len, **sc))
        p_ms = time_ms(lambda: pfd.paged_flash_decode_ref(
            q, kc, vc, table, kv_len, ks, vs))
        b_ms, b_by = bound(nbytes, flops)
        print(f"[decode-{kvd}] kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
              f"bound_ms {b_ms:.4f} ({b_by})")
        out[f"decode-{kvd}"] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                    bound_ms=b_ms, bound_by=b_by)

        # Q-block: a 512-query chunk from 0, and a verify block of K = 4
        # per slot at the decode lengths (query j at kv_len + j).
        row = table[1:2]
        C = 512
        qc = torch.randn(1, C, H, HD, generator=g, **bf)
        pos0 = torch.arange(C, dtype=torch.int32, device=dev)[None]
        got = pfq.paged_flash_qblock(qc, kc, vc, row, pos0, **sc)
        want = pfq.paged_flash_qblock_ref(qc, kc, vc, row, pos0, ks, vs)
        torch.cuda.synchronize()
        errs = [check_close(f"qblock-{kvd} C {C} from 0", got, want,
                            TOL_QBLOCK)]
        fault_control(f"qblock-{kvd} next page's scales",
                      pfq.paged_flash_qblock(qc, kc, vc, row, pos0, **bad),
                      want, TOL_QBLOCK)
        qv = torch.randn(S, SPEC_K, H, HD, generator=g, **bf)
        posv = (kv_len[:, None] + torch.arange(
            SPEC_K, dtype=torch.int32, device=dev)[None]).contiguous()
        got = pfq.paged_flash_qblock(qv, kc, vc, table, posv, **sc)
        want = pfq.paged_flash_qblock_ref(qv, kc, vc, table, posv, ks, vs)
        torch.cuda.synchronize()
        errs.append(check_close(f"qblock-{kvd} verify K {SPEC_K}", got,
                                want, TOL_QBLOCK))
        v_ms = time_ms(lambda: pfq.paged_flash_qblock(qv, kc, vc, table,
                                                      posv, **sc))
        pages = math.ceil(C / PAGE)
        nbytes = (2 * qc.numel() * 2 + C * KV * HD * 2 + pages * KV * 4 * 2
                  + C * 4 + pages * 4)
        flops = 4 * H * HD * (C * (C + 1) / 2)
        k_ms = time_ms(lambda: pfq.paged_flash_qblock(qc, kc, vc, row, pos0,
                                                      **sc))
        p_ms = time_ms(lambda: pfq.paged_flash_qblock_ref(
            qc, kc, vc, row, pos0, ks, vs))
        b_ms, b_by = bound(nbytes, flops)
        print(f"[qblock-{kvd}] 512-query chunk: kernel_ms {k_ms:.4f} "
              f"plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); verify "
              f"block {S} x {SPEC_K}: kernel_ms {v_ms:.4f}")
        out[f"qblock-{kvd}"] = dict(err=max(errs), ms=k_ms, plain_ms=p_ms,
                                    bound_ms=b_ms, bound_by=b_by)
        del kc, vc, ks, vs
    torch.cuda.empty_cache()
    return out


def quant_write_case(mb, kvd, lens, table, dev, seed, *, shift=False):
    """Layer 0's write task of ``mb`` alone, on the card and through the
    plain ``_quant_store_token`` sequence, from the same seeded K/V rows
    (written into the arena's K and V regions) over pages holding seeded
    codes and scales. ``shift``: the plain run reads the table row
    shifted by one page (the planted fault). Returns (kernel pools,
    plain pools) as [K codes, K scales, V codes, V scales], and the
    write task's time alone."""
    from triton_dist_tpu_torch.megakernel.task import TaskType

    cfg = mb.cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    arena = torch.zeros(mb.arena_rows, mb.w, device=dev,
                        dtype=torch.bfloat16)
    o = mb._offsets
    arena[o["l0.k_norm"]] = 1.0
    for name in ("l0.k", "l0.v"):
        rows = mb.kv_tiles * mb.batch
        arena[o[name]:o[name] + rows] = torch.randn(
            rows, mb.w, generator=g, device=dev, dtype=torch.bfloat16)
    num_pages = int(np.max(table)) + 2
    kc, vc, ks, vs = quant_pools(dev, kvd, num_pages,
                                 cfg.num_key_value_heads, mb.page,
                                 cfg.head_dim, seed)
    L = cfg.num_hidden_layers

    def pool(codes):        # (N, KV, page, hd) -> (L, N, page, KV, hd)
        return codes.transpose(1, 2).unsqueeze(0).expand(
            L, *codes.transpose(1, 2).shape).contiguous()

    pools = [pool(kc), ks[None].expand(L, *ks.shape).contiguous(),
             pool(vc), vs[None].expand(L, *vs.shape).contiguous()]
    plain = [t.clone() for t in pools]
    wk = next(t.task_id for t in mb.graph.tasks
              if t.task_type in (TaskType.WRITE_KV, TaskType.WRITE_KV_CHUNK,
                                 TaskType.WRITE_KV_QBLOCK))
    one = mb.isolate([wk])
    toks = np.zeros(mb.batch, np.int32)
    one.step(arena, pools[0], pools[2], toks, lens, table,
             k_scale=pools[1], v_scale=pools[3])
    ptable = np.roll(table, 1) if shift else table
    one.plain_step(arena.clone(), plain[0], plain[2], toks, lens, ptable,
                   k_scale=plain[1], v_scale=plain[3])
    torch.cuda.synchronize()
    scratch = [t.clone() for t in pools]
    t_ms = time_events(lambda: one.launch(
        arena, scratch[0], scratch[2], toks, lens, table,
        k_scale=scratch[1], v_scale=scratch[3]), reps=3)
    return pools, plain, t_ms


def codes_close(label, pools, plain, steps=1, scale_rtol=1e-6) -> bool:
    """Codes within ``steps`` steps of the plain ones (int8: 1; fp8: one
    unit of last place, 2**-3 of the value, 2**-9 at the smallest) and
    scales within ``scale_rtol`` relative; prints and returns whether."""
    worst_c, worst_s = 0.0, 0.0
    ok = True
    for i in (0, 2):
        d = (pools[i].float() - plain[i].float()).abs()
        step = (torch.ones_like(d) if pools[i].dtype == torch.int8 else
                (plain[i].float().abs() * 2.0 ** -3).clamp(min=2.0 ** -9))
        worst_c = max(worst_c, float((d / step).max()))
        rel = float(((pools[i + 1] - plain[i + 1]).abs()
                     / plain[i + 1]).max())
        worst_s = max(worst_s, rel)
        ok = ok and bool((d <= steps * step).all()) and rel <= scale_rtol
    print(f"[{label}] codes within {worst_c:.2f} steps (limit {steps}), "
          f"scales within {worst_s:.2e} relative (limit {scale_rtol}): "
          f"{'ok' if ok else 'OUTSIDE'}")
    return ok


# Whole quantized steps: dequantized pools against the plain run's, as a
# fraction of each page's max-abs (int8: 12.7 codes; fp8: 3.5 steps of
# its top binade, whose step is 32/448 = 0.071 of the max-abs).
TOL_STEP_POOLS = {torch.int8: 0.1, torch.float8_e4m3fn: 0.25}


def dequant_close(label, pools, plain) -> bool:
    """Whole quantized steps: the dequantized pools within TOL_STEP_POOLS
    of each (layer, page, head)'s max-abs (the plain run's scale x
    qmax). The K rows the kernel and the plain run quantize differ by
    the bf16 units of the projections before them, so their running
    scales grow at different tokens and the page's codes are rounded a
    different number of times (measured: 5 int8 codes, 4 % of max-abs,
    in a 128-row chunk, and 0.11 of the max-abs in fp8, 1.5 of its top
    steps); a row written at a wrong page, position or head is off by the
    order of the max-abs."""
    worst = 0.0
    tol = TOL_STEP_POOLS[pools[0].dtype]
    for i in (0, 2):
        qmax = 127.0 if pools[i].dtype == torch.int8 else 448.0
        deq = [p[i].float() * p[i + 1][:, :, None, :, None]
               for p in (pools, plain)]
        amax = plain[i + 1][:, :, None, :, None] * qmax
        worst = max(worst, float(((deq[0] - deq[1]).abs() / amax).max()))
    ok = worst <= tol
    print(f"[{label}] dequantized pools within {worst:.4f} of each page's "
          f"max-abs (limit {tol}): {'ok' if ok else 'OUTSIDE'}")
    return ok


def mk_quant_write_phase():
    """Phase 20: the megakernel's quantized write task alone at Qwen3-8B
    widths (2 layers), in decode, chunk and Q-block rows, held to the
    plain ``_quant_store_token`` sequence on the same inputs."""
    from triton_dist_tpu_torch import ModelConfig
    from triton_dist_tpu_torch.megakernel import builder as mkb
    from triton_dist_tpu_torch.ops.chunked_prefill import chunk_row_codes

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(ModelConfig.qwen3_8b(), num_hidden_layers=2)
    kw = dict(max_len=2048, t_tile=128, paged=True, page=128)
    p_max = 2048 // 128
    rng = np.random.RandomState(20)
    perm = (rng.permutation(4 * p_max) + 1).astype(np.int32)
    out = {}
    for kvd in KV_QUANT:
        # Decode: a parked row on the scratch page, one at a page's first
        # offset over a page holding a stale scale (a freed page reused),
        # two mid-page.
        mb = mkb.ModelBuilder(cfg, batch=4, kv_quant=kvd, **kw)
        table = perm.copy()
        table[:p_max] = 0
        cases = [("decode", mb, np.array([0, 1024, 700, 130], np.int32),
                  table)]
        for c, start, valid in ((512, 0, 512), (100, 130, 100)):
            mb = mkb.ModelBuilder(cfg, batch=c, seq=c, chunk=True,
                                  kv_quant=kvd, **kw)
            cases.append((f"chunk {c} from {start}", mb,
                          chunk_row_codes(start, c, valid, 0),
                          perm[p_max:2 * p_max]))
        mb = mkb.ModelBuilder(cfg, batch=4 * SPEC_K, seq=SPEC_K, qblock=True,
                              kv_quant=kvd, **kw)
        pos = np.concatenate([np.array(MK_LENS)[:, None] + np.arange(SPEC_K)]
                             ).reshape(-1).astype(np.int32)
        pos[:SPEC_K] = -1                     # the parked slot: masked
        pos[2 * SPEC_K - 1] = -1              # an over-budget candidate
        cases.append(("qblock 4 x 4", mb, pos, table))
        for label, mb, lens, tbl in cases:
            pools, plain, t_ms = quant_write_case(mb, kvd, lens, tbl, dev,
                                                  20)
            print(f"[mk-quant-write] {kvd} {label}: write task alone "
                  f"{t_ms:.4f} ms (one layer, K and V)")
            if not codes_close(f"mk-quant-write {kvd} {label}", pools,
                               plain, steps=WRITE_STEPS[kvd]):
                fail(f"megakernel quantized write ({kvd}, {label}) strays "
                     "from the plain sequence")
            out[f"{kvd} {label}"] = t_ms
        # The planted fault: the plain run's table row shifted by a page.
        label, mb, lens, tbl = cases[1]
        pools, plain, _ = quant_write_case(mb, kvd, lens, tbl, dev, 20,
                                           shift=True)
        if codes_close(f"mk-quant-write {kvd} {label} shifted table (fault)",
                       pools, plain, steps=WRITE_STEPS[kvd]):
            fail(f"the quantized write limits miss a shifted table ({kvd})")
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_attention():
    """The layer lane's paged attention through the plain versions: the
    plain run the quantized kernels' served logits are held against."""
    from triton_dist_tpu_torch.models import dense
    from triton_dist_tpu_torch.ops import paged_flash_decode as pfd
    from triton_dist_tpu_torch.ops import paged_flash_qblock as pfq

    saved = dense.paged_flash_decode, dense.paged_flash_qblock
    dense.paged_flash_decode = (
        lambda q, kp, vp, bt, n, k_scale=None, v_scale=None, axis=None:
        pfd.paged_flash_decode_ref(q, kp, vp, bt, n, k_scale, v_scale))
    dense.paged_flash_qblock = (
        lambda q, kp, vp, bt, pos, k_scale=None, v_scale=None:
        pfq.paged_flash_qblock_ref(q, kp, vp, bt, pos, k_scale, v_scale))
    try:
        yield
    finally:
        dense.paged_flash_decode, dense.paged_flash_qblock = saved


@contextlib.contextmanager
def plain_megakernel():
    """Every megakernel launch through the plain interpreter instead."""
    from triton_dist_tpu_torch.megakernel import builder as mkb

    saved = mkb.ModelBuilder.step
    mkb.ModelBuilder.step = (
        lambda self, *a, timeout_s=None, **kw: self.plain_step(*a, **kw))
    try:
        yield
    finally:
        mkb.ModelBuilder.step = saved


def spec_prompts(cfg, seed):
    """Four prompts: two repetitive (a drafted continuation is found in
    the prompt), two random, all within one 128-row chunk."""
    rng = np.random.RandomState(seed)
    motif = [int(t) for t in rng.randint(0, cfg.vocab_size, 9)]
    return ([motif * 8, (motif[:5] * 20)[:96]]
            + [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (120, 40)])


def judge_tokens(label, got, want, ref_logits) -> int:
    """Tokens of a run against a reference run of the same lane: a
    request's first divergence must sit at a step whose reference top-2
    logits lie within TOL_MOE_TIE bf16 units (a unit at the larger); the
    rest of that request follows from it. Returns the diverged count."""
    n = 0
    for i, (g, w) in enumerate(zip(got, want)):
        j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            if len(g) != len(w):
                fail(f"{label}: request {i} has {len(g)} tokens, the "
                     f"reference {len(w)}")
            continue
        n += 1
        top2_near_tie(label, i, j, ref_logits[(i, j)])
    print(f"[{label}] {n} of {len(got)} requests diverge, each at a "
          "near-tie")
    return n


def top2_near_tie(label, i, j, logits) -> None:
    """Fail unless request ``i``'s reference logits at step ``j`` have
    their top two within TOL_MOE_TIE bf16 units (a unit at the larger)."""
    row = np.sort(np.asarray(logits, np.float64))
    unit = 2.0 ** (math.floor(math.log2(max(abs(row[-1]), 2.0 ** -126))) - 7)
    gap = (row[-1] - row[-2]) / unit
    print(f"[{label}] request {i} diverges at step {j}: reference top-2 gap "
          f"{gap:.2f} bf16 units (near-tie limit {TOL_MOE_TIE})")
    if gap > TOL_MOE_TIE:
        fail(f"{label}: request {i} diverges from the reference at step {j}, "
             f"{gap:.2f} bf16 units from a tie")


def serve_run(label, srv, prompts, gen, steps=(), force=None):
    """Serve ``prompts`` for ``gen`` tokens with the counts set to zero
    just before; returns (tokens, launches, stats, logits by (request
    index, step) for ``steps``). ``force``: tokens by (request index,
    step) that replace the greedy picks (the plain run of a parity check
    takes the kernel run's tokens, so both compute on the same inputs)."""
    seen = record_logits(srv, set(steps))
    index = {}
    if force:
        pick = srv._pick

        def forced(row, req, step):
            tok = pick(row, req, step)
            return force.get((index[req.request_id], step), tok)

        srv._pick = forced
    zero_counts()
    t0 = time.perf_counter()
    hs = [srv.submit(p, max_new_tokens=gen) for p in prompts]
    index.update({h.request.request_id: i for i, h in enumerate(hs)})
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    st = srv.stats()
    toks = [h.tokens for h in hs]
    if [len(t) for t in toks] != [gen] * len(prompts) or not all(
            0 <= t < srv.cfg.vocab_size for o in toks for t in o):
        fail(f"{label}: requests did not finish with {gen} in-range tokens")
    ids = {h.request.request_id: i for i, h in enumerate(hs)}
    logits = {(ids[r], s): v for (r, s), v in seen.items()}
    spec = st.get("spec") or {}
    print(f"[{label}] {wall:.2f} s; {st['decode_dispatches']} decode "
          f"dispatches, {st['prefill_chunks']} chunks; decode "
          f"{st['tokens_per_s']:.1f} tokens/s, "
          f"{st['decode_dispatches'] / max(st['decode_tokens'], 1):.3f} "
          f"dispatches per token; acceptance "
          f"{spec.get('accept_rate')}; pool {st['kv_dtype']} "
          f"{st['kv_bytes_per_token']:.0f} B/token, "
          f"{st['plan']['pool_bytes_per_rank'] / 2**20:.1f} MiB for "
          f"{st['plan']['num_pages']} pages, capacity x"
          f"{st['plan']['capacity_ratio_vs_native']} of bf16; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return toks, launches, st, logits


def agreement(got, want) -> float:
    """Greedy-token agreement of two runs (``compare_greedy``'s rule)."""
    n = [min(len(g), len(w)) for g, w in zip(got, want)]
    return sum(sum(a == b for a, b in zip(g[:k], w[:k]))
               for g, w, k in zip(got, want, n)) / max(sum(n), 1)


def logit_gap(got, want, got_toks, want_toks) -> float:
    """Largest logit difference at step 1 (the first decode) of the
    requests whose first token agrees."""
    keys = [k for k in want if k[1] == 1 and k in got
            and got_toks[k[0]][0] == want_toks[k[0]][0]]
    return max((float(np.abs(got[k] - want[k]).max()) for k in keys),
               default=float("nan"))


def taken(toks) -> dict:
    """A run's tokens by (request index, step), for ``serve_run(force=)``."""
    return {(i, j): t for i, ts in enumerate(toks) for j, t in enumerate(ts)}


def expect_launches(label, launches, want) -> None:
    """Exact launch counts: every key of ``want`` equal, every other
    counter zero."""
    bad = {k: (v, want.get(k, 0)) for k, v in launches.items()
           if v != want.get(k, 0)}
    if bad or not any(want.values()):
        fail(f"{label}: launch counts (got, want) {bad}")


def quant_layer_parity(cfg_full, label, layers=2):
    """The layer lane's quantized served logits (first two tokens) against
    the plain quantized run on the same weights, at ``layers`` layers."""
    from triton_dist_tpu_torch import Engine

    cfg = dataclasses.replace(cfg_full, num_hidden_layers=layers)
    eng = Engine(cfg, device="cuda", dtype=torch.bfloat16, max_len=2048,
                 seed=21)
    prompts = spec_prompts(cfg, 21)[1:3]
    worst = {}
    for kvd in KV_QUANT:
        kw = dict(num_slots=4, page=32, prefill_buckets=(128,), kv_dtype=kvd)
        toks, _, _, got = serve_run(f"{label}-parity {kvd} kernels",
                                    eng.serving(**kw), prompts, 2,
                                    steps=(0, 1))
        with plain_attention():
            want = serve_run(f"{label}-parity {kvd} plain",
                             eng.serving(**kw), prompts, 2, steps=(0, 1),
                             force=taken(toks))[3]
        err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        print(f"[{label}-parity] {kvd}: served vs plain quantized logits "
              f"max |d| {err:.4f} (limit {TOL_QUANT_LOGITS[kvd]}) at "
              f"{layers} layers")
        if not err <= TOL_QUANT_LOGITS[kvd]:
            fail(f"{label}: quantized served logits stray from the plain "
                 f"run ({kvd}: {err})")
        worst[kvd] = err
    del eng
    torch.cuda.empty_cache()
    return worst


def quant_spec_serve_phase():
    """Phase 21: Qwen3-8B at full depth (phase 3's weights, seed 0) on
    both lanes, with kv_dtype int8 and fp8 and with spec_k=4: tokens,
    exact launches of every new kernel form, and the plain-run parity of
    the quantized logits (2 layers)."""
    from triton_dist_tpu_torch import Engine, ModelConfig, ServingEngine
    from triton_dist_tpu_torch.megakernel import MegaKernelEngine

    cfg = ModelConfig.qwen3_8b()
    L = cfg.num_hidden_layers
    prompts = spec_prompts(cfg, 0)
    gen = 32
    runs = {"bf16": {}, "int8": dict(kv_dtype="int8"),
            "fp8": dict(kv_dtype="fp8"),
            "spec": dict(spec_k=SPEC_K, spec_ngram=SPEC_NGRAM)}
    out = {"layer": {}, "mega": {}}

    eng = Engine(cfg, device="cuda", dtype=torch.bfloat16, max_len=2048,
                 seed=0)
    eng.serving(num_slots=4, page=32, prefill_buckets=(128,)).generate(
        [[7] * 40], max_new_tokens=2)                 # warm-up
    res = {}
    for name, kw in runs.items():
        srv = eng.serving(num_slots=4, page=32, prefill_buckets=(128,), **kw)
        res[name] = serve_run(f"q-layer {name}", srv, prompts, gen,
                              steps=range(gen) if name == "bf16" else (1,))
        toks, launches, st, _ = res[name]
        d, c = st["decode_dispatches"], st["prefill_chunks"]
        kv = kw.get("kv_dtype")
        want = ({"qblock": L * (c + d)} if name == "spec" else
                {f"decode-{kv}": L * d, f"qblock-{kv}": L * c} if kv else
                {"decode": L * d, "qblock": L * c})
        expect_launches(f"q-layer {name}", launches, want)
    base, _, _, ref = res["bf16"]
    for kvd in KV_QUANT:
        print(f"[q-layer {kvd}] greedy agreement with bf16 pools "
              f"{agreement(res[kvd][0], base):.3f}; first-decode logit gap "
              f"to bf16 pools "
              f"{logit_gap(res[kvd][3], ref, res[kvd][0], base):.4f} (the JAX "
              f"CPU battery's bound {JAX_CPU_BOUND[kvd]}, not gated)")
    judge_tokens("q-layer spec vs non-spec", res["spec"][0], base, ref)
    out["layer"] = {k: v[1] for k, v in res.items()}
    del eng
    torch.cuda.empty_cache()
    out["layer_parity"] = quant_layer_parity(cfg, "q-layer")

    res, timed = {}, {}
    for name, kw in runs.items():
        eng = MegaKernelEngine(cfg, batch=4, max_len=2048, t_tile=128,
                               paged=True, page=128, num_pages=1 + 4 * 16,
                               device="cuda", dtype=torch.bfloat16, seed=0,
                               prefill_buckets=(128,),
                               kv_dtype=kw.get("kv_dtype", "bf16"),
                               spec_k=kw.get("spec_k", 0))
        skw = dict(kw, prefill_buckets=(128,))
        ServingEngine(eng, **skw).generate([[7] * 3], max_new_tokens=2)
        res[name] = serve_run(f"q-mega {name}", ServingEngine(eng, **skw),
                              prompts, gen,
                              steps=range(gen) if name == "bf16" else (1,))
        _, launches, st, _ = res[name]
        d, c = st["decode_dispatches"], st["prefill_chunks"]
        kv = kw.get("kv_dtype")
        suffix = f"-{kv}" if kv else ""
        want = {"megakernel": d + c, f"mk_chunk{suffix}": c,
                (f"mk_qblock" if name == "spec" else f"mk_decode{suffix}"): d}
        expect_launches(f"q-mega {name}", launches, want)
        if name != "bf16":
            timed.update(mk_form_times(
                eng, ("qblock",) if name == "spec" else ("decode", "chunk")))
        del eng
        torch.cuda.empty_cache()
    base, _, _, ref = res["bf16"]
    for kvd in KV_QUANT:
        print(f"[q-mega {kvd}] greedy agreement with bf16 pools "
              f"{agreement(res[kvd][0], base):.3f}; first-decode logit gap "
              f"to bf16 pools "
              f"{logit_gap(res[kvd][3], ref, res[kvd][0], base):.4f} (the JAX "
              f"CPU battery's bound {JAX_CPU_BOUND[kvd]}, not gated)")
    judge_tokens("q-mega spec vs non-spec", res["spec"][0], base, ref)
    out["mega"] = {k: v[1] for k, v in res.items()}
    out["mega_timed"] = timed
    out["mega_errs"], out["mega_parity"] = quant_mega_parity(cfg)
    return out


def mk_history(eng, seed) -> None:
    """Seeded history in an engine's pools: bf16 values, or codes and
    scales as the plain writer leaves them."""
    dev = eng.device
    L, n, page, kv, hd = eng.k_cache.shape
    if eng.k_scale is None:
        g = torch.Generator(device=dev).manual_seed(seed)
        for pool in (eng.k_cache, eng.v_cache):
            pool.copy_(torch.randn(pool.shape, generator=g, device=dev,
                                   dtype=pool.dtype))
        return
    for li in range(L):
        kc, vc, ks, vs = quant_pools(dev, eng.kv_dtype, n, kv, page, hd,
                                     seed + li)
        eng.k_cache[li] = kc.transpose(1, 2)
        eng.v_cache[li] = vc.transpose(1, 2)
        eng.k_scale[li], eng.v_scale[li] = ks, vs


def mk_forms(eng, forms, seed):
    """Launch inputs of an engine's new forms, over a shuffled table
    (row 0 parked on the scratch page) and the rows of MK_LENS: "decode"
    (4 rows), "chunk" (128 rows of slot 1 from 0) and "qblock" (K = 4
    candidates per slot at MK_LENS + j, the parked slot's rows and the
    last slot's last candidate masked). Returns [(form, build, tokens,
    per-row values, table, rows that carry logits)]."""
    from triton_dist_tpu_torch.ops.chunked_prefill import chunk_row_codes

    dev = eng.device
    _, _, toks, lens, table = mk_inputs(eng.builder, eng.num_pages, dev, seed)
    p_max = eng.builder.p_max
    out = []
    if "decode" in forms:
        out.append(("decode", eng.builder, toks, lens, table,
                    np.ones(4, bool)))
    if "chunk" in forms:
        out.append(("chunk", eng.chunk_builders[128], np.repeat(toks, 32),
                    chunk_row_codes(0, 128, 128, 0),
                    table[p_max:2 * p_max], np.ones(128, bool)))
    if "qblock" in forms:
        pos = (np.array(MK_LENS)[:, None] + np.arange(SPEC_K)).reshape(-1)
        pos[:SPEC_K] = -1
        pos[-1] = -1
        pos = pos.astype(np.int32)
        out.append(("qblock", eng.verify_builder, np.repeat(toks, SPEC_K),
                    pos, table, pos >= 0))
    return out


def form_key(form, eng) -> str:
    return form + ("" if eng.k_scale is None else f"-{eng.kv_dtype}")


def mk_form_times(eng, forms):
    """Kernel, plain and bound times of an engine's new launch forms (see
    ``mk_forms``) at its depth, over the history its serving left."""
    sc = {} if eng.k_scale is None else dict(k_scale=eng.k_scale,
                                             v_scale=eng.v_scale)
    cnt = {} if eng.counts is None else dict(counts=eng.counts)
    out = {}
    for form, mb, t, ln, tb, _ in mk_forms(eng, forms, 4):
        key = form_key(form, eng)
        host = mb._host_inputs(eng.k_cache, t, ln, tb)
        k_ms = time_events(lambda: mb.launch(eng.arena, eng.k_cache,
                                             eng.v_cache, *host, **sc,
                                             **cnt), reps=5)
        p_ms = time_events(lambda: mb.plain_step(eng.arena, eng.k_cache,
                                                 eng.v_cache, t, ln, tb,
                                                 **sc, **cnt),
                           reps=1, warmup=0)
        b_ms, b_by = mk_step_bound(mb, ln)
        print(f"[mk-step {key}] {eng.cfg.num_hidden_layers} layers: "
              f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms "
              f"{b_ms:.4f} ({b_by})")
        out[key] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    return out


def mk_form_check(eng, forms, label):
    """Each new form of a 2-layer engine on the card and through the
    plain interpreter from the same seeded state: logits within phase 5's
    limits (a MoE build's plain run routes as the kernel did, its routing
    then judged by phase 14's rule against a free plain run); quantized
    pools by ``dequant_close``. Returns the largest logit error by
    form."""
    errs = {}
    for form, mb, t, ln, tb, rows in mk_forms(eng, forms, 5):
        key = form_key(form, eng)
        mk_history(eng, 5)
        state = [x.clone() if x is not None else None
                 for x in (eng.arena, eng.k_cache, eng.v_cache, eng.k_scale,
                           eng.v_scale, eng.counts)]
        free = [x.clone() if x is not None else None for x in state]
        sc = {} if eng.k_scale is None else dict(k_scale=eng.k_scale,
                                                 v_scale=eng.v_scale)
        got = mb.step(eng.arena, eng.k_cache, eng.v_cache, t, ln, tb,
                      counts=eng.counts, **sc)
        a2, k2, v2, ks2, vs2, c2 = state
        psc = {} if ks2 is None else dict(k_scale=ks2, v_scale=vs2)
        want = mb.plain_step(a2, k2, v2, t, ln, tb, counts=c2, **psc,
                             route_from=eng.arena if mb.moe else None)
        torch.cuda.synchronize()
        rows_t = torch.as_tensor(rows, device=got.device)
        errs[key] = check_close(f"{label} {key} logits", got[rows_t],
                                want[rows_t], TOL_MK_LOGITS)
        rel = row_rms(got[rows_t], want[rows_t])
        print(f"[{label} {key}] worst row RMS error / RMS logits "
              f"{rel.max().item():.2e} (tol {TOL_MK_ROW_RMS})")
        if not bool((rel <= TOL_MK_ROW_RMS).all()):
            fail(f"{label} {key}: a row's logits stray from the plain run")
        if eng.k_scale is not None and not dequant_close(
                f"{label} {key} pools",
                [eng.k_cache, eng.k_scale, eng.v_cache, eng.v_scale],
                [k2, ks2, v2, vs2]):
            fail(f"{label} {key}: pools stray from the plain run")
        if mb.moe:
            fa, fk, fv, fks, fvs, fc = free
            fsc = {} if fks is None else dict(k_scale=fks, v_scale=fvs)
            mb.plain_step(fa, fk, fv, t, ln, tb, counts=fc, **fsc)
            got_r, want_r = mb.routed_experts(eng.arena), \
                mb.routed_experts(fa)
            flip_rows = {
                f"row {r}": [(ids_of(got_r[li, r]), ids_of(want_r[li, r]),
                              router_logits(mb, eng.arena, r)[li],
                              router_logits(mb, fa, r)[li])
                             for li in range(mb.cfg.num_hidden_layers)]
                for r in np.nonzero(rows)[0]}
            judge_flips(f"{label} {key} routing", flip_rows,
                        mb.cfg.num_experts_per_tok,
                        len(flip_rows) * mb.cfg.num_hidden_layers)
    return errs


def quant_mega_parity(cfg_full, layers=2):
    """At 2 layers: every new megakernel form against its plain
    interpreter (``mk_form_check``: int8 and fp8 decode, chunk and verify
    launches, and the bf16 verify launch), then the quantized lane's
    served logits (first two tokens) against the same serving through
    the plain interpreter, within TOL_QUANT_LOGITS."""
    from triton_dist_tpu_torch import ServingEngine
    from triton_dist_tpu_torch.megakernel import MegaKernelEngine

    cfg = dataclasses.replace(cfg_full, num_hidden_layers=layers)
    mk = dict(batch=4, max_len=2048, t_tile=128, paged=True, page=128,
              num_pages=1 + 4 * 16, device="cuda", dtype=torch.bfloat16,
              seed=21, prefill_buckets=(128,))
    errs = {}
    for kvd in ("bf16",) + KV_QUANT:
        eng = MegaKernelEngine(cfg, kv_dtype=kvd, spec_k=SPEC_K, **mk)
        errs.update(mk_form_check(
            eng, ("qblock",) if kvd == "bf16" else ("decode", "chunk",
                                                    "qblock"),
            "q-mega-form"))
        del eng
    prompts = spec_prompts(cfg, 21)[1:3]
    worst = {}
    for kvd in KV_QUANT:
        logits, force = [], None
        for plain in (False, True):
            eng = MegaKernelEngine(cfg, kv_dtype=kvd, **mk)
            srv = ServingEngine(eng, prefill_buckets=(128,), kv_dtype=kvd)
            with (plain_megakernel() if plain else contextlib.nullcontext()):
                toks, _, _, seen = serve_run(
                    f"q-mega-parity {kvd} {'plain' if plain else 'kernel'}",
                    srv, prompts, 2, (0, 1), force=force)
            logits.append(seen)
            force = taken(toks)
            del srv, eng
        err = max(float(np.abs(logits[0][k] - logits[1][k]).max())
                  for k in logits[1])
        print(f"[q-mega-parity] {kvd}: served vs plain-interpreter logits "
              f"max |d| {err:.4f} (limit {TOL_QUANT_LOGITS[kvd]})")
        if not err <= TOL_QUANT_LOGITS[kvd]:
            fail(f"megakernel quantized logits stray from the plain run "
                 f"({kvd}: {err})")
        worst[kvd] = err
    torch.cuda.empty_cache()
    return errs, worst


class SpecRoutes:
    """(slot, position) -> per layer (expert ids, fp32 router logits) of
    the last decode or verify row at that position, on either lane: the
    megakernel's routed experts and router-logit tiles after each
    ``decode_step``/``verify_step``, or the layer lane's ``tp_moe.route``
    calls inside its model's decode and verify steps. A rejected
    candidate's position is computed again with the committed token, so
    the last record of a position is the committed one."""

    def __init__(self, eng):
        self.eng, self.at = eng, {}

    def _mega_rows(self, mb, rows):
        eng = self.eng
        got = mb.routed_experts(eng.arena)
        for r, key in enumerate(rows):
            if key is not None:
                logits = router_logits(mb, eng.arena, r)
                self.at[key] = [(ids_of(got[li, r]), logits[li])
                                for li in range(mb.cfg.num_hidden_layers)]

    def __enter__(self):
        from triton_dist_tpu_torch.layers import tp_moe
        from triton_dist_tpu_torch.megakernel import MegaKernelEngine
        from triton_dist_tpu_torch.models import qwen_moe

        eng = self.eng
        if isinstance(eng, MegaKernelEngine):
            dec, ver = eng.decode_step, eng.verify_step
            self._undo = lambda: (setattr(eng, "decode_step", dec),
                                  setattr(eng, "verify_step", ver))

            def decode_step(toks, lens):
                out = dec(toks, lens)
                lens = np.broadcast_to(np.asarray(lens), (eng.batch,))
                self._mega_rows(eng.builder, [(s, int(lens[s]))
                                              for s in range(eng.batch)])
                return out

            def verify_step(toks, pos):
                out = ver(toks, pos)
                pos = np.asarray(pos).reshape(-1)
                self._mega_rows(eng.verify_builder, [
                    (r // eng.spec_k, int(p)) if p >= 0 else None
                    for r, p in enumerate(pos)])
                return out

            eng.decode_step, eng.verify_step = decode_step, verify_step
            return self
        route, dec, ver = (tp_moe.route, qwen_moe.decode_step_paged,
                           qwen_moe.verify_step_paged)
        calls = []

        def recording(router_w, x, *a, **kw):
            ids, w = route(router_w, x, *a, **kw)
            calls.append((ids.cpu().numpy(),
                          (x.float() @ router_w.float().T).cpu().numpy()))
            return ids, w

        def step(fn, verify):
            def run(params, toks, cache, cfg, **kw):
                lens = cache.lens.cpu().numpy()
                live = cache.live.cpu().numpy()
                k = toks.shape[1] if verify else 1
                rows = [(sl, int(lens[sl]) + j) if live[sl] else None
                        for sl in range(len(lens)) for j in range(k)]
                del calls[:]
                out = fn(params, toks, cache, cfg, **kw)
                for r, key in enumerate(rows):
                    if key is not None:
                        self.at[key] = [(set(ids[r].tolist()), lg[r])
                                        for ids, lg in calls]
                return out
            return run

        tp_moe.route = recording
        qwen_moe.decode_step_paged = step(dec, False)
        qwen_moe.verify_step_paged = step(ver, True)

        def undo():
            tp_moe.route = route
            qwen_moe.decode_step_paged, qwen_moe.verify_step_paged = dec, ver

        self._undo = undo
        return self

    def __exit__(self, *exc):
        self._undo()


def judge_spec_moe(label, got, want, ref_logits, prompts, routes,
                   ref_routes, k) -> int:
    """MoE spec tokens against the non-spec run: a request's first token
    divergence must follow a routing flip at a near-tie (phase 14's rule:
    the first (position, layer) before it whose expert set differs, the
    reference logits of the swapped experts within TOL_MOE_TIE bf16
    units), or, with no flip before it, sit at a near-tie of the
    reference's top-2 logits (``judge_tokens``). Requests sit in slots
    0.. in order on both runs."""
    n = 0
    for i, (g, w) in enumerate(zip(got, want)):
        j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            continue
        n += 1
        n0, flip = len(prompts[i]), None
        for p in range(n0, n0 + j):     # the rows that produced tokens 1..j
            a, b = routes.at.get((i, p)), ref_routes.at.get((i, p))
            for li, ((sa, _), (sb, lb)) in enumerate(zip(a or (), b or ())):
                if sa != sb:
                    flip = (p, li, sa, sb, np.asarray(lb, np.float64))
                    break
            if flip:
                break
        if flip is None:
            top2_near_tie(label, i, j, ref_logits[(i, j)])
            continue
        p, li, sa, sb, ref = flip
        kth = abs(float(np.sort(ref)[-k]))
        unit = 2.0 ** (math.floor(math.log2(max(kth, 2.0 ** -126))) - 7)
        gap = (max(ref[e] for e in sb - sa) - min(ref[e] for e in sa - sb)
               ) / unit
        print(f"[{label}] request {i} diverges at step {j} after a routing "
              f"flip at position {p} layer {li} (reference-only experts "
              f"{sorted(sb - sa)}, spec-only {sorted(sa - sb)}): reference "
              f"gap {gap:.2f} bf16 units (near-tie limit {TOL_MOE_TIE})")
        if gap > TOL_MOE_TIE:
            fail(f"{label}: request {i}'s routing flips at position {p} "
                 f"layer {li} by {gap:.2f} bf16 units, no near-tie")
    print(f"[{label}] {n} of {len(got)} requests diverge, each after a "
          "routing flip at a near-tie or at a near-tie of the logits")
    return n


def moe_quant_spec_phase():
    """Phase 22: Qwen3-30B-A3B cut to 4 layers on both lanes with int8
    pools and spec_k=4, against the same lane without speculation: a
    request's first divergence must be a near-tie of the reference's
    top-2 logits. Then the MoE chunk and verify launches of the int8
    megakernel against its plain interpreter, under phase 14's routing
    rule, at 2 layers (``mk_form_check``)."""
    from triton_dist_tpu_torch import Engine, ServingEngine
    from triton_dist_tpu_torch.megakernel import MegaKernelEngine

    cfg = moe_cfg(4)
    L = cfg.num_hidden_layers
    prompts = spec_prompts(cfg, 22)
    gen = 24
    out = {}
    eng = Engine(cfg, device="cuda", dtype=torch.bfloat16, max_len=2048,
                 seed=0)
    res, routes = {}, {}
    for name, kw in (("int8", {}), ("int8+spec", dict(spec_k=SPEC_K))):
        srv = eng.serving(num_slots=4, page=32, prefill_buckets=(128,),
                          kv_dtype="int8", **kw)
        with SpecRoutes(eng) as routes[name]:
            res[name] = serve_run(f"moe-q-layer {name}", srv, prompts, gen,
                                  steps=range(gen) if not kw else ())
        _, launches, st, _ = res[name]
        d, c = st["decode_dispatches"], st["prefill_chunks"]
        want = ({"qblock-int8": L * (c + d)} if kw else
                {"decode-int8": L * d, "qblock-int8": L * c})
        expect_launches(f"moe-q-layer {name}", launches, want)
    judge_spec_moe("moe-q-layer spec vs non-spec", res["int8+spec"][0],
                   res["int8"][0], res["int8"][3], prompts,
                   routes["int8+spec"], routes["int8"],
                   cfg.num_experts_per_tok)
    out["layer"] = {k: v[1] for k, v in res.items()}
    del eng
    torch.cuda.empty_cache()

    res, routes = {}, {}
    for name, k in (("int8", 0), ("int8+spec", SPEC_K)):
        eng = MegaKernelEngine(cfg, batch=4, max_len=2048, t_tile=128,
                               paged=True, page=128, num_pages=1 + 4 * 16,
                               device="cuda", dtype=torch.bfloat16, seed=0,
                               prefill_buckets=(128,), kv_dtype="int8",
                               spec_k=k)
        skw = dict(prefill_buckets=(128,), kv_dtype="int8", spec_k=k)
        srv = ServingEngine(eng, **skw)
        with SpecRoutes(eng) as routes[name]:
            res[name] = serve_run(f"moe-q-mega {name}", srv, prompts, gen,
                                  steps=range(gen) if not k else ())
        _, launches, st, _ = res[name]
        d, c = st["decode_dispatches"], st["prefill_chunks"]
        want = {"megakernel": d + c, "mk_chunk-int8": c,
                ("mk_qblock-int8" if k else "mk_decode-int8"): d}
        expect_launches(f"moe-q-mega {name}", launches, want)
        if k:
            out["timed"] = mk_form_times(eng, ("chunk", "qblock"))
        del eng
        torch.cuda.empty_cache()
    judge_spec_moe("moe-q-mega spec vs non-spec", res["int8+spec"][0],
                   res["int8"][0], res["int8"][3], prompts,
                   routes["int8+spec"], routes["int8"],
                   cfg.num_experts_per_tok)
    out["mega"] = {k: v[1] for k, v in res.items()}
    eng = MegaKernelEngine(moe_cfg(2), batch=4, max_len=2048, t_tile=128,
                           paged=True, page=128, num_pages=1 + 4 * 16,
                           device="cuda", dtype=torch.bfloat16, seed=22,
                           prefill_buckets=(128,), kv_dtype="int8",
                           spec_k=SPEC_K)
    out["errs"] = mk_form_check(eng, ("chunk", "qblock"), "moe-q-mega-form")
    del eng
    torch.cuda.empty_cache()
    return out


def qwen3_32b_phase():
    """Phase 23 (rider): Qwen3-32B at full width, 8 of its 64 layers, on
    the layer lane with int8 pools: GQA 8 (64/8 heads) through the int8
    forms of rows 15 and 16, launches counted, and the first two served
    tokens' logits (the prefill chunk's, then a decode step's) within 0.1
    of the plain quantized run."""
    from triton_dist_tpu_torch import Engine, ModelConfig

    cfg = dataclasses.replace(ModelConfig.qwen3_32b(), num_hidden_layers=8)
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    eng = Engine(cfg, device="cuda", dtype=torch.bfloat16, max_len=2048,
                 seed=23)
    torch.cuda.synchronize()
    print(f"[q32b] Qwen3-32B at {L} layers on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompts = spec_prompts(cfg, 23)
    kw = dict(num_slots=4, page=32, prefill_buckets=(128,), kv_dtype="int8")
    toks, launches, st, got = serve_run("q32b int8", eng.serving(**kw),
                                        prompts, 8, steps=(0, 1))
    d, c = st["decode_dispatches"], st["prefill_chunks"]
    expect_launches("q32b int8", launches,
                    {"decode-int8": L * d, "qblock-int8": L * c})
    with plain_attention():
        want = serve_run("q32b int8 plain", eng.serving(**kw), prompts, 8,
                         steps=(0, 1), force=taken(toks))[3]
    errs = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
    err = max(errs.values())
    print(f"[q32b] served vs plain quantized logits by (request, step) "
          f"{ {k: round(v, 4) for k, v in sorted(errs.items())} }")
    print(f"[q32b] served vs plain quantized logits max |d| {err:.4f} "
          f"(limit {TOL_QUANT_LOGITS['int8']}), logit std "
          f"{float(np.std(want[(0, 0)])):.3f}")
    if not err <= TOL_QUANT_LOGITS["int8"]:
        fail(f"Qwen3-32B quantized logits stray from the plain run: {err}")
    del eng
    torch.cuda.empty_cache()
    return dict(launches=launches, err=err)


def grid_blocks() -> int:
    from triton_dist_tpu_torch.megakernel import builder as mkb

    return mkb.grid_blocks(0, tensor_cores=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the card")
    import triton_dist_tpu_torch  # noqa: F401 — fails outside a checkout
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_kernels()
    numbers = kernel_phase()
    numbers["megakernel"] = mk_kernel_phase()
    numbers["flash"] = flash_kernel_phase()
    numbers["group_gemm"] = group_gemm_kernel_phase()
    numbers.update(quant_kernel_phase())
    mk_quant_write_phase()
    launches, layer_st, dense_engine = serve_phase()
    parity_phase()
    mk = mk_serve_phase(layer_st)
    mk_parity_phase()
    prompt = mk_prompt_kernel_phase()
    chunk = mk_chunk_serve_phase(layer_st)
    mk_chunk_parity_phase()
    moe = moe_kernel_phase()
    moe_serve = moe_mk_serve_phase()
    moe_engine = moe_layer_serve_phase(moe_serve["held"])
    moe_parity_phase()
    checkpoint_phase()
    q21 = quant_spec_serve_phase()
    q22 = moe_quant_spec_phase()
    q23 = qwen3_32b_phase()

    rows = []
    for key, name, replaces in (
            ("decode", "paged_decode_kernel",
             "triton_dist_tpu/ops/paged_flash_decode.py:118"),
            ("qblock", "paged_qblock_kernel",
             "triton_dist_tpu/ops/paged_flash_qblock.py:81")):
        num = numbers[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/paged_attention.cu",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": num["err"], "ms": num["ms"],
            "plain_ms": num["plain_ms"], "bound_ms": num["bound_ms"],
            "bound_by": num["bound_by"], "library_ms": None})
    # No single PyTorch call computes a megakernel step: library_ms is
    # null. One row per row mode of the one kernel; the chunk row's times
    # are the 512-row chunk from position 0 (the 128-row one is printed).
    for mode, launches_, err, t in (
            ("decode", mk["launches"]["megakernel"],
             numbers["megakernel"]["err"], mk),
            ("chunk", chunk["launches"]["mk_chunk"], prompt["chunk"],
             chunk["timed"][512]),
            ("prefill", prompt["prefill_launches"], prompt["prefill"],
             chunk["timed"]["prefill"])):
        rows.append({
            "name": f"megakernel_kernel[{mode}]", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/megakernel.cu",
            "replaces": "triton_dist_tpu/megakernel/builder.py:1157",
            "launches": launches_, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    # The MoE model's two row modes of the same kernel: decode ticks and
    # 128-row chunks on its serve phase.
    for mode, launches_, err in (
            ("decode", moe_serve["launches"]["mk_decode"], moe["decode"]),
            ("chunk", moe_serve["launches"]["mk_chunk"], moe["chunk"])):
        t = moe_serve["timed"][mode]
        rows.append({
            "name": f"megakernel_kernel[moe-{mode}]", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/megakernel.cu",
            "replaces": "triton_dist_tpu/megakernel/builder.py:1157",
            "launches": launches_, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    # The dense-cache engine's two kernels: launches over phase 16's
    # Engine.serve and monolithic serving runs, dense and MoE; times at
    # the Engine.serve prefill shapes (the grouped GEMM's gate/up launch;
    # its down launch is printed).
    for key, name, source, replaces, t in (
            ("flash", "flash_attention", "flash_attention.cu",
             "triton_dist_tpu/layers/tp_attn.py:182", numbers["flash"]),
            ("group_gemm", "group_gemm_tiles", "group_gemm.cu",
             "triton_dist_tpu/ops/group_gemm.py:51",
             dict(numbers["group_gemm"]["gate/up"],
                  err=numbers["group_gemm"]["err"]))):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"triton_dist_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": sum(run[part][key] for run in (dense_engine,
                                                       moe_engine)
                            for part in ("serve", "mono")),
            "max_abs_err": t["err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # The int8 / fp8 forms of rows 15 and 16: phase 19's numbers (the
    # Q-block's at the 512-query chunk; its verify block is printed);
    # launches over every serving run of phases 21-23.
    served = [*q21["layer"].values(), *q22["layer"].values(),
              q23["launches"]]
    for key, name, replaces in (
            ("decode-int8", "paged_decode_kernel[int8]",
             "triton_dist_tpu/ops/paged_flash_decode.py:118"),
            ("decode-fp8", "paged_decode_kernel[fp8]",
             "triton_dist_tpu/ops/paged_flash_decode.py:118"),
            ("qblock-int8", "paged_qblock_kernel[int8]",
             "triton_dist_tpu/ops/paged_flash_qblock.py:81"),
            ("qblock-fp8", "paged_qblock_kernel[fp8]",
             "triton_dist_tpu/ops/paged_flash_qblock.py:81")):
        num = numbers[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/paged_attention.cu",
            "replaces": replaces,
            "launches": sum(run[key] for run in served),
            "max_abs_err": num["err"], "ms": num["ms"],
            "plain_ms": num["plain_ms"], "bound_ms": num["bound_ms"],
            "bound_by": num["bound_by"], "library_ms": None})
    # The megakernel's quantized and Q-block forms: times at full depth
    # (Qwen3-8B, phase 21; Qwen3-30B-A3B at 4 layers, phase 22), errors
    # against the plain interpreter at 2 layers, launches over the
    # serving runs of the same phase.
    # The JAX bodies each form replaces: the quantized write (:338) with
    # the quantized decode attention (:498), the quant branches of the
    # per-row attention (:1073) the chunk rides, the Q-block pair (:956).
    line = {"decode": 338, "chunk": 1073, "qblock": 956}
    for prefix, timed, errs, runs, keys in (
            ("", q21["mega_timed"], q21["mega_errs"], q21["mega"],
             ("decode-int8", "decode-fp8", "chunk-int8", "chunk-fp8",
              "qblock")),
            ("moe-", q22["timed"], q22["errs"], q22["mega"],
             ("chunk-int8", "qblock-int8"))):
        for key in keys:
            t = timed[key]
            rows.append({
                "name": f"megakernel_kernel[{prefix}{key}]", "route": "cuda",
                "source": "triton_dist_tpu_torch/csrc/megakernel.cu",
                "replaces": "triton_dist_tpu/megakernel/kernels.py:"
                            f"{line[key.split('-')[0]]}",
                "launches": sum(run[f"mk_{key}"] for run in runs.values()),
                "max_abs_err": errs[key], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
