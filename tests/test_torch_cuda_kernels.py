"""The port's CUDA kernels against their plain PyTorch versions, on the
card. They have no CPU or interpret mode, so every test here skips
without CUDA. This file imports no JAX; on the card's machine (no JAX)
run it without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Shapes cover the compiled head_dim (128), GQA ratios 1-16, page sizes
that do and do not match the kernels' 32-key tile, a query count that is
not a multiple of the Q-block tile, a parked slot, and positions outside
the row (clamped). Tolerances, as in ``chip_smoke.py``: the outputs are
bf16 and the plain version rounds probabilities to bf16 before P·V where
the kernels keep them in fp32, so decode must lie within
5e-3 + 2**-7 |plain| (one bf16 unit of last place on top of 5e-3) and the
Q-block kernel, whose early queries average few V rows and reach [2, 4),
within 2e-2 + 2**-6 |plain| (two units).

The megakernel (``csrc/megakernel.cu``) is held against its plain
interpreter on the same arena and pools at tile width = head_dim = 128,
2 layers, hidden 256, vocab 1024, an odd batch of 3 with a parked row and
a shuffled block table, paged and dense, static and dynamic claim lists.
Both round every task's output to bf16 but sum in different orders, so a
value may land one bf16 unit of last place away and carry that into
later tasks: the logits must lie within 2e-2 + 2**-6 |plain| and each
row's RMS error within MK_ROW_RMS_TOL of its logits' RMS, the limit
``chip_smoke.py`` holds Qwen3-8B widths to. The absolute limit is five
times smaller than the smoke's 0.1 because the drift grows with the
widths summed over: on an H100 it read at most 3.9e-3 (0.35 % row RMS)
here against 0.047 (0.67 %) at Qwen3-8B widths, while the planted faults
below read 0.41-1.5 (29-140 %). The written K/V rows must lie within
3e-2 + 2**-6 |plain|; every pool row the step did not write must be
unchanged, bit for bit. The same limits must fail the kernel when a
wrong page, position or KV head is planted in its inputs. A wedged wait
(a claim list missing a task) must raise naming the task, in a
subprocess, since the kernel's trap costs the process its CUDA
context.

The prompt row modes are held to the same limits: a prefill chunk of 12,
16 and 64 rows (its LINEAR runs on tensor cores past 8 rows, zero-padding
the rows past the chunk in shared memory) starting mid-page at 40 over
random history, with an attend-only span (positions 40-43 below
``wfrom``) and a dead last row; and batched prefill of 3 slots x 4 rows
(paged, from 32) and 2 x 16 (dense, from 0); a decode batch of 12 rows
(the tensor-core instantiation in decode mode). A chunk writes exactly its
rows with a code >= 0. A page of another slot planted in the chunk's
table row, or every code shifted by one position, must fail the limits.

The MoE pair (Qwen3-MoE builds: 16 query heads per 2 KV heads, GQA 8,
100 experts < the 128-column router tile, top-8, expert ffn 128):
``MOE_WEIGHTS`` run alone on an identical planted logit tile (exact
ties, masked columns holding the largest logits, an all-equal row),
with and without renormalisation, must select exactly the plain
version's experts, give their weights within one bf16 unit, and count
exactly, 300 launches deep (past the 256 at which a bf16 counter would
stop adding 1). ``WEIGHTED_ADD`` alone, first writing then accumulating,
at 4, 12 and 128 rows, within one bf16 unit. The whole MoE step (decode
and a 16-row chunk) is held to the megakernel limits on every row
against the plain interpreter run under the kernel's routing (its
router-logit tiles: a logit one bf16 unit off moves an expert's whole
combine weight by about 1 % and may swap a near-tied 8th and 9th
expert, which is no fault), with counters equal; against the
free-running plain run the (layer, row) pairs whose expert set differs
are counted, at most 15 % of them (at least 2), as in
``chip_smoke.py``."""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from triton_dist_tpu_torch.megakernel import builder as mkb
from triton_dist_tpu_torch.models import ModelConfig, dense
from triton_dist_tpu_torch.ops import ag_moe, group_gemm
from triton_dist_tpu_torch.ops import flash_attention as fa
from triton_dist_tpu_torch.ops import paged_flash_decode as pfd
from triton_dist_tpu_torch.ops import paged_flash_qblock as pfq

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda", torch.cuda.current_device())


def _pool(dev, seed, b, kvh, page, hd, p_max):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = 1 + b * p_max
    bf = dict(device=dev, dtype=torch.bfloat16)
    kp = torch.randn(n, kvh, page, hd, generator=g, **bf)
    vp = torch.randn(n, kvh, page, hd, generator=g, **bf)
    tbl = (torch.randperm(n - 1, generator=g, device=dev) + 1)
    return kp, vp, tbl.view(b, p_max).to(torch.int32).contiguous(), g


DECODE_TOL = (5e-3, 2.0 ** -7)
QBLOCK_TOL = (2e-2, 2.0 ** -6)


def _assert_close(got, want, tol):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    diff = (got.float() - want.float()).abs()
    bound = tol[0] + tol[1] * want.float().abs()
    assert bool((diff <= bound).all()), float(diff.max())


HD = 128


@pytest.mark.parametrize("rep,page", [(1, 8), (4, 32), (16, 16), (2, 64),
                                      (8, 32)])
def test_decode_kernel_matches_plain(dev, rep, page):
    kvh, b, p_max = 2, 5, 6
    kp, vp, tbl, g = _pool(dev, rep, b, kvh, page, HD, p_max)
    tbl[0] = 0                                            # parked
    cap = p_max * page
    lens = torch.tensor([1, page, page + 1, cap, 3 * page - 5],
                        dtype=torch.int32, device=dev)
    q = torch.randn(b, kvh * rep, HD, generator=g, device=dev,
                    dtype=torch.bfloat16)
    before = pfd.KERNEL.launches
    got = pfd.paged_flash_decode(q, kp, vp, tbl, lens)
    assert pfd.KERNEL.launches == before + 1
    _assert_close(got, pfd.paged_flash_decode_ref(q, kp, vp, tbl, lens),
                  DECODE_TOL)


@pytest.mark.parametrize("rep,page,c", [(1, 8, 5), (4, 32, 37), (8, 16, 64),
                                        (2, 64, 9), (8, 32, 128)])
def test_qblock_kernel_matches_plain(dev, rep, page, c):
    kvh, b, p_max = 2, 3, 5
    kp, vp, tbl, g = _pool(dev, rep + c, b, kvh, page, HD, p_max)
    tbl[2] = 0                                            # parked
    cap = p_max * page
    pos = torch.randint(-3, cap + 5, (b, c), generator=g, device=dev,
                        dtype=torch.int32)
    pos[0] = torch.arange(c, device=dev) + page - 2       # a chunk
    q = torch.randn(b, c, kvh * rep, HD, generator=g, device=dev,
                    dtype=torch.bfloat16)
    before = pfq.KERNEL.launches
    got = pfq.paged_flash_qblock(q, kp, vp, tbl, pos)
    assert pfq.KERNEL.launches == before + 1
    want = pfq.paged_flash_qblock_ref(
        q, kp, vp, tbl, pos.clamp(max=cap - 1))
    _assert_close(got, want, QBLOCK_TOL)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(dev):
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    for hd in (64, 96):
        kp, vp, tbl, g = _pool(dev, 0, 2, 2, 8, hd, 2)
        q = torch.randn(2, 4, hd, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            pfd.paged_flash_decode(q, kp, vp, tbl, lens)
    kp, vp, tbl, g = _pool(dev, 0, 2, 2, 8, HD, 2)
    q = torch.randn(2, 4, HD, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        pfd.paged_flash_decode(q.float(), kp, vp, tbl, lens)
    with pytest.raises(TypeError):
        pfd.paged_flash_decode(q, kp, vp, tbl, lens.long())
    with pytest.raises(ValueError, match="contiguous"):
        pfd.paged_flash_decode(q, kp.transpose(2, 3).contiguous()
                               .transpose(2, 3), vp, tbl, lens)


MK_CFG = ModelConfig(vocab_size=1024, hidden_size=256, intermediate_size=384,
                     num_hidden_layers=2, num_attention_heads=8,
                     num_key_value_heads=2, head_dim=128)
MK_LOGITS_TOL = (2e-2, 2.0 ** -6)
MK_ROW_RMS_TOL = 2e-2
MK_KV_TOL = (3e-2, 2.0 ** -6)


def _mk_setup(dev, *, paged, schedule, seed=0, b=3):
    max_len, page = 256, 32
    mb = mkb.ModelBuilder(MK_CFG, batch=b, max_len=max_len, t_tile=page,
                          paged=paged, page=page if paged else None,
                          schedule=schedule)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = dense.init_params(MK_CFG, generator=g, device=dev,
                               dtype=torch.bfloat16)
    arena = mb.pack_arena(params, dtype=torch.bfloat16, device=dev)
    L, kv = MK_CFG.num_hidden_layers, MK_CFG.num_key_value_heads
    shape = ((L, 1 + b * mb.p_max, page, kv, 128) if paged
             else (L, b, max_len, kv, 128))
    kc = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    vc = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, MK_CFG.vocab_size, b).astype(np.int32)
    if paged:
        lens = np.array([0, 37, 130], np.int32)     # row 0 parked
        if b > 3:
            lens = np.concatenate([lens, rng.randint(1, 200, b - 3)]).astype(
                np.int32)
        table = (rng.permutation(b * mb.p_max) + 1).astype(np.int32)
        table[:mb.p_max] = 0                        # scratch page
    else:
        lens = np.array([5, 37, 130], np.int32)
        table = None
    return mb, arena, kc, vc, toks, lens, table


def _row_rms(got, want):
    return ((got - want).pow(2).mean(1).sqrt()
            / want.pow(2).mean(1).sqrt())


@pytest.mark.parametrize("paged,schedule", [
    (True, "static"), (True, "dynamic"), (False, "static"),
    (False, "dynamic")])
def test_megakernel_matches_plain(dev, paged, schedule):
    mb, arena, kc, vc, toks, lens, table = _mk_setup(
        dev, paged=paged, schedule=schedule)
    kc0, vc0 = kc.clone(), vc.clone()
    a2, k2, v2 = arena.clone(), kc.clone(), vc.clone()
    before = mkb.KERNEL.launches
    got = mb.step(arena, kc, vc, toks, lens, table)
    assert mkb.KERNEL.launches == before + 1
    want = mb.plain_step(a2, k2, v2, toks, lens, table)
    rel = _row_rms(got, want)
    print(f"[mk-card] paged={paged} {schedule}: max |dlogit| "
          f"{(got - want).abs().max().item():.3e}, row RMS error / RMS "
          f"{[f'{r:.2e}' for r in rel.tolist()]}")
    _assert_close(got, want, MK_LOGITS_TOL)
    assert bool((rel <= MK_ROW_RMS_TOL).all()), rel.tolist()
    _assert_close(kc, k2, MK_KV_TOL)
    _assert_close(vc, v2, MK_KV_TOL)
    written = (k2 != kc0) | (v2 != vc0)
    assert torch.equal(kc[~written], kc0[~written])
    assert torch.equal(vc[~written], vc0[~written])
    # One position per (layer, row, KV head) at most: 2 x 3 x 2 rows.
    assert int(written.any(-1).sum()) <= 2 * 3 * 2


def test_megakernel_wide_decode_matches_plain(dev):
    """A decode batch of 12 rows runs the tensor-core instantiation."""
    mb, arena, kc, vc, toks, lens, table = _mk_setup(
        dev, paged=True, schedule="static", b=12)
    assert mb.uses_tensor_cores
    kc0, vc0 = kc.clone(), vc.clone()
    a2, k2, v2 = arena.clone(), kc.clone(), vc.clone()
    got = mb.step(arena, kc, vc, toks, lens, table)
    want = mb.plain_step(a2, k2, v2, toks, lens, table)
    written = _check_mk(got, want, kc, vc, k2, v2, kc0, vc0)
    assert int(written.any(-1).sum()) <= 2 * 12


@pytest.mark.parametrize("fault", ["page", "position", "head"])
def test_megakernel_limits_catch_a_planted_fault(dev, fault):
    """The kernel on inputs with one fault planted, against the plain
    version on the sound inputs: the limits of the test above fail it."""
    mb, arena, kc, vc, toks, lens, table = _mk_setup(
        dev, paged=True, schedule="static")
    want = mb.plain_step(arena.clone(), kc.clone(), vc.clone(), toks, lens,
                         table)
    if fault == "page":                 # row 2 reads row 1's first page
        table = table.reshape(3, mb.p_max).copy()
        table[2, 0] = table[1, 0]
        table = table.reshape(-1)
    elif fault == "position":           # row 2 one position off
        lens = lens.copy()
        lens[2] += 1
    else:                               # layer 0's two KV heads swapped
        kc[0] = kc[0, :, :, [1, 0]].clone()
        vc[0] = vc[0, :, :, [1, 0]].clone()
    got = mb.step(arena, kc, vc, toks, lens, table)
    diff = (got - want).abs()
    rel = _row_rms(got, want)
    print(f"[mk-card] {fault} fault: max |dlogit| {diff.max().item():.3e}, "
          f"row RMS error / RMS {[f'{r:.2e}' for r in rel.tolist()]}")
    atol, rtol = MK_LOGITS_TOL
    logits_ok = bool((diff <= atol + rtol * want.abs()).all())
    assert not (logits_ok and bool((rel <= MK_ROW_RMS_TOL).all()))


def test_megakernel_wrapper_rejects_what_the_kernel_does_not_take(dev):
    mb, arena, kc, vc, toks, lens, table = _mk_setup(
        dev, paged=True, schedule="static")
    with pytest.raises(TypeError):
        mb.step(arena.float(), kc, vc, toks, lens, table)
    with pytest.raises(ValueError, match="max_len"):
        mb.step(arena, kc, vc, toks, np.array([0, 1, 256]), table)
    wide = mkb.ModelBuilder(MK_CFG, batch=3, max_len=256, t_tile=32,
                            tile_w=256)
    with pytest.raises(ValueError, match="tile width 256"):
        wide.check_kernel_args(arena, kc, vc)


def test_megakernel_wedged_wait_raises(dev):
    """A claim list without the first task (the embedding GATHER) leaves
    its successors waiting: the first bounded wait to run out traps and
    the wrapper raises naming the waiting task and the task it waited on,
    instead of hanging."""
    here = pathlib.Path(__file__).resolve()
    script = textwrap.dedent("""
        import importlib.util, sys
        sys.path.insert(0, %r)
        spec = importlib.util.spec_from_file_location("cuda_tests", %r)
        t = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(t)
        from triton_dist_tpu_torch.megakernel import builder as mkb
        import torch
        dev = torch.device("cuda", 0)
        mb, arena, kc, vc, toks, lens, table = t._mk_setup(
            dev, paged=True, schedule="static")
        mb.claim_list = mb.claim_list[1:]
        try:
            mb.step(arena, kc, vc, toks, lens, table, timeout_s=0.5)
        except mkb.MegakernelTimeoutError as e:
            print("RAISED", e)
    """) % (str(here.parents[1]), str(here))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert "RAISED megakernel wait timed out: task " in out.stdout, out.stderr
    assert "layer" in out.stdout and ") waited on task " in out.stdout


CHUNK_START, CHUNK_WFROM = 40, 44


def _mk_chunk_setup(dev, rows, *, seed=0):
    """A chunk build of ``rows`` rows of slot 1 (a shuffled table row of a
    3-slot pool), random weights and history, codes from position 40 with
    positions 40-43 attend-only and the last row dead."""
    from triton_dist_tpu_torch.ops.chunked_prefill import chunk_row_codes

    max_len, page = 256, 32
    mb = mkb.ModelBuilder(MK_CFG, batch=rows, seq=rows, chunk=True,
                          max_len=max_len, t_tile=page, paged=True, page=page)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = dense.init_params(MK_CFG, generator=g, device=dev,
                               dtype=torch.bfloat16)
    arena = mb.pack_arena(params, dtype=torch.bfloat16, device=dev)
    L, kv = MK_CFG.num_hidden_layers, MK_CFG.num_key_value_heads
    shape = (L, 1 + 3 * mb.p_max, page, kv, 128)
    kc = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    vc = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    rng = np.random.RandomState(seed)
    table = (rng.permutation(3 * mb.p_max) + 1).astype(np.int32).reshape(
        3, mb.p_max)
    toks = rng.randint(0, MK_CFG.vocab_size, rows).astype(np.int32)
    codes = chunk_row_codes(CHUNK_START, rows, rows - 1, CHUNK_WFROM)
    return mb, arena, kc, vc, toks, codes, table


def _check_mk(got, want, kc, vc, k2, v2, kc0, vc0):
    """The megakernel limits of test_megakernel_matches_plain; returns
    the mask of pool rows the plain version wrote."""
    rel = _row_rms(got, want)
    print(f"[mk-card] max |dlogit| {(got - want).abs().max().item():.3e}, "
          f"worst row RMS error / RMS {rel.max().item():.2e}")
    _assert_close(got, want, MK_LOGITS_TOL)
    assert bool((rel <= MK_ROW_RMS_TOL).all()), rel.tolist()
    _assert_close(kc, k2, MK_KV_TOL)
    _assert_close(vc, v2, MK_KV_TOL)
    written = (k2 != kc0) | (v2 != vc0)
    assert torch.equal(kc[~written], kc0[~written])
    assert torch.equal(vc[~written], vc0[~written])
    return written.any(-1)


@pytest.mark.parametrize("rows", [12, 16, 64])
def test_megakernel_chunk_matches_plain(dev, rows):
    mb, arena, kc, vc, toks, codes, table = _mk_chunk_setup(dev, rows)
    kc0, vc0 = kc.clone(), vc.clone()
    a2, k2, v2 = arena.clone(), kc.clone(), vc.clone()
    before = dict(mkb.MODE_LAUNCHES)
    got = mb.step(arena, kc, vc, toks, codes, table[1])
    assert mkb.MODE_LAUNCHES["chunk"] == before["chunk"] + 1
    want = mb.plain_step(a2, k2, v2, toks, codes, table[1])
    written = _check_mk(got, want, kc, vc, k2, v2, kc0, vc0)
    # Exactly the rows with a code >= 0, in every layer and KV head.
    page = mb.page
    expect = torch.zeros_like(written)
    for p in codes[codes >= 0]:
        expect[:, int(table[1][p // page]), int(p % page)] = True
    assert torch.equal(written, expect)


@pytest.mark.parametrize("fault", ["page", "codes"])
def test_megakernel_chunk_limits_catch_a_planted_fault(dev, fault):
    """The chunk kernel on a faulted input against the plain version on
    the sound one: a page of another slot in the table row (the page of
    positions 32-63, which every row attends), or every position shifted
    by one."""
    mb, arena, kc, vc, toks, codes, table = _mk_chunk_setup(dev, 16)
    want = mb.plain_step(arena.clone(), kc.clone(), vc.clone(), toks, codes,
                         table[1])
    row = table[1].copy()
    if fault == "page":
        row[1] = table[2][1]
    else:
        codes = np.where(codes >= 0, codes + 1,
                         np.where(codes == -1, -1, codes - 1)).astype(np.int32)
    got = mb.step(arena, kc, vc, toks, codes, row)
    diff = (got - want).abs()
    rel = _row_rms(got, want)
    print(f"[mk-card] chunk {fault} fault: max |dlogit| "
          f"{diff.max().item():.3e}, worst row RMS error / RMS "
          f"{rel.max().item():.2e}")
    atol, rtol = MK_LOGITS_TOL
    logits_ok = bool((diff <= atol + rtol * want.abs()).all())
    assert not (logits_ok and bool((rel <= MK_ROW_RMS_TOL).all()))


@pytest.mark.parametrize("paged,slots,seq,start", [
    (True, 3, 4, 32), (False, 2, 16, 0)], ids=["paged", "dense"])
def test_megakernel_prefill_matches_plain(dev, paged, slots, seq, start):
    max_len, page = 256, 32
    mb = mkb.ModelBuilder(MK_CFG, batch=slots * seq, seq=seq,
                          max_len=max_len, t_tile=page, paged=paged,
                          page=page if paged else None)
    g = torch.Generator(device=dev).manual_seed(3)
    params = dense.init_params(MK_CFG, generator=g, device=dev,
                               dtype=torch.bfloat16)
    arena = mb.pack_arena(params, dtype=torch.bfloat16, device=dev)
    L, kv = MK_CFG.num_hidden_layers, MK_CFG.num_key_value_heads
    shape = ((L, 1 + slots * mb.p_max, page, kv, 128) if paged
             else (L, slots, max_len, kv, 128))
    kc = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    vc = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    rng = np.random.RandomState(3)
    table = ((rng.permutation(slots * mb.p_max) + 1).astype(np.int32)
             if paged else None)
    toks = rng.randint(0, MK_CFG.vocab_size, slots * seq).astype(np.int32)
    lens = np.full(slots * seq, start, np.int32)
    kc0, vc0 = kc.clone(), vc.clone()
    a2, k2, v2 = arena.clone(), kc.clone(), vc.clone()
    got = mb.step(arena, kc, vc, toks, lens, table)
    want = mb.plain_step(a2, k2, v2, toks, lens, table)
    written = _check_mk(got, want, kc, vc, k2, v2, kc0, vc0)
    # Every (layer, row) position, all KV heads, and nothing else.
    assert int(written.all(-1).sum()) == int(written.any(-1).sum()) \
        == L * slots * seq


def _moe_cfg(**kw):
    base = dict(vocab_size=1024, hidden_size=256, intermediate_size=384,
                num_hidden_layers=2, num_attention_heads=16,
                num_key_value_heads=2, head_dim=128, num_experts=100,
                num_experts_per_tok=8, moe_intermediate_size=128)
    return ModelConfig(**dict(base, **kw))


def _moe_builder(rows, **kw):
    if rows > 8 and rows != 12:
        kw = dict(kw, seq=rows, chunk=True)
    return mkb.ModelBuilder(_moe_cfg(**kw.pop("cfg", {})), batch=rows,
                            max_len=256, t_tile=32, paged=True, page=32,
                            **kw)


def _first(mb, task_type, expert=-1):
    return next(t.task_id for t in mb.graph.tasks
                if t.task_type == task_type and t.expert == expert)


def _counts(mb, dev):
    rows = mb.schema.region("moe_counts").rows
    return torch.zeros(rows, mb.w, dtype=torch.int32, device=dev)


def _launch(mb, arena, counts, dev, times=1):
    kv = torch.zeros(mb.cfg.num_hidden_layers, 2, mb.page,
                     mb.cfg.num_key_value_heads, 128, dtype=torch.bfloat16,
                     device=dev)
    toks = np.zeros(mb.batch, np.int32)
    lens = (np.full(mb.batch, -1, np.int32) if mb.chunk
            else np.zeros(mb.batch, np.int32))
    table = np.ones(mb.n_slots * mb.p_max, np.int32)
    for _ in range(times):
        mb.launch(arena, kv, kv.clone(), toks, lens, table, counts=counts)
    mb.wait(dev)


def _plain(one, arena, counts=None):
    """The plain bodies of an isolated build's tasks (no pools read)."""
    zeros = np.zeros(one.batch, np.int64)
    one.interpret(arena, None, None, zeros, zeros, np.zeros(1, np.int64),
                  counts)


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no-norm"])
def test_moe_weights_kernel_matches_plain(dev, norm):
    mb = _moe_builder(4, cfg=dict(norm_topk_prob=norm))
    t = _first(mb, mkb.TaskType.MOE_WEIGHTS)
    one = mb.isolate([t])
    rl = mb.graph.tasks[t].args[0]
    g = torch.Generator(device=dev).manual_seed(7)
    arena = torch.zeros(mb.arena_rows, 128, dtype=torch.bfloat16, device=dev)
    lg = torch.randn(4, 128, generator=g, device=dev).to(torch.bfloat16)
    lg[0, 100:] = 50.0                      # masked columns never win
    lg[1, [5, 17, 33, 64, 99, 3, 41, 70, 88]] = 4.0   # nine-way tie at top
    lg[2, :] = 0.0                          # every expert equal
    lg[3, 100:] = -50.0
    arena[rl:rl + 4] = lg
    a2 = arena.clone()
    counts, c2 = _counts(mb, dev), _counts(mb, dev)
    _launch(one, arena, counts, dev, times=300)
    _plain(one, a2, c2)
    got = arena[mb.graph.tasks[t].args[1]:][:4].float()
    want = a2[mb.graph.tasks[t].args[1]:][:4].float()
    assert torch.equal(got != 0, want != 0)
    assert bool(((got - want).abs() <= 2.0 ** -8 * want.abs() + 1e-6).all())
    picked = [sorted(torch.nonzero(r).flatten().tolist()) for r in want]
    assert picked[1] == [3, 5, 17, 33, 41, 64, 70, 88]
    assert picked[2] == list(range(8))
    assert all(max(p) < 100 for p in picked)
    assert torch.equal(counts, 300 * c2)
    assert int(counts.sum()) == 300 * 4 * 8
    if norm:
        torch.testing.assert_close(got.sum(1), torch.ones(4, device=dev),
                                   rtol=2e-2, atol=0)


@pytest.mark.parametrize("rows", [4, 12, 128])
def test_weighted_add_kernel_matches_plain(dev, rows):
    """Expert 0's combine writes, expert 1's accumulates onto it, each a
    launch of its own."""
    mb = _moe_builder(rows)
    g = torch.Generator(device=dev).manual_seed(rows)
    arena = torch.randn(mb.arena_rows, 128, generator=g, device=dev).to(
        torch.bfloat16)
    a2 = arena.clone()
    for e in (0, 1):
        one = mb.isolate([_first(mb, mkb.TaskType.WEIGHTED_ADD, e)])
        _launch(one, arena, _counts(mb, dev), dev)
        _plain(one, a2)
    acc = mb.graph.tasks[_first(mb, mkb.TaskType.WEIGHTED_ADD, 0)].args[0]
    n = mb.d_tiles * rows
    got, want = arena[acc:acc + n].float(), a2[acc:acc + n].float()
    assert bool(((got - want).abs() <= 2.0 ** -8 * want.abs() + 1e-6).all())
    assert torch.equal(arena[:acc], a2[:acc])


def _moe_flips(mb, got_arena, want_arena):
    """(layers, rows): the pairs whose routed expert set differs."""
    diff = mb.routed_experts(got_arena) != mb.routed_experts(want_arena)
    return diff.any(-1)



@pytest.mark.parametrize("rows", [3, 16], ids=["decode", "chunk"])
def test_moe_megakernel_matches_plain(dev, rows):
    from triton_dist_tpu_torch.models import qwen_moe
    from triton_dist_tpu_torch.ops.chunked_prefill import chunk_row_codes

    kw = {} if rows <= 8 else dict(seq=rows, chunk=True)
    cfg = _moe_cfg()
    mb = mkb.ModelBuilder(cfg, batch=rows, max_len=256, t_tile=32,
                          paged=True, page=32, **kw)
    g = torch.Generator(device=dev).manual_seed(rows)
    params = qwen_moe.init_params(cfg, generator=g, device=dev,
                                  dtype=torch.bfloat16)
    arena = mb.pack_arena(params, dtype=torch.bfloat16, device=dev)
    slots = 1 if mb.chunk else rows
    shape = (2, 1 + 3 * mb.p_max, 32, 2, 128)
    kc = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    vc = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    rng = np.random.RandomState(rows)
    table = (rng.permutation(3 * mb.p_max) + 1).astype(np.int32)[
        :slots * mb.p_max]
    toks = rng.randint(0, cfg.vocab_size, rows).astype(np.int32)
    lens = (chunk_row_codes(CHUNK_START, rows, rows - 1, CHUNK_WFROM)
            if mb.chunk else np.array([0, 37, 130], np.int32))
    free = arena.clone(), kc.clone(), vc.clone()
    forced = arena.clone(), kc.clone(), vc.clone()
    counts, c_free, c2 = (_counts(mb, dev) for _ in range(3))
    got = mb.step(arena, kc, vc, toks, lens, table, counts=counts)
    mb.plain_step(*free, toks, lens, table, counts=c_free)
    want = mb.plain_step(*forced, toks, lens, table, counts=c2,
                         route_from=arena)
    flips = _moe_flips(mb, arena, free[0])
    rel = _row_rms(got, want)
    print(f"[mk-card] MoE {rows} rows: {int(flips.sum())} routing flips "
          f"against the free-running plain run; under the kernel's routing "
          f"max |dlogit| {(got - want).abs().max().item():.3e}, row RMS "
          f"{rel.max().item():.2e}")
    assert int(flips.sum()) <= max(2, int(0.15 * flips.numel()))
    _assert_close(got, want, MK_LOGITS_TOL)
    assert bool((rel <= MK_ROW_RMS_TOL).all()), rel.tolist()
    assert torch.equal(counts, c2)
    assert int(counts.sum()) == int(c_free.sum()) == rows * 2 * 8
    _assert_close(kc, forced[1], MK_KV_TOL)
    _assert_close(vc, forced[2], MK_KV_TOL)


GG_TOL = (1e-3, 2.0 ** -7)


def _violates(got, want, tol):
    diff = (got.float() - want.float()).abs()
    return bool((diff > tol[0] + tol[1] * want.float().abs()).any())


@pytest.mark.parametrize("b,s,h,kv,hd,causal", [
    (2, 1, 4, 4, 128, True), (1, 65, 8, 2, 8, True), (2, 130, 8, 1, 64,
                                                      True),
    (1, 1000, 32, 4, 128, True), (2, 77, 4, 2, 256, False),
    (1, 200, 16, 2, 96, True), (1, 64, 2, 2, 12, False)])
def test_flash_attention_kernel_matches_plain(dev, b, s, h, kv, hd, causal):
    g = torch.Generator(device=dev).manual_seed(s + hd)
    bf = dict(device=dev, dtype=torch.bfloat16)
    q = torch.randn(b, s, h, hd, generator=g, **bf)
    k = torch.randn(b, s, kv, hd, generator=g, **bf)
    v = torch.randn(b, s, kv, hd, generator=g, **bf)
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v, causal=causal, sm_scale=hd ** -0.5)
    assert fa.KERNEL.launches == before + 1
    want = fa.flash_attention_ref(q, k, v, causal=causal,
                                  sm_scale=hd ** -0.5)
    _assert_close(got, want, QBLOCK_TOL)


def test_flash_attention_limit_catches_a_planted_fault(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    bf = dict(device=dev, dtype=torch.bfloat16)
    q = torch.randn(1, 256, 8, 128, generator=g, **bf)
    k = torch.randn(1, 256, 2, 128, generator=g, **bf)
    v = torch.randn(1, 256, 2, 128, generator=g, **bf)
    bad = k.clone()
    bad[:, 64:128, 0] = k[:, 64:128, 1]          # a key tile of head 1
    got = fa.flash_attention(q, bad, v, sm_scale=128 ** -0.5)
    want = fa.flash_attention_ref(q, k, v, sm_scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert _violates(got, want, QBLOCK_TOL)


def _routed(dev, t, k, e, d, block_m, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(t, d, generator=g, device=dev, dtype=torch.bfloat16)
    logits = torch.randn(t, e, generator=g, device=dev)
    ids = torch.topk(logits, k, dim=-1).indices.to(torch.int32)
    tm = ag_moe.suggested_block_m(t, k, e, block_m)
    return (*ag_moe.prepare_grouped_tokens(x, ids, e, tm), tm, g)


@pytest.mark.parametrize("t,k,e,d,f,block_m,pair", [
    (6, 8, 128, 256, 96, 256, True),       # tm 8
    (40, 4, 16, 64, 64, 32, False),        # tm 32
    (300, 8, 32, 512, 160, 128, True),     # tm 128
    (24, 2, 8, 36, 40, 16, False),         # K not a multiple of 8
    (64, 2, 4, 128, 48, 64, True)])        # tm 64
def test_group_gemm_kernel_matches_plain(dev, t, k, e, d, f, block_m, pair):
    xs, te, _, tm, g = _routed(dev, t, k, e, d, block_m, t + d)
    bf = dict(device=dev, dtype=torch.bfloat16)
    ws = [torch.randn(e, f, d, generator=g, **bf) * d ** -0.5
          for _ in range(2 if pair else 1)]
    w = tuple(ws) if pair else ws[0]
    before = group_gemm.KERNEL.launches
    got = group_gemm.grouped_gemm_tiles(xs, w, te)
    assert group_gemm.KERNEL.launches == before + 1
    assert got.shape == (xs.shape[0], f * len(ws))
    _assert_close(got, group_gemm.grouped_gemm_tiles_ref(xs, w, te), GG_TOL)


def test_group_gemm_limit_catches_a_planted_fault(dev):
    xs, te, _, tm, g = _routed(dev, 300, 8, 32, 512, 128, 5)
    w = torch.randn(32, 128, 512, generator=g, device=dev,
                    dtype=torch.bfloat16) * 512 ** -0.5
    got = group_gemm.grouped_gemm_tiles(xs, w, torch.roll(te, 1))
    torch.cuda.synchronize()
    assert _violates(got, group_gemm.grouped_gemm_tiles_ref(xs, w, te),
                     GG_TOL)


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    bf = dict(device=dev, dtype=torch.bfloat16)
    q = torch.zeros(1, 8, 2, 16, **bf)
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), q.float(), q.float(), sm_scale=1.0)
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 8, 2, 272, **bf)
        fa.flash_attention(z, z, z, sm_scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q, q, sm_scale=1.0)
    x = torch.zeros(96, 16, **bf)
    w = torch.zeros(2, 8, 16, **bf)
    te = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="row tile"):
        group_gemm.grouped_gemm_tiles(x, w, te)          # tm 96
    with pytest.raises(TypeError):
        group_gemm.grouped_gemm_tiles(x, w, te.long())


def test_fused_moe_never_syncs_the_host(dev):
    from triton_dist_tpu_torch.layers import ep_moe, tp_moe

    cfg = ModelConfig.tiny_moe(hidden_size=64, num_experts=16,
                               num_experts_per_tok=4, moe_intermediate_size=64)
    g = torch.Generator(device=dev).manual_seed(0)
    moe = ep_moe.init(cfg, generator=g, device=dev, dtype=torch.bfloat16)
    x = torch.randn(40, 64, generator=g, device=dev, dtype=torch.bfloat16)
    kw = dict(topk=4, num_experts=16)
    want = tp_moe.fwd_fused(moe, x, **kw)      # builds and loads the kernel
    torch.cuda.synchronize()
    before = group_gemm.KERNEL.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tp_moe.fwd_fused(moe, x, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert group_gemm.KERNEL.launches == before + 2
    assert torch.equal(got, want)


# ---- Quantized (int8 / fp8) pools and the Q-block verify build ----------
#
# The paged kernels' int8/fp8 instantiations dequantize each page with its
# (page, head) scale; the plain versions dequantize in the gather. Both
# attend in fp32 and round the output to bf16 once, so the decode limits
# hold. The megakernel's quantized write runs alone (``isolate``) on the
# same arena and pools as the plain ``_quant_store_token`` sequence: the
# K rows it quantizes are the same up to the ulps of two rope and norm
# spellings, so its codes must lie within one step of the plain codes
# (fp8: two units of last place, a tie flip carried into a lower binade
# by a rescale) and its scales within 1e-6 relative. Whole quantized steps (decode, a chunk,
# a verify block with a masked row) are held to the megakernel limits on
# the logits and on the dequantized pools. Planted faults: the scale
# table of the next page id, and the plain run's table row shifted by one
# page.

QUANT_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
QMAX = {"int8": 127.0, "fp8": 448.0}


def _quantize(x, kvd):
    """Per-(page, head) max-abs quantization of a (..., page, hd) fp32
    block over its last two dims (the layer lane's page layout)."""
    amax = x.abs().amax(dim=(-2, -1))
    sc = torch.where(amax > 0, amax / QMAX[kvd], torch.ones_like(amax))
    y = x / sc[..., None, None]
    y = (y.round().clamp(-127, 127).to(torch.int8) if kvd == "int8"
         else y.clamp(-448, 448).to(torch.float8_e4m3fn))
    return y, sc.float().contiguous()


def _qpool(dev, seed, b, kvh, page, p_max, kvd):
    kp, vp, tbl, g = _pool(dev, seed, b, kvh, page, HD, p_max)
    kc, ks = _quantize(kp.float(), kvd)
    vc, vs = _quantize(vp.float(), kvd)
    return kc, vc, ks, vs, tbl, g


@pytest.mark.parametrize("kvd", ["int8", "fp8"])
@pytest.mark.parametrize("rep,page", [(4, 32), (8, 16), (1, 64)])
def test_quantized_decode_kernel_matches_plain(dev, kvd, rep, page):
    kvh, b, p_max = 2, 5, 6
    kc, vc, ks, vs, tbl, g = _qpool(dev, rep, b, kvh, page, p_max, kvd)
    tbl[0] = 0                                            # parked
    cap = p_max * page
    lens = torch.tensor([1, page, page + 1, cap, 3 * page - 5],
                        dtype=torch.int32, device=dev)
    q = torch.randn(b, kvh * rep, HD, generator=g, device=dev,
                    dtype=torch.bfloat16)
    kernel = pfd.KERNELS[QUANT_DTYPES[kvd]]
    before = kernel.launches
    got = pfd.paged_flash_decode(q, kc, vc, tbl, lens, k_scale=ks,
                                 v_scale=vs)
    assert kernel.launches == before + 1
    want = pfd.paged_flash_decode_ref(q, kc, vc, tbl, lens, ks, vs)
    _assert_close(got, want, DECODE_TOL)
    # Planted fault: every page read with the next page id's scales.
    bad = pfd.paged_flash_decode(q, kc, vc, tbl, lens,
                                 k_scale=ks.roll(-1, 0).contiguous(),
                                 v_scale=vs.roll(-1, 0).contiguous())
    with pytest.raises(AssertionError):
        _assert_close(bad, want, DECODE_TOL)


@pytest.mark.parametrize("kvd", ["int8", "fp8"])
@pytest.mark.parametrize("rep,page,c", [(4, 32, 37), (8, 16, 4), (2, 64, 9)])
def test_quantized_qblock_kernel_matches_plain(dev, kvd, rep, page, c):
    kvh, b, p_max = 2, 3, 5
    kc, vc, ks, vs, tbl, g = _qpool(dev, rep + c, b, kvh, page, p_max, kvd)
    cap = p_max * page
    pos = torch.randint(0, cap, (b, 1), generator=g, device=dev,
                        dtype=torch.int32) + torch.arange(
                            c, device=dev, dtype=torch.int32)
    pos[0] = torch.arange(c, device=dev) + page - 2       # a chunk
    pos[2] = -1                                           # parked
    q = torch.randn(b, c, kvh * rep, HD, generator=g, device=dev,
                    dtype=torch.bfloat16)
    kernel = pfq.KERNELS[QUANT_DTYPES[kvd]]
    before = kernel.launches
    got = pfq.paged_flash_qblock(q, kc, vc, tbl, pos, k_scale=ks, v_scale=vs)
    assert kernel.launches == before + 1
    want = pfq.paged_flash_qblock_ref(q, kc, vc, tbl, pos.clamp(max=cap - 1),
                                      ks, vs)
    _assert_close(got, want, QBLOCK_TOL)


def test_quantized_kernel_wrappers_reject_bad_scales(dev):
    kc, vc, ks, vs, tbl, g = _qpool(dev, 0, 2, 2, 32, 2, "int8")
    q = torch.randn(2, 8, HD, device=dev, dtype=torch.bfloat16)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="QUANTIZED"):
        pfd.paged_flash_decode(q, kc, vc, tbl, lens)
    with pytest.raises(TypeError, match="scales"):
        pfd.paged_flash_decode(q, kc, vc, tbl, lens, k_scale=ks.double(),
                               v_scale=vs)
    with pytest.raises(TypeError):
        pfd.paged_flash_decode(q, kc, vc.view(torch.float8_e4m3fn), tbl,
                               lens, k_scale=ks, v_scale=vs)


def _mk_quant_pools(mb, kc, vc, kvd):
    """The random bf16 pools of a megakernel setup quantized per (layer,
    page, head): codes (L, N, page, kv, hd) and scales (L, N, kv)."""
    out = []
    for pool in (kc, vc):
        codes, sc = _quantize(pool.float().transpose(2, 3), kvd)
        out += [codes.transpose(2, 3).contiguous(), sc]
    return out


def _check_mk_quant(got, want, pools, plain):
    """The megakernel limits on the logits; the dequantized pools within
    0.1 (int8) or 0.25 (fp8: 3.5 steps of its top binade) of each (layer,
    page, head)'s max-abs. A whole step's K rows
    differ from the plain run's by the bf16 units of the projections
    before them, so the running scales grow at different tokens and the
    codes are rounded a different number of times (chip_smoke.py
    ``dequant_close``: 5 int8 codes at Qwen3-8B widths); a misplaced row
    is off by the order of the max-abs."""
    rel = _row_rms(got, want)
    print(f"[mk-card] quant: max |dlogit| {(got - want).abs().max().item():.3e}"
          f", worst row RMS error / RMS {rel.max().item():.2e}")
    _assert_close(got, want, MK_LOGITS_TOL)
    assert bool((rel <= MK_ROW_RMS_TOL).all()), rel.tolist()
    for i in (0, 2):
        qmax = 127.0 if pools[i].dtype == torch.int8 else 448.0
        deq = [p[i].float() * p[i + 1][:, :, None, :, None]
               for p in (pools, plain)]
        amax = plain[i + 1][:, :, None, :, None] * qmax
        tol = 0.1 if pools[i].dtype == torch.int8 else 0.25
        assert float(((deq[0] - deq[1]).abs() / amax).max()) <= tol


@pytest.mark.parametrize("kvd", ["int8", "fp8"])
def test_megakernel_quantized_decode_matches_plain(dev, kvd):
    mb, arena, kc, vc, toks, lens, table = _mk_setup(
        dev, paged=True, schedule="static")
    mb = mkb.ModelBuilder(MK_CFG, batch=3, max_len=256, t_tile=32,
                          paged=True, page=32, kv_quant=kvd)
    pools = _mk_quant_pools(mb, kc, vc, kvd)
    plain = [t.clone() for t in pools]
    a2 = arena.clone()
    key = f"decode-{kvd}"
    before = mkb.MODE_LAUNCHES[key]
    got = mb.step(arena, pools[0], pools[2], toks, lens, table,
                  k_scale=pools[1], v_scale=pools[3])
    assert mkb.MODE_LAUNCHES[key] == before + 1
    want = mb.plain_step(a2, plain[0], plain[2], toks, lens, table,
                         k_scale=plain[1], v_scale=plain[3])
    _check_mk_quant(got, want, pools, plain)


def _mk_write_alone(dev, mb, kvd, toks, lens, table, arena, kc, vc):
    """Run layer 0's write task alone on the kernel and on the plain
    bodies, after the same plain run of its inputs; returns both pools."""
    pools = _mk_quant_pools(mb, kc, vc, kvd)
    wk = next(t.task_id for t in mb.graph.tasks
              if t.task_type in (mkb.TaskType.WRITE_KV,
                                 mkb.TaskType.WRITE_KV_CHUNK,
                                 mkb.TaskType.WRITE_KV_QBLOCK))
    pre = mb.isolate([t for t in mb.claim_list if t < wk])
    pre.plain_step(arena, *pools[::2], toks, lens, table,
                   k_scale=pools[1], v_scale=pools[3])
    plain = [t.clone() for t in pools]
    one = mb.isolate([wk])
    one.step(arena, pools[0], pools[2], toks, lens, table, k_scale=pools[1],
             v_scale=pools[3])
    one.plain_step(arena.clone(), plain[0], plain[2], toks, lens, table,
                   k_scale=plain[1], v_scale=plain[3])
    torch.cuda.synchronize()
    return pools, plain


def _assert_codes_close(pools, plain, steps=1, scale_rtol=1e-6):
    """Codes within ``steps`` steps of the plain codes (a step: int8 1;
    fp8 one unit of last place, 2**-3 of the value, 2**-9 at the
    smallest), scales within ``scale_rtol`` relative."""
    for i in (0, 2):
        d = (pools[i].float() - plain[i].float()).abs()
        step = 1.0 if pools[i].dtype == torch.int8 else (
            plain[i].float().abs() * 2.0 ** -3).clamp(min=2.0 ** -9)
        assert bool((d <= steps * step).all()), float(d.max())
        rel = ((pools[i + 1] - plain[i + 1]).abs() / plain[i + 1]).max()
        assert float(rel) <= scale_rtol, float(rel)


@pytest.mark.parametrize("kvd", ["int8", "fp8"])
@pytest.mark.parametrize("rows", [3, 16])
def test_megakernel_quantized_write_alone(dev, kvd, rows):
    """The write task alone: a decode batch (3 rows, one parked on the
    scratch page) and a 16-row chunk from 40 (rows 40-43 attend-only, the
    last dead) over pages holding random codes."""
    if rows == 3:
        mb0, arena, kc, vc, toks, lens, table = _mk_setup(
            dev, paged=True, schedule="static")
        mb = mkb.ModelBuilder(MK_CFG, batch=3, max_len=256, t_tile=32,
                              paged=True, page=32, kv_quant=kvd)
    else:
        mb0, arena, kc, vc, toks, lens, table = _mk_chunk_setup(dev, rows)
        mb = mkb.ModelBuilder(MK_CFG, batch=rows, seq=rows, chunk=True,
                              max_len=256, t_tile=32, paged=True, page=32,
                              kv_quant=kvd)
        table = table[1]
    pools, plain = _mk_write_alone(dev, mb, kvd, toks, lens, table, arena,
                                   kc, vc)
    # An fp8 code one step off at a rounding tie can become two steps of
    # a lower binade after a rescale (chip_smoke.py WRITE_STEPS).
    _assert_codes_close(pools, plain, steps=1 if kvd == "int8" else 2)


@pytest.mark.parametrize("kvd", ["bf16", "int8", "fp8"])
def test_megakernel_qblock_matches_plain(dev, kvd):
    """A verify block of 3 slots x K = 4 (16 rows would be 4 x 4): slot 0
    parked (masked rows), slot 1 with its last candidate over budget
    (masked), slot 2 whole, against the plain interpreter; the masked
    rows write no page and no scale."""
    kq, slots, page = 4, 3, 32
    quant = None if kvd == "bf16" else kvd
    mb = mkb.ModelBuilder(MK_CFG, batch=slots * kq, seq=kq, qblock=True,
                          max_len=256, t_tile=page, paged=True, page=page,
                          kv_quant=quant)
    assert mb.mode == "qblock" and mb.uses_tensor_cores
    _, arena, kc, vc, toks, lens, table = _mk_setup(
        dev, paged=True, schedule="static", b=slots * kq)
    table = table[:slots * mb.p_max]
    pos = np.concatenate([[-1] * kq, 37 + np.arange(kq), 130 + np.arange(kq)])
    pos[2 * kq - 1] = -1
    pos = pos.astype(np.int32)
    toks = toks[:slots * kq]
    if quant:
        pools = _mk_quant_pools(mb, kc, vc, kvd)
        kw = dict(k_scale=pools[1], v_scale=pools[3])
        plain = [t.clone() for t in pools]
        pkw = dict(k_scale=plain[1], v_scale=plain[3])
        kc, vc, k2, v2 = pools[0], pools[2], plain[0], plain[2]
    else:
        kw = pkw = {}
        k2, v2 = kc.clone(), vc.clone()
    k0 = k2.clone()
    a2 = arena.clone()
    key = "qblock" + (f"-{kvd}" if quant else "")
    before = mkb.MODE_LAUNCHES[key]
    got = mb.step(arena, kc, vc, toks, pos, table, **kw)
    assert mkb.MODE_LAUNCHES[key] == before + 1
    want = mb.plain_step(a2, k2, v2, toks, pos, table, **pkw)
    rows = pos >= 0
    if quant:
        _check_mk_quant(got[rows], want[rows], pools, plain)
    else:
        _assert_close(got[rows], want[rows], MK_LOGITS_TOL)
        _assert_close(kc, k2, MK_KV_TOL)
        _assert_close(vc, v2, MK_KV_TOL)
    # The plain run wrote exactly the unmasked rows' positions.
    written = (k2 != k0).any(-1).any(-1)
    expect = torch.zeros_like(written)
    tab = table.reshape(slots, mb.p_max)
    for r in np.nonzero(rows)[0]:
        p = int(pos[r])
        expect[:, int(tab[r // kq][p // page]), p % page] = True
    if not quant:
        assert torch.equal(written, expect)
