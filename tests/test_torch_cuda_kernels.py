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
``chip_smoke.py``.

The expert-parallel slice (at the end): row 18's dense form at odd
chunk sizes and element types (bf16, int32, fp32, 6-byte rows), its
ragged form under ``ragged_exchange`` / ``ragged_return`` (random
destinations, a cutting envelope, every row to rank 0) and row 23 (int8
and fp8, odd row counts and widths, parities 0, 1, 0), each bit for bit
against its plain version, 20 launches in a row, planted faults (a slot
off by one, a wrong parity, scales from the wrong row) and lost signals;
row 17 with per-rank tile maps and used-tile counts within one bf16
unit; a 2-layer tp = 4 EP engine's exact launches per transport, its
logits within 0.1 of the same engine on CPU copies; and the EP layer and
its "ll" decode never syncing the host.

The pipeline slice (at the end): rows 32, 33, 2 and 6 at n = 2, 3, 4 and
8 ranks (row 6 at 2, 4, 8) and over the pp axis of a 2 x 4 mesh, odd byte
counts for the copies, each bit for bit against its plain version,
repeated, with planted faults and lost signals; ``gpipe_forward`` with
row 32 at every tick bit for bit against its plain boundary, the host
never synchronised."""

import importlib
import pathlib
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

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


# ---- The fused tensor-parallel GEMMs (rows 7, 10, 13, 14) -----------------
#
# Simulated ranks on the one card: every rank's blocks in one cooperative
# launch. Both sides sum in fp32 and round to bf16 once, in other orders
# inside a rank's product, so an output may land one bf16 unit away:
# |got - want| <= 1e-2 + 2**-7 |want| (the outputs are of order 1). The
# weight shards are views of one full weight: column shards for AG+GEMM,
# strided column slices (row-parallel) for GEMM+RS and GEMM+AR.

TP_TOL = (1e-2, 2.0 ** -7)


def _tp_operands(dev, n, rows, k, cols, seed, *, row_parallel):
    from triton_dist_tpu_torch.ops.tp_gemm import column_shards, row_shards

    g = torch.Generator(device=dev).manual_seed(seed)
    bf = dict(device=dev, dtype=torch.bfloat16)
    a = torch.randn(n, rows, k, generator=g, **bf)
    if row_parallel:
        w = torch.randn(cols, n * k, generator=g, **bf) * (n * k) ** -0.5
        return a, row_shards(w, n)
    w = torch.randn(n * cols, k, generator=g, **bf) * k ** -0.5
    return a, column_shards(w, n)


def _tp_ctx(op, n, **kw):
    from triton_dist_tpu_torch.ops import ag_gemm, gemm_ar, gemm_rs
    from triton_dist_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(tp=n)
    make = {"ag": ag_gemm.create_ag_gemm_context,
            "rs": gemm_rs.create_gemm_rs_context,
            "ar": gemm_ar.create_gemm_ar_context}[op]
    if op == "ar":
        return make(mesh, block_n=8, block_k=8, **kw)
    return make(mesh, block_m=1, block_n=8, block_k=8, **kw)


@pytest.mark.parametrize("n,m_loc,k,n_loc", [
    (4, 64, 256, 192), (2, 8, 64, 40), (4, 200, 136, 96), (3, 16, 512, 64),
    (1, 24, 64, 64)])
@pytest.mark.parametrize("return_ag", [False, True])
def test_ag_gemm_kernel_matches_plain(dev, n, m_loc, k, n_loc, return_ag):
    from triton_dist_tpu_torch.ops import ag_gemm as op

    a, b = _tp_operands(dev, n, m_loc, k, n_loc, m_loc + k,
                        row_parallel=False)
    ctx = _tp_ctx("ag", n)
    before = op.KERNEL.launches
    got = op.ag_gemm(a, b, ctx, return_ag=return_ag, check=True)
    assert op.KERNEL.launches == before + 1
    want = op.ag_gemm_ref(a, b, return_ag=return_ag)
    if return_ag:
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    assert got.shape == (n, n * m_loc, n_loc)
    _assert_close(got, want, TP_TOL)


@pytest.mark.parametrize("n,m_loc,k_loc,cols", [
    (4, 96, 128, 320), (3, 8, 64, 72), (2, 130, 256, 128), (1, 16, 64, 64)])
def test_gemm_rs_kernel_matches_plain(dev, n, m_loc, k_loc, cols):
    from triton_dist_tpu_torch.ops import gemm_rs as op

    a, b = _tp_operands(dev, n, n * m_loc, k_loc, cols, m_loc + cols,
                        row_parallel=True)
    before = op.KERNEL.launches
    got = op.gemm_rs(a, b, _tp_ctx("rs", n), check=True)
    assert op.KERNEL.launches == before + 1
    assert got.shape == (n, m_loc, cols)
    _assert_close(got, op.gemm_rs_ref(a, b), TP_TOL)


@pytest.mark.parametrize("variant", ["ll", "one_shot"])
@pytest.mark.parametrize("n,m,k_loc,cols", [
    (4, 4, 256, 512), (4, 200, 128, 192), (2, 16, 64, 40), (3, 17, 72, 64)])
def test_gemm_ar_kernel_matches_plain(dev, variant, n, m, k_loc, cols):
    from triton_dist_tpu_torch.ops import gemm_ar as op

    a, b = _tp_operands(dev, n, m, k_loc, cols, m + cols, row_parallel=True)
    before = op.KERNEL.launches
    got = op.gemm_ar(a, b, _tp_ctx("ar", n, variant=variant), check=True)
    assert op.KERNEL.launches == before + 1
    _assert_close(got, op.gemm_ar_ref(a, b), TP_TOL)


def test_fused_gemms_repeat_without_a_miss(dev):
    """Flags persist across calls (epochs): 30 back-to-back launches of
    each kernel on fresh inputs, every one within the limit."""
    from triton_dist_tpu_torch.ops import ag_gemm, gemm_ar, gemm_rs

    for i in range(30):
        a, b = _tp_operands(dev, 4, 128, 256, 256, i, row_parallel=False)
        got = ag_gemm.ag_gemm(a, b, _tp_ctx("ag", 4))
        _assert_close(got, ag_gemm.ag_gemm_ref(a, b), TP_TOL)
        a, b = _tp_operands(dev, 4, 512, 128, 256, i, row_parallel=True)
        _assert_close(gemm_rs.gemm_rs(a, b, _tp_ctx("rs", 4)),
                      gemm_rs.gemm_rs_ref(a, b), TP_TOL)
        a, b = _tp_operands(dev, 4, 4, 256, 512, i, row_parallel=True)
        _assert_close(gemm_ar.gemm_ar(a, b, _tp_ctx("ar", 4)),
                      gemm_ar.gemm_ar_ref(a, b), TP_TOL)


@pytest.mark.parametrize("op_name,fault", [
    ("ag_gemm", "wrong_chunk"), ("gemm_rs", "drop_partial"),
    ("gemm_ar", "drop_partial")])
def test_fused_gemm_limit_catches_a_planted_fault(dev, op_name, fault):
    from triton_dist_tpu_torch.ops import ag_gemm, gemm_ar, gemm_rs

    mod = {"ag_gemm": ag_gemm, "gemm_rs": gemm_rs, "gemm_ar": gemm_ar}[
        op_name]
    rows = {"ag_gemm": 128, "gemm_rs": 512, "gemm_ar": 4}[op_name]
    a, b = _tp_operands(dev, 4, rows, 256, 256, 7,
                        row_parallel=op_name != "ag_gemm")
    ctx = _tp_ctx({"ag_gemm": "ag", "gemm_rs": "rs", "gemm_ar": "ar"}[
        op_name], 4)
    got = getattr(mod, op_name)(a, b, ctx, fault=mod.FAULTS[fault],
                                check=True)
    want = getattr(mod, op_name + "_ref")(a, b)
    assert _violates(got, want, TP_TOL)


@pytest.mark.parametrize("op_name", ["ag_gemm", "gemm_rs", "gemm_ar"])
def test_fused_gemm_lost_signal_raises_within_its_bound(dev, op_name):
    """A flag that is never set: the wait gives up at its bound, the
    launch ends, and the wrapper raises naming the op and the waiting rank
    (rank 1 or a rank downstream of it, whichever wait expires first);
    the next call on the same workspace is sound."""
    import time

    from triton_dist_tpu_torch.ops import ag_gemm, gemm_ar, gemm_rs
    from triton_dist_tpu_torch.shmem.workspace import CommTimeoutError

    mod = {"ag_gemm": ag_gemm, "gemm_rs": gemm_rs, "gemm_ar": gemm_ar}[
        op_name]
    rows = {"ag_gemm": 64, "gemm_rs": 256, "gemm_ar": 4}[op_name]
    a, b = _tp_operands(dev, 4, rows, 128, 128, 9,
                        row_parallel=op_name != "ag_gemm")
    ctx = _tp_ctx({"ag_gemm": "ag", "gemm_rs": "rs", "gemm_ar": "ar"}[
        op_name], 4)
    fn = getattr(mod, op_name)
    t0 = time.perf_counter()
    with pytest.raises(CommTimeoutError,
                       match=rf"{op_name}.*rank [123] waited"):
        fn(a, b, ctx, fault=mod.FAULTS["lost_signal"], timeout_s=0.05,
           check=True)
    assert time.perf_counter() - t0 < 5.0
    _assert_close(fn(a, b, ctx, check=True),
                  getattr(mod, op_name + "_ref")(a, b), TP_TOL)


def test_tp_engine_launches_the_fused_kernels(dev):
    """A 2-layer tp = 4 engine on the card: each prefill layer of
    "fused" launches AG+GEMM and GEMM+RS twice, each decode layer GEMM+AR
    twice, and the logits stay within 0.1 of the "xla" mode's."""
    from triton_dist_tpu_torch import Engine, make_mesh
    from triton_dist_tpu_torch.ops import ag_gemm, gemm_ar, gemm_rs

    cfg = ModelConfig.tiny(vocab_size=512, hidden_size=256,
                           intermediate_size=512, num_attention_heads=8,
                           num_key_value_heads=4, head_dim=32)
    g = torch.Generator(device=dev).manual_seed(0)
    params = dense.init_params(cfg, generator=g, device=dev)
    ids = torch.randint(0, 512, (2, 64), generator=g, device=dev)
    mesh = make_mesh(tp=4)
    want, _ = Engine(cfg, mesh=mesh, mode="xla", params=params,
                     max_len=80).prefill(ids)
    for mode in ("fused", "fused_ar"):
        eng = Engine(cfg, mesh=mesh, mode=mode, params=params, max_len=80)
        before = [k.launches for k in (ag_gemm.KERNEL, gemm_rs.KERNEL,
                                       gemm_ar.KERNEL)]
        logits, cache = eng.prefill(ids)
        eng.decode(torch.argmax(logits, -1), cache)
        got = [k.launches - b for k, b in zip(
            (ag_gemm.KERNEL, gemm_rs.KERNEL, gemm_ar.KERNEL), before)]
        prefill = 2 * cfg.num_hidden_layers
        assert got == ([prefill, prefill, prefill] if mode == "fused"
                       else [0, 0, 2 * prefill])
        _assert_close(logits, want, (0.1, 0.0))


@pytest.mark.parametrize("step,op_name", [("prefill", "gemm_rs"),
                                          ("decode", "gemm_ar")])
def test_tp_engine_step_raises_its_own_lost_signal(dev, monkeypatch, step,
                                                   op_name):
    """A signal never sent inside the attention's GEMM+RS (prefill) or
    GEMM+AR (decode) of a tp = 4 engine raises CommTimeoutError from that
    same Engine call; the engine's next steps give the logits it gave
    before."""
    import functools

    from triton_dist_tpu_torch import Engine, make_mesh
    from triton_dist_tpu_torch.layers import tp_attn
    from triton_dist_tpu_torch.ops import gemm_ar, gemm_rs
    from triton_dist_tpu_torch.shmem.workspace import CommTimeoutError

    cfg = ModelConfig.tiny(vocab_size=512, hidden_size=256,
                           intermediate_size=512, num_attention_heads=8,
                           num_key_value_heads=4, head_dim=32)
    g = torch.Generator(device=dev).manual_seed(0)
    params = dense.init_params(cfg, generator=g, device=dev)
    ids = torch.randint(0, 512, (2, 64), generator=g, device=dev)
    eng = Engine(cfg, mesh=make_mesh(tp=4), mode="fused", params=params,
                 max_len=80)
    logits, cache = eng.prefill(ids)
    tok = torch.argmax(logits, -1)
    want, _ = eng.decode(tok, cache)
    _, cache = eng.prefill(ids)
    mod = {"gemm_rs": gemm_rs, "gemm_ar": gemm_ar}[op_name]
    with monkeypatch.context() as mp:
        mp.setattr(tp_attn, op_name, functools.partial(
            getattr(mod, op_name), fault=mod.FAULTS["lost_signal"],
            timeout_s=0.05))
        with pytest.raises(CommTimeoutError, match=op_name):
            if step == "prefill":
                eng.prefill(ids)
            else:
                eng.decode(tok, cache)
    again, cache = eng.prefill(ids)
    _assert_close(again, logits, (1e-2, 0.0))
    _assert_close(eng.decode(tok, cache)[0], want, (1e-2, 0.0))


# ---- Tensor-parallel MoE over simulated ranks (rows 19, 20, 21) ----------
#
# The weights of every rank are views of one (E, f, d) / (E, d, f) weight:
# rank r's rows (gate, up) or columns (down) of every expert. The grouped
# GEMMs sum in fp32 and round once, as their plain versions do, in another
# order inside a product (GG_TOL); the combine epilogues sum fp32 partials
# in the plain versions' order and round once (TP_TOL: an output of order
# 1 may land one bf16 unit away).


def _moe_ranks(dev, n, t_loc, k, e, d, f, block_m, seed):
    """n ranks' sorted layouts of t_loc random tokens each (random top-k
    experts) and one expert weight set: (x_s (n, S_loc, d), te (n, n_i),
    row_src, tm, gate (E, f, d), up, down (E, d, f), ids, g)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = dict(device=dev, dtype=torch.bfloat16)
    x = torch.randn(n, t_loc, d, generator=g, **bf)
    logits = torch.randn(n, t_loc, e, generator=g, device=dev)
    ids = torch.topk(logits, k, dim=-1).indices.to(torch.int32)
    tm = ag_moe.suggested_block_m(t_loc, k, e, block_m)
    x_s, te, src = (torch.stack(v) for v in zip(*(
        ag_moe.prepare_grouped_tokens(x[r], ids[r], e, tm)
        for r in range(n))))
    gate, up = (torch.randn(e, f, d, generator=g, **bf) * d ** -0.5
                for _ in range(2))
    down = torch.randn(e, d, f, generator=g, **bf) * f ** -0.5
    return x_s, te, src, tm, gate, up, down, g


def _moe_ctx(n, e, tm):
    from triton_dist_tpu_torch.parallel.mesh import make_mesh

    return ag_moe.create_ag_moe_context(make_mesh(tp=n), num_experts=e,
                                        block_m=tm)


@pytest.mark.parametrize("n,t_loc,k,e,d,f,block_m", [
    (4, 64, 8, 32, 256, 384, 256),       # tm 8 at tp 4: F_loc 96
    (2, 40, 4, 16, 128, 128, 32),        # tm 32
    (4, 300, 2, 8, 512, 512, 128),       # tm 64 (two row blocks a tile)
    (3, 17, 2, 5, 64, 48, 16)])          # three ranks, F_loc 16
def test_group_gemm_takes_strided_rank_shards(dev, n, t_loc, k, e, d, f,
                                              block_m):
    """Row 17 over n ranks in one launch, on the ranks' ffn shards as
    views (expert stride f·d for gate/up, row pitch f for down): the same
    as the plain version on contiguous copies of each shard."""
    from triton_dist_tpu_torch.layers.tp_moe import param_specs

    x_s, te, _, tm, gate, up, down, g = _moe_ranks(dev, n, t_loc, k, e, d, f,
                                                   block_m, n + t_loc)
    sh = param_specs(SimpleNamespace(router=None, w_gate=gate, w_up=up,
                                     w_down=down), n)
    assert not sh["w_down"].is_contiguous()
    x_full = x_s.reshape(-1, d)
    te_full = te.reshape(-1).contiguous()
    xs = x_full.expand(n, *x_full.shape).contiguous()
    before = group_gemm.KERNEL.launches
    got = group_gemm.grouped_gemm_tiles(xs, (sh["w_gate"], sh["w_up"]),
                                        te_full)
    act = torch.randn(n, x_full.shape[0], f // n, generator=g, device=dev,
                      dtype=torch.bfloat16)
    got_down = group_gemm.grouped_gemm_tiles(act, sh["w_down"], te_full)
    assert group_gemm.KERNEL.launches == before + 2
    for r in range(n):
        want = group_gemm.grouped_gemm_tiles_ref(
            x_full, (sh["w_gate"][r].contiguous(),
                     sh["w_up"][r].contiguous()), te_full)
        _assert_close(got[r], want, GG_TOL)
        _assert_close(got_down[r], group_gemm.grouped_gemm_tiles_ref(
            act[r], sh["w_down"][r].contiguous(), te_full), GG_TOL)


@pytest.mark.parametrize("n,t_loc,k,e,d,f,block_m", [
    (4, 128, 8, 128, 256, 768, 256),     # Qwen3-30B-A3B's routing: tm 8
    (4, 512, 8, 128, 256, 768, 256),     # tm 32, about half padding
    (2, 300, 2, 8, 128, 256, 128),       # tm 64
    (3, 20, 4, 6, 64, 96, 16),           # three ranks, tm 16
    (4, 600, 4, 4, 128, 64, 512)])       # tm 512: eight row blocks a tile
@pytest.mark.parametrize("skip_padding", [True, False])
def test_ag_moe_kernel_matches_plain(dev, n, t_loc, k, e, d, f, block_m,
                                     skip_padding):
    from triton_dist_tpu_torch.layers.tp_moe import param_specs

    x_s, te, src, tm, gate, up, down, _ = _moe_ranks(
        dev, n, t_loc, k, e, d, f, block_m, t_loc + d)
    sh = param_specs(SimpleNamespace(router=None, w_gate=gate, w_up=up,
                                     w_down=down), n)
    w = (sh["w_gate"], sh["w_up"])
    used = ag_moe.tiles_used(src, tm) if skip_padding else None
    before = ag_moe.KERNEL.launches
    got = ag_moe.ag_group_gemm(x_s, w, te, _moe_ctx(n, e, tm), used=used,
                               check=True)
    assert ag_moe.KERNEL.launches == before + 1
    assert got.shape == (n, n * x_s.shape[1], 2 * (f // n))
    _assert_close(got, ag_moe.ag_moe_ref(x_s, w, te), GG_TOL)


def _combine_inputs(dev, n, t, k, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn(n, t, k, d, generator=g, device=dev,
                    dtype=torch.bfloat16)
    w = torch.softmax(torch.randn(t, k, generator=g, device=dev), -1)
    return y, w.expand(n, t, k)


@pytest.mark.parametrize("n,t,k,d", [(4, 2048, 8, 256), (4, 4, 8, 2048),
                                     (2, 24, 2, 40), (3, 33, 3, 520),
                                     (1, 8, 2, 64)])
def test_moe_reduce_kernels_match_plain(dev, n, t, k, d):
    from triton_dist_tpu_torch.ops import moe_reduce as op

    y, w = _combine_inputs(dev, n, t, k, d, t + d)
    before = op.AR_KERNEL.launches
    got = op.moe_reduce_ar(y, w, check=True)
    assert op.AR_KERNEL.launches == before + 1
    _assert_close(got, op.moe_reduce_ar_ref(y, w), TP_TOL)
    if t % n == 0:
        before = op.RS_KERNEL.launches
        got = op.moe_reduce_rs(y, w, check=True)
        assert op.RS_KERNEL.launches == before + 1
        assert got.shape == (n, t // n, d)
        _assert_close(got, op.moe_reduce_rs_ref(y, w), TP_TOL)


def test_moe_kernels_repeat_without_a_miss(dev):
    """Flags and buffers persist across calls (epochs): 20 launches of
    each kernel in a row on fresh inputs, every one within its limit."""
    from triton_dist_tpu_torch.ops import moe_reduce as op

    for i in range(20):
        x_s, te, src, tm, gate, up, _, _ = _moe_ranks(
            dev, 4, 128, 8, 32, 256, 256, 256, i)
        w = (gate.view(32, 4, 64, 256).transpose(0, 1),
             up.view(32, 4, 64, 256).transpose(0, 1))
        got = ag_moe.ag_group_gemm(x_s, w, te, _moe_ctx(4, 32, tm),
                                   used=ag_moe.tiles_used(src, tm))
        _assert_close(got, ag_moe.ag_moe_ref(x_s, w, te), GG_TOL)
        y, cw = _combine_inputs(dev, 4, 256, 8, 512, i)
        _assert_close(op.moe_reduce_rs(y, cw), op.moe_reduce_rs_ref(y, cw),
                      TP_TOL)
        _assert_close(op.moe_reduce_ar(y, cw), op.moe_reduce_ar_ref(y, cw),
                      TP_TOL)


@pytest.mark.parametrize("op_name,fault", [
    ("ag_moe", "wrong_chunk"), ("ag_moe", "te"),
    ("moe_reduce_rs", "wrong_chunk"), ("moe_reduce_rs", "wrong_weight"),
    ("moe_reduce_ar", "wrong_chunk"), ("moe_reduce_ar", "wrong_weight")])
def test_moe_kernel_limit_catches_a_planted_fault(dev, op_name, fault):
    from triton_dist_tpu_torch.ops import moe_reduce as op

    if op_name == "ag_moe":
        x_s, te, src, tm, gate, up, _, _ = _moe_ranks(
            dev, 4, 128, 8, 32, 256, 256, 256, 3)
        w = (gate.view(32, 4, 64, 256).transpose(0, 1),
             up.view(32, 4, 64, 256).transpose(0, 1))
        bad_te = te.clone()
        if fault == "te":
            bad_te[1, 0] = (bad_te[1, 0] + 1) % 32
        got = ag_moe.ag_group_gemm(
            x_s, w, bad_te, _moe_ctx(4, 32, tm), check=True,
            used=ag_moe.tiles_used(src, tm),
            fault=ag_moe.FAULTS.get(fault, 0))
        assert _violates(got, ag_moe.ag_moe_ref(x_s, w, te), GG_TOL)
        return
    y, w = _combine_inputs(dev, 4, 64, 8, 256, 5)
    got = getattr(op, op_name)(y, w, fault=op.FAULTS[fault], check=True)
    assert _violates(got, getattr(op, op_name + "_ref")(y, w), TP_TOL)


@pytest.mark.parametrize("op_name", ["ag_moe", "moe_reduce_rs",
                                     "moe_reduce_ar"])
def test_moe_kernel_lost_signal_raises_within_its_bound(dev, op_name):
    """A flag that is never set: the wait gives up at its bound and the
    wrapper raises naming the op; the next call is sound."""
    import time

    from triton_dist_tpu_torch.ops import moe_reduce as op
    from triton_dist_tpu_torch.shmem.workspace import CommTimeoutError

    if op_name == "ag_moe":
        x_s, te, src, tm, gate, up, _, _ = _moe_ranks(
            dev, 4, 64, 8, 16, 128, 128, 256, 9)
        w = (gate.view(16, 4, 32, 128).transpose(0, 1),
             up.view(16, 4, 32, 128).transpose(0, 1))

        def fn(**kw):
            return ag_moe.ag_group_gemm(x_s, w, te, _moe_ctx(4, 16, tm),
                                        used=ag_moe.tiles_used(src, tm),
                                        **kw)

        want, tol, name = ag_moe.ag_moe_ref(x_s, w, te), GG_TOL, "ag_group"
    else:
        y, cw = _combine_inputs(dev, 4, 64, 8, 256, 9)

        def fn(**kw):
            return getattr(op, op_name)(y, cw, **kw)

        want, tol, name = getattr(op, op_name + "_ref")(y, cw), TP_TOL, op_name
    t0 = time.perf_counter()
    with pytest.raises(CommTimeoutError, match=rf"{name}.*rank [0-3]"):
        fn(fault=2, timeout_s=0.05, check=True)
    assert time.perf_counter() - t0 < 5.0
    _assert_close(fn(check=True), want, tol)


def _tp_moe(dev, seed=0, hidden=256):
    from triton_dist_tpu_torch.layers import ep_moe

    cfg = ModelConfig.tiny_moe(vocab_size=512, hidden_size=hidden,
                               num_attention_heads=8, num_key_value_heads=4,
                               head_dim=32, num_experts=16,
                               num_experts_per_tok=4,
                               moe_intermediate_size=128)
    g = torch.Generator(device=dev).manual_seed(seed)
    return cfg, ep_moe.init(cfg, generator=g, device=dev,
                            dtype=torch.bfloat16), g


@pytest.mark.parametrize("epilogue", ["rs", "ar"])
def test_tp_moe_fused_layer_matches_its_plain_run(dev, epilogue):
    """``fwd_fused`` over 4 ranks on the card (rows 19, 17, then 21 or 20)
    against the same layer on CPU copies (every op's plain version, the
    same bf16 rounding points): the products' fp32 sums run in other
    orders, so a gate/up output may land one bf16 unit away and carry it
    through the down product: two units of the output."""
    import copy

    from triton_dist_tpu_torch import make_mesh
    from triton_dist_tpu_torch.layers import tp_moe

    _, moe, g = _tp_moe(dev)
    x = torch.randn(4, 32, 256, generator=g, device=dev,
                    dtype=torch.bfloat16)
    kw = dict(topk=4, num_experts=16, epilogue=epilogue)
    got = tp_moe.fwd_fused(moe, x, mesh_ctx=make_mesh(tp=4), **kw)
    want = tp_moe.fwd_fused(copy.deepcopy(moe).cpu(), x.cpu(),
                            mesh_ctx=make_mesh(tp=4, device="cpu"), **kw)
    assert got.shape == want.shape == (
        (4, 32, 256) if epilogue == "rs" else (4, 128, 256))
    _assert_close(got, want.to(dev), (2e-2, 2.0 ** -6))


def test_tp_moe_fused_never_syncs_the_host(dev):
    from triton_dist_tpu_torch import make_mesh
    from triton_dist_tpu_torch.layers import tp_moe
    from triton_dist_tpu_torch.ops import moe_reduce

    _, moe, g = _tp_moe(dev)
    x = torch.randn(4, 32, 256, generator=g, device=dev,
                    dtype=torch.bfloat16)
    kw = dict(topk=4, num_experts=16, mesh_ctx=make_mesh(tp=4))
    want = tp_moe.fwd_fused(moe, x, **kw)        # builds and loads
    torch.cuda.synchronize()
    counts = [k.launches for k in (ag_moe.KERNEL, group_gemm.KERNEL,
                                   moe_reduce.RS_KERNEL)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tp_moe.fwd_fused(moe, x, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [k.launches - c for k, c in zip(
        (ag_moe.KERNEL, group_gemm.KERNEL, moe_reduce.RS_KERNEL),
        counts)] == [1, 1, 1]
    assert torch.equal(got, want)


def test_tp_moe_engine_launches_the_moe_kernels(dev):
    """A 2-layer tp = 4 MoE engine on the card: each "fused" prefill layer
    launches AG+grouped GEMM, the grouped GEMM (the down projection, every
    rank in one launch) and the combine + reduce-scatter once, no decode
    layer any of them; "xla" and "fused_ar" none. Logits finite."""
    from triton_dist_tpu_torch import Engine, make_mesh
    from triton_dist_tpu_torch.models import qwen_moe
    from triton_dist_tpu_torch.ops import moe_reduce

    cfg, _, g = _tp_moe(dev)
    params = qwen_moe.init_params(cfg, generator=g, device=dev)
    ids = torch.randint(0, 512, (2, 64), generator=g, device=dev)
    kernels = (ag_moe.KERNEL, group_gemm.KERNEL, moe_reduce.RS_KERNEL,
               moe_reduce.AR_KERNEL)
    for mode in ("fused", "fused_ar", "xla"):
        eng = Engine(cfg, mesh=make_mesh(tp=4), mode=mode, params=params,
                     max_len=80)
        before = [k.launches for k in kernels]
        logits, cache = eng.prefill(ids)
        eng.decode(torch.argmax(logits, -1), cache)
        got = [k.launches - b for k, b in zip(kernels, before)]
        layers = cfg.num_hidden_layers
        assert got == ([layers, layers, layers, 0] if mode == "fused"
                       else [0, 0, 0, 0]), (mode, got)
        assert logits.shape == (2, 512) and bool(torch.isfinite(logits).all())


# ---- the expert-parallel slice: rows 18, 23 and row 17's per-rank form ----

def _a2a_mesh(n):
    from triton_dist_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(tp=n)


def _a2a_rows(dev, n, c, tail, dtype, seed):
    """(n, n, c, *tail) with a distinct value in every (sender, receiver)
    chunk and row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2 ** 30, 2 ** 30, (n, n, c, *tail),
                             generator=g, device=dev, dtype=dtype)
    return torch.randn(n, n, c, *tail, generator=g, device=dev,
                       dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("tail,dtype", [
    ((24,), torch.bfloat16), ((1,), torch.int32), ((40,), torch.float32),
    ((2048,), torch.bfloat16),
    ((3,), torch.bfloat16)])                 # 6-byte rows: byte copies
def test_all_to_all_kernel_matches_plain(dev, tail, dtype):
    """Row 18, dense form: bit for bit the transpose over the ranks, at n
    = 2, 3, 4 ranks and c = 1, 7, 33 rows a chunk (a failure names the
    pair)."""
    from triton_dist_tpu_torch.ops import all_to_all as a2a

    for n in (2, 3, 4):
        for c in (1, 7, 33):
            x = _a2a_rows(dev, n, c, tail, dtype, n * c)
            before = a2a.KERNEL.launches
            got = a2a.all_to_all(x, ctx=_a2a_mesh(n), axis="tp", check=True)
            assert a2a.KERNEL.launches == before + 1, (n, c)
            assert torch.equal(got, a2a.all_to_all_ref(x)), (n, c)


@pytest.mark.parametrize("n,t,k,d,recv_rows,skew", [
    (4, 37, 8, 64, None, False), (4, 37, 8, 64, None, True),
    (4, 37, 8, 64, 300, True), (4, 5, 8, 2048, 100, False),
    (3, 11, 2, 24, 9, False), (3, 1, 1, 8, None, True),
    (2, 64, 4, 2048, None, False), (2, 64, 4, 2048, 129, False)])
def test_ragged_all_to_all_kernel_matches_plain(dev, n, t, k, d, recv_rows,
                                                skew):
    """Row 18's ragged form under ``ragged_exchange`` / ``ragged_return``
    (drop-free, a cutting envelope, every row to rank 0): the kernel's
    hops against the plain emulation on the same device, bit for bit."""
    from triton_dist_tpu_torch.ops import all_to_all as a2a
    from triton_dist_tpu_torch.ops import ep_a2a

    g = torch.Generator(device=dev).manual_seed(t + d)
    mesh = _a2a_mesh(n)
    dst = (torch.zeros(n, t * k, dtype=torch.int32, device=dev) if skew
           else torch.randint(-1, n, (n, t * k), generator=g, device=dev,
                              dtype=torch.int32))
    rows = torch.randn(n, t * k, d, generator=g, device=dev,
                       dtype=torch.bfloat16)
    ids = torch.randint(0, 99, (n, t * k), generator=g, device=dev,
                        dtype=torch.int32)
    outs = {}
    for impl in ("pallas", "xla"):
        before = a2a.KERNEL.launches
        (r, i), st = ep_a2a.ragged_exchange((rows, ids), dst, (0, -1),
                                            recv_rows, ctx=mesh, axis="tp",
                                            impl=impl)
        back = ep_a2a.ragged_return(r, st, out_rows=t * k, ctx=mesh,
                                    axis="tp", impl=impl)
        outs[impl] = (r, i, back)
        assert a2a.KERNEL.launches - before == (3 if impl == "pallas" else 0)
    for got, want in zip(outs["pallas"], outs["xla"]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("wire", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("n,c,d", [(4, 32, 2048), (3, 5, 136), (2, 9, 8),
                                   (4, 1, 264)])
def test_ll_a2a_kernel_matches_plain(dev, n, c, d, wire):
    """Row 23, two steps back to back (parities 0 and 1), then the same
    parity again: bit for bit the plain version (quantize, transpose,
    dequantize), zero rows included."""
    from triton_dist_tpu_torch.ops import low_latency as ll

    mesh = _a2a_mesh(n)
    for step in range(3):
        x = _a2a_rows(dev, n, c, (d,), torch.bfloat16, 10 * step + n)
        x[0, 0, 0] = 0
        before = ll.KERNEL.launches
        got = ll.ll_a2a(x, ctx=mesh, axis="tp", step=step, wire_dtype=wire,
                        check=True)
        assert ll.KERNEL.launches == before + 1
        assert torch.equal(got, ll.ll_a2a_ref(x, wire))


def test_a2a_kernels_repeat_without_a_miss(dev):
    """Flags and inbound slots persist across calls (epochs): 20 launches
    of each form in a row on fresh inputs, each bit for bit."""
    from triton_dist_tpu_torch.ops import all_to_all as a2a
    from triton_dist_tpu_torch.ops import low_latency as ll

    mesh = _a2a_mesh(4)
    for i in range(20):
        x = _a2a_rows(dev, 4, 16, (256,), torch.bfloat16, i)
        assert torch.equal(a2a.all_to_all(x, ctx=mesh, axis="tp"),
                           a2a.all_to_all_ref(x))
        assert torch.equal(ll.ll_a2a(x, ctx=mesh, axis="tp", step=i),
                           ll.ll_a2a_ref(x))
    torch.cuda.synchronize()


@pytest.mark.parametrize("op_name,fault", [
    ("all_to_all", "slot_off_by_one"), ("ll_a2a", "wrong_parity"),
    ("ll_a2a", "wrong_scale_row")])
def test_a2a_planted_fault_is_caught(dev, op_name, fault):
    from triton_dist_tpu_torch.ops import all_to_all as a2a
    from triton_dist_tpu_torch.ops import low_latency as ll

    mesh = _a2a_mesh(4)
    x = _a2a_rows(dev, 4, 16, (256,), torch.bfloat16, 107)
    if op_name == "all_to_all":
        got = a2a.all_to_all(x, ctx=mesh, axis="tp", check=True,
                             fault=a2a.FAULTS[fault])
        want = a2a.all_to_all_ref(x)
    else:
        # Other codes in the parity-0 slot, where a faulted put is missed.
        ll.ll_a2a(x.flip(2), ctx=mesh, axis="tp", step=0)
        got = ll.ll_a2a(x, ctx=mesh, axis="tp", step=0, check=True,
                        fault=ll.FAULTS[fault])
        want = ll.ll_a2a_ref(x)
    assert not torch.equal(got[1, 0], want[1, 0])


@pytest.mark.parametrize("op_name", ["all_to_all", "ragged", "ll_a2a"])
def test_a2a_lost_signal_raises_within_its_bound(dev, op_name):
    """A signal never sent: the receiver's wait gives up at its bound,
    the wrapper raises naming the op, and the next call is sound."""
    import time

    from triton_dist_tpu_torch.ops import all_to_all as a2a
    from triton_dist_tpu_torch.ops import low_latency as ll
    from triton_dist_tpu_torch.shmem.workspace import CommTimeoutError

    mesh = _a2a_mesh(4)
    x = _a2a_rows(dev, 4, 8, (128,), torch.bfloat16, 11)
    if op_name == "all_to_all":
        def fn(**kw):
            return a2a.all_to_all(x, ctx=mesh, axis="tp", **kw)
        want, name = a2a.all_to_all_ref(x), "all_to_all"
    elif op_name == "ragged":
        m = torch.tensor([[0, 8, 16, 24]] * 4, dtype=torch.int32,
                         device=dev)
        s = torch.full((4, 4), 8, dtype=torch.int32, device=dev)
        rows = x.reshape(4, 32, 128)

        def fn(**kw):
            out = torch.zeros_like(rows)
            return a2a.ragged_all_to_all(rows, out, m, s, m.t().contiguous(),
                                         ctx=mesh, axis="tp", **kw)
        want, name = a2a.all_to_all_ref(x).reshape(4, 32, 128), "ragged"
    else:
        def fn(**kw):
            return ll.ll_a2a(x, ctx=mesh, axis="tp", **kw)
        want, name = ll.ll_a2a_ref(x), "ll_a2a"
    t0 = time.perf_counter()
    with pytest.raises(CommTimeoutError, match=rf"{name}.*rank 1"):
        fn(fault=2, timeout_s=0.05, check=True)
    assert time.perf_counter() - t0 < 5.0
    assert torch.equal(fn(check=True), want)


def test_group_gemm_per_rank_maps_and_used_tiles(dev):
    """Row 17 with each rank's own tile map and used-tile count (the
    expert-parallel experts: the rank's slice of the one weight at a rank
    stride of e_loc·f·d), and with per-chunk counts shared by the ranks
    (the tensor-parallel down projection): the plain version's values,
    zeros past each count."""
    g = torch.Generator(device=dev).manual_seed(17)
    n, e_loc, tiles, tm, f, d = 4, 3, 12, 8, 96, 136
    bf = dict(device=dev, dtype=torch.bfloat16)
    w = torch.randn(n * e_loc, f, d, generator=g, **bf).view(n, e_loc, f, d)
    x = torch.randn(n, tiles * tm, d, generator=g, **bf)
    te = torch.randint(0, e_loc, (n, tiles), generator=g, device=dev,
                       dtype=torch.int32)
    used = torch.tensor([[12], [5], [0], [1]], dtype=torch.int32, device=dev)
    shared = torch.tensor([3, 0, 2], dtype=torch.int32, device=dev)
    for te_, used_ in ((te, used), (te[1].contiguous(), shared)):
        got = group_gemm.grouped_gemm_tiles(x, w, te_, used=used_)
        _assert_close(got, group_gemm.grouped_gemm_tiles_ref(
            x, w, te_, used=used_), GG_TOL)
        assert not got[2].any() if used_ is used else True


def _ep_engine_cfg():
    return ModelConfig.tiny_moe(vocab_size=512, hidden_size=256,
                                num_attention_heads=8, num_key_value_heads=4,
                                head_dim=32, num_experts=16,
                                num_experts_per_tok=4,
                                moe_intermediate_size=128)


@pytest.mark.parametrize("transport,capacity", [("ll", None),
                                                ("ragged", None),
                                                ("ar", 64)])
def test_ep_engine_launches_the_ep_kernels(dev, transport, capacity):
    """A 2-layer tp = 4 EP engine on the card: a prefill layer launches
    row 18 three times (tokens and expert ids out, outputs back) and row
    17 twice (gate/up, down); an "ll" decode layer row 23 twice and row 17
    twice, a "ragged" one row 18 three times and row 17 twice, an "ar" one
    nothing; logits finite and within 0.1 of the same engine on CPU
    copies of the weights."""
    import copy

    from triton_dist_tpu_torch import Engine, make_mesh
    from triton_dist_tpu_torch.models import qwen_moe
    from triton_dist_tpu_torch.ops import all_to_all as a2a
    from triton_dist_tpu_torch.ops import low_latency as ll

    cfg = _ep_engine_cfg()
    g = torch.Generator(device=dev).manual_seed(3)
    params = qwen_moe.init_params(cfg, generator=g, device=dev)
    ids = torch.randint(0, 512, (2, 64), generator=g, device=dev)
    kernels = (a2a.KERNEL, ll.KERNEL, group_gemm.KERNEL)
    kw = dict(mode="fused", max_len=80, moe_impl="ep",
              ep_transport=transport, ep_capacity=capacity)
    eng = Engine(cfg, mesh=make_mesh(tp=4), params=params, **kw)
    before = [k.launches for k in kernels]
    logits, cache = eng.prefill(ids)
    layers = cfg.num_hidden_layers
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        3 * layers, 0, 2 * layers]
    before = [k.launches for k in kernels]
    step, _ = eng.decode(torch.argmax(logits, -1), cache)
    want = {"ll": [0, 2, 2], "ragged": [3, 0, 2], "ar": [0, 0, 0]}[transport]
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        v * layers for v in want]
    cpu = Engine(cfg, mesh=make_mesh(tp=4, device="cpu"),
                 params=copy.deepcopy(params).cpu(), **kw)
    want_logits, want_cache = cpu.prefill(ids.cpu())
    want_step, _ = cpu.decode(torch.argmax(want_logits, -1), want_cache)
    for got, ref in ((logits, want_logits), (step, want_step)):
        assert bool(torch.isfinite(got).all())
        assert float((got.cpu() - ref).abs().max()) < 0.1


def test_ep_layer_never_syncs_the_host(dev):
    """``ep_moe.fwd`` (drop-free) and the "ll" decode: device ops and
    kernel launches only."""
    from triton_dist_tpu_torch import make_mesh
    from triton_dist_tpu_torch.layers import ep_moe
    from triton_dist_tpu_torch.ops.ep_a2a import create_ep_context

    cfg = _ep_engine_cfg()
    g = torch.Generator(device=dev).manual_seed(4)
    moe = ep_moe.init(cfg, generator=g, device=dev)
    ctx = create_ep_context(make_mesh(tp=4), num_experts=16, topk=4,
                            axis="tp")
    x = torch.randn(4, 32, 256, generator=g, device=dev,
                    dtype=torch.bfloat16)
    xd = x[:, :4].contiguous()
    xd[1:] = xd[0]
    runs = (lambda: ep_moe.fwd(moe, x, ctx, topk=4),
            lambda: ep_moe.fwd_decode(moe, xd, topk=4, axis="tp",
                                      transport="ll", ep_ctx=ctx, layer=1))
    wants = [fn() for fn in runs]                    # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gots = [fn() for fn in runs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for got, want in zip(gots, wants):
        assert torch.equal(got, want)


# ---- hierarchical (outer x inner) tensor parallelism (rows 1, 4, 5, 9, 12)

def test_collective_kernels_match_plain_on_both_axes(dev):
    """Rows 1, 4 and 5 over each axis of a 2 x 2 and a 4 x 2 mesh, at odd
    chunk sizes (a piece not filling its 8 KiB): bit for bit against their
    plain versions (the ring and the fixed position order are the same
    sums), ten launches in a row on alternating inputs; a planted wrong
    chunk or dropped partial shows, and a lost signal raises naming its
    hop, the next call sound."""
    from triton_dist_tpu_torch import make_mesh
    from triton_dist_tpu_torch.ops import allgather as agm
    from triton_dist_tpu_torch.ops import allreduce as arm
    from triton_dist_tpu_torch.ops import reduce_scatter as rsm
    from triton_dist_tpu_torch.shmem.workspace import CommTimeoutError

    g = torch.Generator(device=dev).manual_seed(21)
    for dp, tp in ((2, 2), (4, 2)):
        mesh = make_mesh(dp=dp, tp=tp)
        r = dp * tp
        for axis in ("dp", "tp"):
            n = mesh.size(axis)
            for op, ref, shape in (
                    (agm.all_gather, agm.all_gather_ref, (r, 3, 1096)),
                    (rsm.reduce_scatter, rsm.reduce_scatter_ref,
                     (r, 3 * n, 1096)),
                    (arm.all_reduce, arm.all_reduce_ref, (r, 4, 4104))):
                xs = [torch.randn(*shape, generator=g, device=dev,
                                  dtype=torch.bfloat16) for _ in range(2)]
                wants = [ref(x, ctx=mesh, axis=axis) for x in xs]
                for k in range(10):
                    got = op(xs[k % 2], ctx=mesh, axis=axis)
                    assert torch.equal(got, wants[k % 2]), (op, axis, k)
                bad = op(xs[0], ctx=mesh, axis=axis, fault=1, check=True)
                assert not torch.equal(bad, wants[0]), (op, axis)
                hop = "outer" if axis == "dp" else "inner"
                with pytest.raises(CommTimeoutError,
                                   match=rf"axis '{axis}' \({hop} hop\)"):
                    op(xs[0], ctx=mesh, axis=axis, fault=2, timeout_s=0.05,
                       check=True)
                assert torch.equal(op(xs[0], ctx=mesh, axis=axis,
                                      check=True), wants[0])


def test_hierarchical_fused_gemms_match_plain(dev):
    """Rows 9 and 12 on 2 x 2 and 2 x 4 meshes, decode and prefill tiles,
    within one bf16 unit of their plain versions (row 9's gathered A bit
    for bit); JAX's per-hop put counts (each rank n_o·(n_in - 1) inner
    puts and n_o - 1 outer ones, a flat ring would make n - 1 of one
    kind); every planted fault caught on each hop, a lost outer-hop signal
    raising and naming that hop."""
    from triton_dist_tpu_torch import make_mesh
    from triton_dist_tpu_torch.ops import ag_gemm as ag
    from triton_dist_tpu_torch.ops import gemm_rs as rs
    from triton_dist_tpu_torch.ops.tp_gemm import column_shards, row_shards
    from triton_dist_tpu_torch.shmem.workspace import CommTimeoutError

    g = torch.Generator(device=dev).manual_seed(22)
    bf = dict(device=dev, dtype=torch.bfloat16)
    tol = (1e-2, 2.0 ** -7)
    for (n_o, n_in), m_loc, k in (((2, 2), 8, 256), ((2, 2), 160, 512),
                                  ((2, 4), 136, 256)):
        mesh = make_mesh(dp=n_o, tp=n_in)
        n = n_o * n_in
        want_puts = [n * n_o * (n_in - 1), n * (n_o - 1)]
        a = torch.randn(n, m_loc, k, generator=g, **bf)
        b = column_shards(torch.randn(n * 72, k, generator=g, **bf)
                          * k ** -0.5, n)
        ctx = ag.create_ag_gemm_context(mesh, ("dp", "tp"))
        puts = torch.zeros(2, dtype=torch.int64, device=dev)
        out, ga = ag.ag_gemm(a, b, ctx, return_ag=True, puts=puts, check=True)
        want = ag.ag_gemm_ref(a, b)
        _assert_close(out, want, tol)
        assert torch.equal(ga, a.reshape(-1, k).expand_as(ga))
        assert puts.tolist() == want_puts
        a2 = torch.randn(n, n * m_loc, k, generator=g, **bf)
        b2 = row_shards(torch.randn(200, n * k, generator=g, **bf)
                        * (n * k) ** -0.5, n)
        ctx2 = rs.create_gemm_rs_context(mesh, ("dp", "tp"))
        puts.zero_()
        got = rs.gemm_rs(a2, b2, ctx2, puts=puts, check=True)
        want2 = rs.gemm_rs_2d_ref(a2, b2, n_o, n_in)
        _assert_close(got, want2, tol)
        assert puts.tolist() == want_puts
        for mod, fn, args, w in ((ag, ag.ag_gemm, (a, b, ctx), want),
                                 (rs, rs.gemm_rs, (a2, b2, ctx2), want2)):
            for hop in ("inner", "outer"):
                bad = fn(*args, fault=mod.FAULTS_2D[f"wrong_chunk_{hop}"],
                         check=True)
                err = (bad.float() - w.float()).abs()
                assert bool((err > tol[0] + tol[1] * w.float().abs()).any())
                with pytest.raises(CommTimeoutError, match=f"{hop} hop"):
                    fn(*args, fault=mod.FAULTS_2D[f"lost_signal_{hop}"],
                       timeout_s=0.05, check=True)
                _assert_close(fn(*args, check=True), w, tol)


def test_tp_megakernel_matches_plain(dev):
    """The multi-rank megakernel (row 27's ALLREDUCE task) at tp = 2 and 4
    over 2 layers of a 16-head, 4-KV-head config: a paged decode step (3
    rows, one parked, a shuffled table) and a 16-row chunk, each ONE
    launch for every rank, within the megakernel limits of its plain
    interpreter, every pool row it did not write unchanged; then a planted
    lost ALLREDUCE signal raises CommTimeoutError naming the task (within
    its bound, the process keeping its CUDA context: the next launch is
    right again), and a slab put into the wrong slot falls outside the
    limits; the first ALLREDUCE alone equals its plain version bit for
    bit."""
    from triton_dist_tpu_torch import make_mesh
    from triton_dist_tpu_torch.ops.chunked_prefill import chunk_row_codes
    from triton_dist_tpu_torch.shmem.workspace import CommTimeoutError

    cfg = ModelConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=16,
                      num_key_value_heads=4, head_dim=128)
    max_len, page, b = 256, 32, 3
    g = torch.Generator(device=dev).manual_seed(27)
    params = dense.init_params(cfg, generator=g, device=dev,
                               dtype=torch.bfloat16)
    rng = np.random.RandomState(27)
    for n in (2, 4):
        mesh = make_mesh(tp=n)
        for rows in (b, 16):
            kw = dict(mesh=mesh, max_len=max_len, t_tile=page, paged=True,
                      page=page)
            if rows == b:
                mb = mkb.ModelBuilder(cfg, batch=b, **kw)
                lens = np.array([0, 37, 130], np.int32)      # row 0 parked
                table = (rng.permutation(b * mb.p_max) + 1).astype(np.int32)
                table[:mb.p_max] = 0
                n_pages = 1 + b * mb.p_max
            else:
                mb = mkb.ModelBuilder(cfg, batch=rows, seq=rows, chunk=True,
                                      **kw)
                lens = chunk_row_codes(CHUNK_START, rows, rows - 1,
                                       CHUNK_WFROM)
                table = (rng.permutation(mb.p_max) + 1).astype(np.int32)
                n_pages = 1 + mb.p_max
            arena = mb.pack_arena(params, dtype=torch.bfloat16, device=dev)
            assert tuple(arena.shape[:1]) == (n,)
            shape = (2, n_pages, page, 4, 128)
            kc = torch.randn(shape, generator=g, device=dev,
                             dtype=torch.bfloat16)
            vc = torch.randn(shape, generator=g, device=dev,
                             dtype=torch.bfloat16)
            toks = rng.randint(0, cfg.vocab_size, rows).astype(np.int32)
            kc0, vc0, a0 = kc.clone(), vc.clone(), arena.clone()
            a2, k2, v2 = arena.clone(), kc.clone(), vc.clone()
            before = mkb.KERNEL.launches
            got = mb.step(arena, kc, vc, toks, lens, table)
            assert mkb.KERNEL.launches == before + 1
            want = mb.plain_step(a2, k2, v2, toks, lens, table)
            print(f"[mk-card] tp={n} rows={rows}:", end=" ")
            _check_mk(got, want, kc, vc, k2, v2, kc0, vc0)
            args = (toks, lens, table)
            with pytest.raises(CommTimeoutError, match="ALLREDUCE #3"):
                mb.launch(a0.clone(), kc0.clone(), vc0.clone(), *args,
                          timeout_s=0.2, fault=mkb.AR_FAULTS["lost_signal"],
                          fault_ar=3)
                mb.wait(dev)
            bad_args = dict(fault=mkb.AR_FAULTS["wrong_slot"], fault_rank=1,
                            fault_ar=1)
            arena_b = a0.clone()
            mb.launch(arena_b, kc0.clone(), vc0.clone(), *args, **bad_args)
            mb.wait(dev)
            bad = mb.logits(arena_b)
            err = (bad - want).abs()
            assert bool((err > MK_LOGITS_TOL[0]
                         + MK_LOGITS_TOL[1] * want.abs()).any())
            again = mb.step(a0.clone(), kc0.clone(), vc0.clone(), *args)
            _assert_close(again, want, MK_LOGITS_TOL)
        # The first ALLREDUCE alone (ordinal 0: no earlier one to wait
        # for) on random slabs: the same fp32 order, one rounding, so bit
        # for bit against the plain reduction.
        from triton_dist_tpu_torch.megakernel import kernels as mkk
        from triton_dist_tpu_torch.megakernel.task import TaskType

        t_ar = int(np.flatnonzero(mb.type_of == int(TaskType.ALLREDUCE))[0])
        task_args = mb.graph.tasks[t_ar].args
        buf, rows = task_args[0], mb.ar_max_tiles * mb.batch
        arena = a0.clone()
        arena[:, buf:buf + rows] = torch.randn(
            n, rows, 128, generator=g, device=dev).to(arena.dtype)
        plain = arena.clone()
        one = mb.isolate([t_ar])
        one.launch(arena, kc0.clone(), vc0.clone(), *args)
        one.wait(dev)
        mkk.allreduce_ranks(mb.kernel_config(), task_args, [
            mkk.StepState(arena=a, k_cache=None, v_cache=None, tokens=[],
                          lens=[], table=None, rank=r)
            for r, a in enumerate(plain)])
        assert torch.equal(arena[:, buf:buf + rows], plain[:, buf:buf + rows])


# ---- sequence parallelism (rows 28-31) -------------------------------------

SP_GEMM_TOL = (1e-3, 2.0 ** -7)   # one bf16 unit: both sum in fp32, round once
# Row 31: the flash-attention limit (two units): the kernel rounds
# unnormalised probabilities to bf16 for P·V, its plain version normalised
# ones (JAX's kernel and oracle, each).
SP_ATTN_TOL = QBLOCK_TOL


def _sp_cases(dev):
    """Rows 28-31 at odd shapes (row blocks and tiles cut short, n = 3):
    for each row a list of (label, kernel call taking ``fault``/
    ``timeout_s``/``check``, plain version, tolerance)."""
    import importlib

    from triton_dist_tpu_torch import make_mesh
    from triton_dist_tpu_torch.ops import ulysses_fused as uf

    ag = importlib.import_module("triton_dist_tpu_torch.ops.a2a_gemm")
    spa = importlib.import_module("triton_dist_tpu_torch.ops.sp_ag_attention")
    g = torch.Generator(device=dev).manual_seed(31)
    bf = dict(device=dev, dtype=torch.bfloat16)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, **bf) * scale

    cases = {28: [], 29: [], 30: [], 31: []}
    for n in (2, 3):
        mesh = make_mesh(sp=n)
        x = rnd(n, n, 130, 136)
        w = rnd(200, 136, scale=136 ** -0.5)
        w_ranks = rnd(n, 200, 136, scale=136 ** -0.5)
        for mode in ("a2a", "identity"):
            ctx = ag.create_a2a_gemm_context(mesh, "sp", swizzle_mode=mode)
            cases[28].append((
                f"n={n} {mode}",
                lambda ctx=ctx, x=x, w=w, **kw: ag.a2a_gemm_fused(
                    x, w, ctx, **kw),
                lambda x=x, w=w: ag.a2a_gemm_ref(x, w), SP_GEMM_TOL))
        cases[28].append((
            f"n={n} per-rank weights",
            lambda ctx=ag.create_a2a_gemm_context(mesh, "sp"), x=x,
            w=w_ranks, **kw: ag.a2a_gemm_fused(x, w, ctx, **kw),
            lambda x=x, w=w_ranks: ag.a2a_gemm_ref(x, w), SP_GEMM_TOL))
        uctx = uf.create_ulysses_fused_context(mesh, "sp")
        xs = rnd(n, 131, 136)
        wq = rnd(n, 72, 136, scale=136 ** -0.5)
        cases[29].append((f"n={n}", lambda xs=xs, wq=wq, uctx=uctx, **kw:
                          uf.qkv_gemm_a2a(xs, wq, uctx, **kw),
                          lambda xs=xs, wq=wq: uf.qkv_gemm_a2a_ref(xs, wq),
                          SP_GEMM_TOL))
        o = rnd(n, n * 131, 40)
        wo = uf.group_o_rows(rnd(200, n * 40, scale=(n * 40) ** -0.5), n=n,
                             num_heads=n, head_dim=40)
        for mode in ("a2a", "identity"):
            c = uf.create_ulysses_fused_context(mesh, "sp", swizzle_mode=mode)
            cases[30].append((f"n={n} {mode}", lambda o=o, wo=wo, c=c, **kw:
                              uf.o_a2a_gemm(o, wo, c, **kw),
                              lambda o=o, wo=wo: uf.o_a2a_gemm_ref(o, wo),
                              SP_GEMM_TOL))
    for n, hd in ((2, 64), (4, 8), (4, 128)):
        mesh = make_mesh(sp=n)
        s_loc = 100
        q = rnd(n, s_loc, 8, hd)
        k, v = rnd(n, s_loc, 2, hd), rnd(n, s_loc, 2, hd)
        cu = torch.tensor([0, 37, 37 + s_loc, n * s_loc - 3, n * s_loc],
                          dtype=torch.int32, device=dev)
        for name, causal, c in (("causal", True, None),
                                ("non-causal", False, None),
                                ("varlen", True, cu)):
            cases[31].append((
                f"n={n} hd={hd} {name}",
                lambda q=q, k=k, v=v, mesh=mesh, causal=causal, c=c, **kw:
                spa.sp_ag_attention_fused(q, k, v, ctx=mesh, causal=causal,
                                          cu_seqlens=c, **kw),
                lambda q=q, k=k, v=v, causal=causal, c=c:
                spa.sp_ag_attention_ref(q, k, v, causal=causal,
                                        cu_seqlens=c), SP_ATTN_TOL))
    return cases


@pytest.mark.parametrize("row", [28, 29, 30, 31])
def test_sp_kernel_matches_plain_repeats_faults_and_never_syncs(dev, row):
    """Each case within its limit of the plain version, then 20 launches
    cycling through every case of the row (no launch has the inputs of the
    one before it) with the host never synchronised; the first case with
    its planted fault (a wrong chunk, key rows one position down) outside
    the limit and a signal never sent raising CommTimeoutError within 5 s,
    the next launch sound."""
    from triton_dist_tpu_torch.shmem.workspace import CommTimeoutError

    cases = _sp_cases(dev)[row]
    wants = [plain() for _, _, plain, _ in cases]
    for (label, call, _, tol), want in zip(cases, wants):
        print(f"[sp-card] row {row} {label}")
        _assert_close(call(check=True), want, tol)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gots = [(i % len(cases), cases[i % len(cases)][1]())
                for i in range(20)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for i, got in gots:
        _assert_close(got, wants[i], cases[i][3])
    _, call, _, tol = cases[0]
    bad = call(fault=1, check=True)
    diff = (bad.float() - wants[0].float()).abs()
    assert bool((diff > tol[0] + tol[1] * wants[0].float().abs()).any())
    t0 = time.perf_counter()
    with pytest.raises(CommTimeoutError, match="rank 1 waited"):
        call(fault=2, timeout_s=0.1, check=True)
    assert time.perf_counter() - t0 < 5.0
    _assert_close(call(check=True), wants[0], tol)


# ---- the pipeline slice: rows 32, 33, 2, 6 and layers.pp_comm ---------------

def _pp_cases(dev, row):
    """(label, mesh, axis, call(**kw), plain(), ring) for each case of
    ``row`` (ring: row 1 on the same input, for row 2 where it runs):
    n = 2, 3, 4 and 8 ranks (row 6 at 2, 4 and 8), the pp axis of a 2 x 4
    mesh, byte counts that are and are not multiples of 16 (odd ones for
    the copies), pieces past the first 8 KiB."""
    from triton_dist_tpu_torch import make_mesh
    from triton_dist_tpu_torch.ops import allgather as agm
    from triton_dist_tpu_torch.ops import allreduce as arm
    from triton_dist_tpu_torch.ops import p2p

    bc = importlib.import_module("triton_dist_tpu_torch.ops.broadcast")
    g = torch.Generator(device=dev).manual_seed(row)

    def rows(r, *shape, dtype=torch.bfloat16):
        if dtype == torch.uint8:
            return torch.randint(0, 256, (r, *shape), generator=g,
                                 device=dev, dtype=dtype)
        return torch.randn(r, *shape, generator=g, device=dev).to(dtype)

    meshes = [(make_mesh(pp=n), "pp") for n in (2, 3, 4, 8)]
    meshes.append((make_mesh(dp=2, pp=4), "pp"))
    cases = []
    for mesh, axis in meshes:
        n, r = mesh.size(axis), mesh.n_ranks
        shapes = [((5, 3), torch.uint8), ((7, 1001), torch.bfloat16),
                  ((3, 4096), torch.bfloat16)]
        for shape, dtype in shapes:
            x = rows(r, *shape, dtype=dtype)
            lab = f"n={n} R={r} {tuple(shape)} {dtype}"
            if row == 32:
                for perm in ([(i, (i + 1) % n) for i in range(n)],
                             [(0, n - 1)], [(0, 1), (0, n - 1)]):
                    if len({d for _, d in perm}) < len(perm):
                        continue
                    cases.append((f"{lab} perm {perm}", mesh, axis,
                                  lambda x=x, p=perm, m=mesh, **kw:
                                  p2p.p2p_put(x, p, ctx=m, axis="pp", **kw),
                                  lambda x=x, p=perm, m=mesh:
                                  p2p.ppermute_ref(x, p, ctx=m, axis="pp"),
                                  None))
            elif row == 33:
                for root in (0, n - 1):
                    cases.append((f"{lab} root {root}", mesh, axis,
                                  lambda x=x, o=root, m=mesh, **kw:
                                  bc.broadcast(x, o, ctx=m, axis="pp", **kw),
                                  lambda x=x, o=root, m=mesh:
                                  bc.broadcast_ref(x, o, ctx=m, axis="pp"),
                                  None))
            elif row == 2:
                cases.append((lab, mesh, axis,
                              lambda x=x, m=mesh, **kw: agm.all_gather(
                                  x, ctx=m, axis="pp", mode="full_mesh",
                                  **kw),
                              lambda x=x, m=mesh: agm.all_gather_ref(
                                  x, ctx=m, axis="pp"),
                              (lambda x=x, m=mesh: agm.all_gather(
                                  x, ctx=m, axis="pp"))
                              if x[0].numel() * x.element_size() % 16 == 0
                              else None))
        if row == 6 and n in (2, 4, 8):
            for shape, dtype in (((4 * n, 1096), torch.bfloat16),
                                 ((2 * n, 3), torch.float32),
                                 ((n, 4104), torch.float32),
                                 ((8 * n, 4096), torch.bfloat16)):
                x = rows(r, *shape, dtype=dtype)
                cases.append((f"n={n} R={r} {shape} {dtype}", mesh, axis,
                              lambda x=x, m=mesh, **kw: arm.all_reduce(
                                  x, ctx=m, axis="pp", method="recursive",
                                  **kw),
                              lambda x=x, m=mesh: arm.all_reduce_rhd_ref(
                                  x, ctx=m, axis="pp"), None))
    return cases


@pytest.mark.parametrize("row", [32, 33, 2, 6])
def test_pp_kernel_matches_plain_repeats_faults_and_lost_signal(dev, row):
    """Each case bit for bit against its plain version (row 6's plain
    version sums in the kernel's tree order, rounding each step), one
    launch a call; then 20 calls cycling through the cases with each
    output dropped before the next call (the caching allocator hands a
    call the block the last one wrote: row 32's ranks that receive
    nothing must read zeros all the same); every case's planted fault
    (a wrong source, a dropped partial) shows; a signal never sent raises
    CommTimeoutError within 5 s naming the waiting rank and its source,
    and the next call is sound. Row 2 equals row 1's ring where both
    run."""
    from triton_dist_tpu_torch.ops import allgather as agm
    from triton_dist_tpu_torch.ops import allreduce as arm
    from triton_dist_tpu_torch.ops import p2p
    from triton_dist_tpu_torch.shmem.workspace import CommTimeoutError

    bc = importlib.import_module("triton_dist_tpu_torch.ops.broadcast")
    kernel = {32: p2p.KERNEL, 33: bc.KERNEL, 2: agm.KERNEL_FULL_MESH,
              6: arm.KERNEL_RHD}[row]
    cases = _pp_cases(dev, row)
    wants = [case[4]() for case in cases]
    for (label, mesh, axis, call, _, ring), want in zip(cases, wants):
        before = kernel.launches
        got = call(check=True)
        assert kernel.launches == before + 1, label
        assert torch.equal(got, want), label
        if ring is not None:
            assert torch.equal(ring(), want), label
        bad = call(fault=1, check=True)
        assert not torch.equal(bad, want), label
        t0 = time.perf_counter()
        with pytest.raises(CommTimeoutError, match=r"rank \d+ waited.*rank"):
            call(fault=2, timeout_s=0.05, check=True)
        assert time.perf_counter() - t0 < 5.0, label
        assert torch.equal(call(check=True), want), label
    for i in range(20):
        k = (7 * i) % len(cases)
        assert torch.equal(cases[k][3](), wants[k]), (i, cases[k][0])
    torch.cuda.synchronize()


def test_gpipe_pallas_matches_xla_and_never_syncs(dev):
    """``gpipe_forward`` over ``make_mesh(pp=4)`` with a ``tanh(h @ w)``
    stage: ``impl="pallas"`` (row 32 at every tick, M + S - 1 launches,
    the host never synchronised) bit for bit against ``impl="xla"``, both
    collects; the same on the pp axis of a 2 x 4 mesh; ``send_next``
    without a mesh launches row 32 over the leading dimension."""
    from triton_dist_tpu_torch import make_mesh
    from triton_dist_tpu_torch.layers import pp_comm
    from triton_dist_tpu_torch.ops import p2p

    g = torch.Generator(device=dev).manual_seed(33)
    for dp, m in ((1, 8), (2, 3)):
        mesh = make_mesh(dp=dp, pp=4) if dp > 1 else make_mesh(pp=4)
        r = mesh.n_ranks
        w = torch.randn(r, 64, 64, generator=g, device=dev,
                        dtype=torch.bfloat16) * 0.125
        x_mb = torch.randn(m, 5, 64, generator=g, device=dev,
                           dtype=torch.bfloat16)

        def stage(h, w=w):
            return torch.tanh(torch.bmm(h, w))

        for collect in ("broadcast", "last"):
            want = pp_comm.gpipe_forward(stage, x_mb, ctx=mesh, impl="xla",
                                         collect=collect)
            torch.cuda.synchronize()
            before = p2p.KERNEL.launches
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = pp_comm.gpipe_forward(stage, x_mb, ctx=mesh,
                                            impl="pallas", collect=collect)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert p2p.KERNEL.launches - before == m + 4 - 1
            assert torch.equal(got, want), (dp, collect)
    # Without a mesh, "pallas" still launches row 32, over the leading
    # dimension as one axis: no quiet fall back to the plain roll.
    before = p2p.KERNEL.launches
    got = pp_comm.send_next(x_mb, impl="pallas")
    assert p2p.KERNEL.launches == before + 1
    assert torch.equal(got, x_mb.roll(1, 0))
