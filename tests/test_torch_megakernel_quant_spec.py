"""Quantized pools and the Q-block verify build of the port's megakernel
engine against the JAX package's, on the CPU in fp32.

The JAX engine (one-device mesh, Pallas in interpret mode, the tiny
config at 2 layers, paged with page 8, ``kv_dtype="int8"``, ``spec_k=2``,
one chunk bucket of 4, seed 5) draws the weights; ``from_jax_params``
carries them to the port's engine, which runs its plain interpreter. The
same launches go through both: a prompt chunk, a decode step with a
ragged batch, and a verify step with a masked row. After each, the int8
pools must be EQUAL and the scales within 1e-6 relative; the logits
agree within fp32 atol 1e-4. One exception, measured: in the verify
launch a layer-1 V value lands one fp32 ulp off an exact rounding tie
(x / s = -21.5 in JAX, -21.499996 here: the layer's input sums in another
order), so that launch allows two codes one step apart and its logits
1e-3 (one V code moves this config's logits by about 7e-4). Then both
servers run the same prompts
through ``_spec_tick_mega``: greedy tokens identical, on the chunked lane
and on the port's one-token lane. The knob checks are those of the JAX
battery (``tests/test_kv_quant.py``, ``tests/test_spec_decode.py``).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.megakernel.engine import MegaKernelEngine as JaxEngine
from triton_dist_tpu.models.config import ModelConfig as JaxConfig
from triton_dist_tpu.serving import ServingEngine as JaxServingEngine

from triton_dist_tpu_torch.megakernel import MegaKernelEngine
from triton_dist_tpu_torch.megakernel import kernels as mkk
from triton_dist_tpu_torch.megakernel.builder import ModelBuilder
from triton_dist_tpu_torch.models import ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.ops.chunked_prefill import chunk_row_codes
from triton_dist_tpu_torch.serving import ServingEngine

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=32,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=8)
CFG = ModelConfig.tiny(**KW)
BUCKETS = (4,)
K = 2
ENGINE_KW = dict(batch=2, max_len=32, tile_w=16, t_tile=8, paged=True,
                 page=8, num_pages=2 * 4 + 1)
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_engine():
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    return JaxEngine(JaxConfig.tiny(**KW), mesh, seed=5, keep_params=True,
                     kv_dtype="int8", spec_k=K, prefill_buckets=BUCKETS,
                     **ENGINE_KW)


@pytest.fixture(scope="module")
def params(jax_engine):
    return from_jax_params(jax.tree.map(np.asarray, jax_engine.params), CFG,
                           "cpu", torch.float32)


def _mega(params, **kw):
    return MegaKernelEngine(CFG, params=params, device="cpu",
                            dtype=torch.float32, **ENGINE_KW, **kw)


def _assert_same_pools(jeng, teng, flips=0):
    """Codes equal but for at most ``flips`` one step apart; scales within
    1e-6 relative."""
    diff = np.concatenate([
        (tp.numpy().astype(np.int32) - np.asarray(jp).astype(np.int32))
        .ravel() for jp, tp in ((jeng.k_cache, teng.k_cache),
                                (jeng.v_cache, teng.v_cache))])
    assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= flips
    for js, ts in ((jeng.k_scale, teng.k_scale),
                   (jeng.v_scale, teng.v_scale)):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js)[..., 0],
                                   rtol=1e-6, atol=0)


def test_launches_match_jax(jax_engine, params):
    """A chunk, a decode step and a verify step: pools, scales, logits."""
    teng = _mega(params, kv_dtype="int8", spec_k=K, prefill_buckets=BUCKETS)
    assert teng.k_cache.dtype == torch.int8
    assert teng.k_scale.shape == (2, 9, 2)
    assert teng.verify_builder.mode == "qblock"
    p_max = teng.builder.p_max
    row = np.arange(p_max, dtype=np.int32)           # slot 0's table row
    # A 4-row chunk from 0 with a padding row.
    toks = np.asarray([5, 9, 3, 0], np.int32)
    codes = chunk_row_codes(0, 4, 3, 0)
    want = jax_engine.prefill_chunk(toks, codes, row)
    got = teng.prefill_chunk(toks, codes, row)
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3],
                               atol=LOGIT_ATOL, rtol=0)
    _assert_same_pools(jax_engine, teng)
    # Decode: slot 0 at 3, slot 1 at 0 (its page's first token).
    toks, lens = np.asarray([7, 2], np.int32), np.asarray([3, 0], np.int32)
    want = jax_engine.decode_step(toks, lens)
    got = teng.decode_step(toks, lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    _assert_same_pools(jax_engine, teng)
    # Verify: slot 0's two candidates at 4 and 5, slot 1's first at 1
    # and its second masked (-1: no page, no scale).
    toks = np.asarray([4, 11, 8, 6], np.int32)
    pos = np.asarray([4, 5, 1, -1], np.int32)
    want = np.asarray(jax_engine.verify_step(toks, pos))
    got = teng.verify_step(toks, pos).numpy()
    assert got.shape == (2, K, CFG.vocab_size)
    np.testing.assert_allclose(got.reshape(4, -1)[:3],
                               want.reshape(4, -1)[:3], atol=1e-3, rtol=0)
    _assert_same_pools(jax_engine, teng, flips=2)


def _prompts():
    rng = np.random.RandomState(4)
    rep = [1, 2, 3, 1, 2, 3]
    return [rep, [int(t) for t in rng.randint(1, CFG.vocab_size, 5)]]


def _serve(srv, gen=4):
    hs = [srv.submit(p, max_new_tokens=gen) for p in _prompts()]
    srv.run()
    return [h.tokens for h in hs]


def test_spec_serving_matches_jax(jax_engine, params):
    jsrv = JaxServingEngine(jax_engine, kv_dtype="int8", spec_k=K,
                            prefill_buckets=BUCKETS)
    want = _serve(jsrv)
    srv = ServingEngine(_mega(params, kv_dtype="int8", spec_k=K,
                              prefill_buckets=BUCKETS),
                        kv_dtype="int8", spec_k=K, prefill_buckets=BUCKETS)
    assert _serve(srv) == want
    st, jst = srv.stats(), jsrv.stats()
    assert st["decode_dispatches"] == jst["decode_dispatches"]
    assert st["spec"]["accepted"] == jst["spec"]["accepted"] > 0
    assert st["mk_spec"] == K and st["mk_kv_dtype"] == "int8"
    assert srv.plan["capacity_ratio_vs_native"] == \
        jsrv.plan["capacity_ratio_vs_native"]
    # The one-token lane: prompts ride row (slot, 0) of the verify launch.
    lane = ServingEngine(_mega(params, kv_dtype="int8", spec_k=K),
                         kv_dtype="int8", spec_k=K)
    assert _serve(lane) == want


@pytest.mark.parametrize("kvd", ["bf16", "fp8"])
def test_spec_tokens_equal_nonspec(params, kvd):
    """The port's own contract on the megakernel lane, plain path: greedy
    tokens with spec_k equal those without (bf16 pools: the verify rows'
    math is the decode rows'); fp8 pools, and the quantized lane agrees
    with the bf16 one on most tokens."""
    want = _serve(ServingEngine(_mega(params, kv_dtype=kvd), kv_dtype=kvd),
                  gen=6)
    srv = ServingEngine(_mega(params, kv_dtype=kvd, spec_k=4), kv_dtype=kvd,
                        spec_k=4)
    assert _serve(srv, gen=6) == want
    if kvd == "fp8":
        base = _serve(ServingEngine(_mega(params)), gen=6)
        assert srv.compare_greedy(zip(want, base)) >= 0.5
        assert srv.stats()["greedy_agreement"] >= 0.5


def test_quant_spec_knob_validation(params):
    with pytest.raises(ValueError, match="kv_dtype mismatch"):
        ServingEngine(_mega(params), kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype mismatch"):
        ServingEngine(_mega(params, kv_dtype="int8"), kv_dtype="fp8")
    with pytest.raises(ValueError, match="spec_k mismatch"):
        ServingEngine(_mega(params), spec_k=2)
    with pytest.raises(ValueError, match="spec_k mismatch"):
        ServingEngine(_mega(params, spec_k=2))
    kw = dict(ENGINE_KW, paged=False)
    for knob in (dict(kv_dtype="int8"), dict(spec_k=2)):
        with pytest.raises(ValueError, match="paged"):
            MegaKernelEngine(CFG, params=params, device="cpu",
                             dtype=torch.float32, **kw, **knob)
        with pytest.raises(ValueError, match="prefill_seq"):
            MegaKernelEngine(CFG, params=params, device="cpu",
                             dtype=torch.float32, prefill_seq=4,
                             **dict(ENGINE_KW, num_pages=None), **knob)
    with pytest.raises(ValueError, match="kv_dtype"):
        _mega(params, kv_dtype="int4")
    with pytest.raises(NotImplementedError, match="fused-quant"):
        ModelBuilder(CFG, batch=4, seq=2, max_len=32, tile_w=16, t_tile=8,
                     paged=True, page=8, kv_quant="int8")
    with pytest.raises(ValueError, match="mutually exclusive"):
        ModelBuilder(CFG, batch=4, seq=4, max_len=32, tile_w=16, t_tile=8,
                     paged=True, page=8, qblock=True, chunk=True)
    with pytest.raises(ValueError, match="K >= 2"):
        ModelBuilder(CFG, batch=2, seq=1, max_len=32, tile_w=16, t_tile=8,
                     paged=True, page=8, qblock=True)
    eng = _mega(params)
    with pytest.raises(ValueError, match="without spec_k"):
        eng.verify_step(np.zeros(4, np.int32), np.zeros(4, np.int32))
    assert eng.k_scale is None and mkk.BODIES[
        mkk.TaskType.ATTN_QBLOCK] is mkk.attn_qblock_body
