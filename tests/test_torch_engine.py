"""The dense-cache engine of the port against the JAX package's, on the
CPU in fp32: ``sdpa`` and the prefill flash attention's plain version
(``ops/flash_attention.py``), the layer's decode form, and the whole
``Engine`` (prefill, decode, serve) for dense Qwen3 and Qwen3-MoE in the
``"xla"`` and ``"fused"`` modes, plus the MoE engine's monolithic serving.

The JAX ``Engine`` (1-device mesh, fp32) draws the weights and
``from_jax_params`` carries them across; JAX's fused MoE prefill runs its
Pallas grouped GEMM in interpret mode, the port the plain version. Both
sides compute in fp32 and differ only in the order of float sums:
logits and caches within atol 1e-4 (logits of order 1), attention
outputs within 2e-6, and greedy tokens IDENTICAL."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.layers import tp_attn as jtp_attn
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models import qwen_moe as jqwen_moe
from triton_dist_tpu.serving import ServingEngine as JaxServingEngine
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch.layers import tp_attn
from triton_dist_tpu_torch.models import Engine, ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.ops.flash_attention import flash_attention_ref

ATOL = 1e-4
DENSE_KW = dict(num_key_value_heads=2)
MOE_KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=8,
              num_experts=8, num_experts_per_tok=2, moe_intermediate_size=16)
MAX_LEN = 24
CASES = [("dense", "xla"), ("dense", "fused"), ("moe", "xla"),
         ("moe", "fused")]


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


_ENGINES = {}


def _engines(mesh, family, mode):
    """JAX and port engines on the same weights (one pair per case)."""
    key = (family, mode)
    if key not in _ENGINES:
        if family == "dense":
            jcfg, cfg, kw = (JaxConfig.tiny(**DENSE_KW),
                             ModelConfig.tiny(**DENSE_KW), {})
        else:
            jcfg, cfg = JaxConfig.tiny_moe(**MOE_KW), ModelConfig.tiny_moe(
                **MOE_KW)
            kw = dict(model=jqwen_moe)
        jeng = JaxEngine(jcfg, mesh, mode=mode, dtype=jnp.float32,
                         max_len=MAX_LEN, seed=5, **kw)
        params = from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                                 "cpu", torch.float32)
        teng = Engine(cfg, mode=mode, device="cpu", dtype=torch.float32,
                      max_len=MAX_LEN, params=params)
        _ENGINES[key] = (jeng, teng)
    return _ENGINES[key]


def _prompts(vocab, b=2, s=11, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("h,kv,hd,s", [(8, 2, 8, 12), (4, 4, 16, 33),
                                       (8, 1, 8, 5)])
def test_flash_attention_ref_matches_jax_sdpa(h, kv, hd, s):
    rng = np.random.RandomState(h + s)
    q = rng.randn(2, s, h, hd).astype(np.float32)
    k = rng.randn(2, s, kv, hd).astype(np.float32)
    v = rng.randn(2, s, kv, hd).astype(np.float32)
    want = np.asarray(jtp_attn.sdpa(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_attention_ref(tq, tk, tv, causal=True, sm_scale=hd ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    np.testing.assert_allclose(tp_attn.sdpa(tq, tk, tv, causal=True).numpy(),
                               want, atol=2e-6, rtol=0)
    full = np.asarray(jtp_attn.sdpa(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=False))
    np.testing.assert_allclose(
        flash_attention_ref(tq, tk, tv, causal=False,
                            sm_scale=hd ** -0.5).numpy(), full, atol=2e-6,
        rtol=0)


def test_sdpa_plain_forms_match_jax():
    """Decode over a dense cache (per-row and per-query lengths) and a
    causal block over a cache prefix: the plain forms of ``sdpa``."""
    rng = np.random.RandomState(1)
    q = rng.randn(3, 4, 8, 8).astype(np.float32)
    k = rng.randn(3, 10, 2, 8).astype(np.float32)
    v = rng.randn(3, 10, 2, 8).astype(np.float32)
    lens = np.array([1, 7, 10], np.int32)
    per_q = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [7, 8, 9, 10]], np.int32)
    j = [jnp.asarray(a) for a in (q, k, v)]
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for kw_j, kw_t in (
            (dict(causal=False, kv_len=jnp.asarray(lens)),
             dict(causal=False, kv_len=torch.from_numpy(lens))),
            (dict(causal=False, kv_len=jnp.asarray(per_q)),
             dict(causal=False, kv_len=torch.from_numpy(per_q))),
            (dict(causal=True), dict(causal=True))):
        np.testing.assert_allclose(tp_attn.sdpa(*t, **kw_t).numpy(),
                                   np.asarray(jtp_attn.sdpa(*j, **kw_j)),
                                   atol=2e-6, rtol=0)


def test_fwd_decode_matches_jax(mesh):
    jeng, teng = _engines(mesh, "dense", "xla")
    cfg = teng.cfg
    rng = np.random.RandomState(2)
    x = rng.randn(2, cfg.hidden_size).astype(np.float32)
    kc = rng.randn(2, MAX_LEN, 2, cfg.head_dim).astype(np.float32)
    vc = rng.randn(2, MAX_LEN, 2, cfg.head_dim).astype(np.float32)
    jattn = jeng.params["layers"][0]["attn"]
    jy, (jk, jv) = spmd(
        mesh, lambda p, a, kk, vv: jtp_attn.fwd_decode(p, a, jeng.cfg, kk, vv,
                                                       9),
        (jax.tree.map(lambda _: P(), jattn), P(), P(), P()),
        (P(), (P(), P())))(jattn, jnp.asarray(x), jnp.asarray(kc),
                           jnp.asarray(vc))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ty, (tk2, tv2) = tp_attn.fwd_decode(teng.params.layers[0].attn,
                                        torch.from_numpy(x), cfg, tk, tv, 9)
    assert tk2 is tk and tv2 is tv, "the cache is written in place"
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


@pytest.mark.parametrize("family,mode", CASES)
def test_prefill_matches_jax(mesh, family, mode):
    jeng, teng = _engines(mesh, family, mode)
    ids = _prompts(teng.cfg.vocab_size)
    jl, jc = jeng.prefill(jnp.asarray(ids))
    tl, tc = teng.prefill(ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert tc.k.shape == jc.k.shape == (2, 2, MAX_LEN, 2, 8)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=ATOL,
                               rtol=0)
    assert tc.length == int(jc.length) == ids.shape[1]
    # One decode step on each side's own cache.
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    jl2, _ = jeng.decode(jnp.asarray(tok), jc)
    tl2, tc2 = teng.decode(torch.from_numpy(tok), tc)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL,
                               rtol=0)
    assert tc2 is tc and tc.length == ids.shape[1] + 1


@pytest.mark.parametrize("family,mode", CASES)
def test_serve_token_exact_with_jax(mesh, family, mode):
    jeng, teng = _engines(mesh, family, mode)
    ids = _prompts(teng.cfg.vocab_size, seed=3)
    want = np.asarray(jeng.serve(jnp.asarray(ids), gen_len=6))
    got = teng.serve(ids, gen_len=6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_moe_prefill_goes_through_fwd_fused(mesh, monkeypatch):
    """``mode="fused"`` routes every MoE prefill layer through
    ``fwd_fused`` (the grouped GEMM path), the other modes through
    ``fwd``; decode always through ``fwd_ar``."""
    from triton_dist_tpu_torch.layers import tp_moe

    calls = []
    for name in ("fwd", "fwd_fused", "fwd_ar"):
        real = getattr(tp_moe, name)
        monkeypatch.setattr(tp_moe, name, lambda *a, _n=name, _r=real,
                            **k: calls.append(_n) or _r(*a, **k))
    ids = _prompts(64, b=1, s=5)
    for mode in ("fused", "xla"):
        teng = _engines(mesh, "moe", mode)[1]
        calls.clear()
        teng.serve(ids, gen_len=2)
        want = "fwd_fused" if mode == "fused" else "fwd"
        assert calls == [want, want, "fwd_ar", "fwd_ar"], (mode, calls)


def test_max_len_guard_matches_jax(mesh):
    jeng, teng = _engines(mesh, "dense", "xla")
    ids = _prompts(teng.cfg.vocab_size, b=1, s=MAX_LEN)
    for eng, arr in ((jeng, jnp.asarray), (teng, np.asarray)):
        with pytest.raises(ValueError, match="exceeds max_len"):
            eng.serve(arr(ids[:, :20]), gen_len=5)
        logits, cache = eng.prefill(arr(ids))
        tok = arr(np.zeros((1,), np.int32))
        with pytest.raises(ValueError, match="KV cache full"):
            eng.decode(tok, cache)
    with pytest.raises(ValueError, match="top_k"):
        teng.serve(ids[:, :4], gen_len=2, top_k=-1)


def test_decode_guard_reads_each_cache(mesh):
    """The overflow guard reads the cache it is given: a long prompt on
    another cache does not stop a short one from decoding, and one decode
    of each continues the logits a prefill of the longer sequence gives."""
    _, teng = _engines(mesh, "dense", "xla")
    ids = _prompts(teng.cfg.vocab_size, b=1, s=MAX_LEN, seed=3)
    _, short = teng.prefill(ids[:, :10])
    _, full = teng.prefill(ids)
    tok = torch.as_tensor(ids[:, 10])
    logits, short = teng.decode(tok, short)
    assert short.length == 11
    want, _ = teng.prefill(ids[:, :11])
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="KV cache full"):
        teng.decode(tok, full)


def test_sampled_serve_is_seeded(mesh):
    """Sampling draws from a ``torch.Generator`` per (seed, step): the
    same seed gives the same tokens; ``top_k=1`` is greedy."""
    _, teng = _engines(mesh, "dense", "xla")
    ids = _prompts(teng.cfg.vocab_size, seed=4)
    a = teng.serve(ids, gen_len=5, temperature=0.9, seed=11)
    b = teng.serve(ids, gen_len=5, temperature=0.9, seed=11)
    assert torch.equal(a, b)
    assert bool(((a >= 0) & (a < teng.cfg.vocab_size)).all())
    assert torch.equal(teng.serve(ids, gen_len=5, temperature=0.9, top_k=1),
                       teng.serve(ids, gen_len=5))


def test_moe_monolithic_serving_matches_jax(mesh):
    """The fused MoE engine's monolithic server (``prefill_buckets=None``:
    each prompt one ``Engine.prefill``, its K/V blitted into pages) gives
    the JAX monolithic server's tokens."""
    jeng, teng = _engines(mesh, "moe", "fused")
    rng = np.random.RandomState(6)
    prompts = [[int(t) for t in rng.randint(0, 64, n)] for n in (7, 3, 12)]
    kw = dict(num_slots=2, page=4)
    want = JaxServingEngine(jeng, **kw).generate(prompts, max_new_tokens=4)
    srv = teng.serving(**kw)
    assert srv.generate(prompts, max_new_tokens=4) == want
    st = srv.stats()
    assert st["prefill_calls"] == 3 and st["prefill_chunks"] == 0
    assert st["prefill_tokens"] == 22 and st["pool"]["used_pages"] == 0


def test_monolithic_prefix_reuse_matches_jax(mesh):
    """Monolithic admission with prefix reuse: a request sharing full
    prompt pages blits only its suffix pages (the shared ones keep the
    first sharer's bytes); tokens and prefix hits equal JAX's."""
    jeng, teng = _engines(mesh, "dense", "xla")
    rng = np.random.RandomState(9)
    shared = [int(t) for t in rng.randint(0, 256, 8)]
    prompts = [shared + [int(t) for t in rng.randint(0, 256, n)]
               for n in (3, 1, 6)]
    kw = dict(num_slots=2, page=4, num_pages=17, prefix_reuse=True)
    outs, stats = [], []
    for srv in (teng.serving(**kw), JaxServingEngine(jeng, **kw)):
        first = srv.generate(prompts[:1], max_new_tokens=3)
        outs.append(first + srv.generate(prompts[1:], max_new_tokens=3))
        stats.append(srv.stats())
    assert outs[0] == outs[1]
    assert stats[0]["pool"]["prefix_hits"] == \
        stats[1]["pool"]["prefix_hits"] >= 4
    assert stats[0]["prefill_tokens"] == stats[1]["prefill_tokens"]


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        Engine(ModelConfig.tiny(), mode="ring", device="cpu",
               dtype=torch.float32)
