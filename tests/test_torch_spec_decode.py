"""Speculative decoding on the layer lane of the PyTorch port against the
JAX package, on the CPU in fp32.

- ``NgramDraft.propose`` and ``accept_greedy`` on seeded histories: exact.
- ``block_attend`` (the verify attention over gathered views) against
  JAX's, fp32 atol 1e-5.
- The spec server (``spec_k`` 2 and 4, dense and MoE tiny) against the
  JAX spec server and the port's non-spec server on the same weights:
  greedy tokens IDENTICAL, and decode dispatches equal to JAX's. The
  traces put an EOS and a token budget below K mid-block, a pool small
  enough to preempt a request mid-draft, and prefix-shared pages that the
  rollback's ``truncate_to`` must never free.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import qwen_moe as jqwen_moe
from triton_dist_tpu.models.config import ModelConfig as JaxConfig
from triton_dist_tpu.ops.chunked_prefill import (
    block_attend as jax_block_attend,
)
from triton_dist_tpu.serving import ServingEngine as JaxServingEngine
from triton_dist_tpu.serving.spec import NgramDraft as JaxDraft
from triton_dist_tpu.serving.spec import accept_greedy as jax_accept

from triton_dist_tpu_torch.models import Engine, ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.ops.chunked_prefill import block_attend
from triton_dist_tpu_torch.serving.spec import NgramDraft, accept_greedy

KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, head_dim=8)
MOE_KW = dict(KW, num_experts=4, num_experts_per_tok=2,
              moe_intermediate_size=32)
MAX_LEN, PAGE = 48, 8


def test_draft_and_acceptance_match_jax():
    rng = np.random.RandomState(0)
    for n in (1, 2, 3):
        draft, jdraft = NgramDraft(n), JaxDraft(n)
        for _ in range(60):
            hist = [int(t) for t in rng.randint(0, 5, rng.randint(0, 24))]
            for k in (0, 1, 3, 5):
                assert draft.propose(hist, k) == jdraft.propose(hist, k)
    for _ in range(200):
        k = int(rng.randint(1, 6))
        d = [int(t) for t in rng.randint(0, 3, k)]
        g = [int(t) for t in rng.randint(0, 3, k)]
        assert accept_greedy(d, g) == jax_accept(d, g)
    assert NgramDraft(2).propose([1, 2, 3, 9, 2, 3], 2) == [9, 2]
    with pytest.raises(ValueError):
        NgramDraft(0)


def test_block_attend_matches_jax():
    rng = np.random.RandomState(1)
    s, k, h, kvh, hd, t = 3, 4, 4, 2, 8, 16
    q = rng.randn(s, k, h, hd).astype(np.float32)
    kd, vd = (rng.randn(s, t, kvh, hd).astype(np.float32) for _ in range(2))
    lens = np.asarray([0, 5, 11], np.int32)
    live = np.asarray([0, 1, 1], np.int32)
    want = jax_block_attend(*map(jnp.asarray, (q, kd, vd, lens, live)))
    got = block_attend(*map(torch.from_numpy, (q, kd, vd, lens, live)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same fp32 weights, dense and MoE."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jd = JaxEngine(JaxConfig.tiny(**KW), mesh, mode="xla", dtype=jnp.float32,
                   max_len=MAX_LEN, seed=3)
    jcfg = JaxConfig.tiny_moe(**MOE_KW)
    jm = JaxEngine(jcfg, mesh, mode="xla", dtype=jnp.float32, max_len=MAX_LEN,
                   params=jqwen_moe.init_params(jax.random.PRNGKey(5), jcfg),
                   model=jqwen_moe)
    out = {}
    for name, jeng, cfg in (("dense", jd, ModelConfig.tiny(**KW)),
                            ("moe", jm, ModelConfig.tiny_moe(**MOE_KW))):
        params = from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                                 "cpu", torch.float32)
        out[name] = (jeng, Engine(cfg, device="cpu", dtype=torch.float32,
                                  max_len=MAX_LEN, params=params))
    return out


SHARED = list(range(1, PAGE + 1))           # exactly one full page


def _trace(vocab):
    """(prompt, kwargs) per request: two repetitive prompts (drafts get
    accepted), a budget of 3 below K, and two sharing a full prefix
    page."""
    rng = np.random.RandomState(6)
    rand = [int(t) for t in rng.randint(1, vocab, 5)]
    return [([1, 2, 3, 1, 2, 3, 1, 2], dict(max_new_tokens=12)),
            ([7, 8, 7, 8, 7, 8], dict(max_new_tokens=12)),
            (rand, dict(max_new_tokens=3)),
            (SHARED + [20, 21], dict(max_new_tokens=6)),
            (SHARED + [30], dict(max_new_tokens=6))]


def _run(srv, reqs):
    hs = [srv.submit(p, **kw) for p, kw in reqs]
    srv.run()
    return [h.tokens for h in hs], hs


CASES = {
    # Prefix pages shared: rollback never frees them.
    "dense-k4-prefix": ("dense", 4, dict(prefix_reuse=True)),
    # Three usable pages for two slots: growth preempts mid-draft.
    "dense-k2-preempt": ("dense", 2, dict(num_pages=4)),
    "moe-k4": ("moe", 4, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_server_token_exact(engines, case):
    model, k, extra = CASES[case]
    jeng, teng = engines[model]
    reqs = _trace(teng.cfg.vocab_size)
    if "preempt" in case:
        reqs = [(p[:7], dict(max_new_tokens=9)) for p, _ in reqs[:2]]
    kw = dict(num_slots=2, page=PAGE, **extra)
    want, _ = _run(teng.serving(**kw), reqs)
    if "preempt" not in case:
        # EOS mid-block: the first request stops at its third token.
        eos = want[0][2]
        reqs[0] = (reqs[0][0], dict(reqs[0][1], eos_id=eos))
        want = [w[:w.index(eos) + 1] if i == 0 else w
                for i, w in enumerate(want)]
    jsrv = JaxServingEngine(jeng, spec_k=k, spec_ngram=3, **kw)
    jgot, _ = _run(jsrv, reqs)
    srv = teng.serving(spec_k=k, spec_ngram=3, **kw)
    got, hs = _run(srv, reqs)
    assert got == want
    assert got == jgot
    st, jst = srv.stats(), jsrv.stats()
    assert all(h.status == "done" for h in hs)
    assert st["decode_dispatches"] == jst["decode_dispatches"]
    for key in ("k", "drafted", "accepted", "tokens_per_dispatch"):
        assert st["spec"][key] == jst["spec"][key], key
    assert st["spec"]["accepted"] > 0
    if "prefix" in case:
        assert st["pool"]["prefix_hits"] >= 1
    if "preempt" in case:
        assert st["preemptions"] == jst["preemptions"] >= 1


def test_spec_sampled_requests_commit_one_token(engines):
    """A sampled request rides the verify dispatch but commits one token
    per dispatch from position 0's logits: its tokens are its non-spec
    run's (same per-step seed)."""
    teng = engines["dense"][1]
    req = dict(max_new_tokens=6, temperature=0.8, top_k=4, seed=11)
    base = teng.serving(num_slots=2, page=PAGE)
    hb = base.submit([3, 1, 4], **req)
    base.run()
    spec = teng.serving(num_slots=2, page=PAGE, spec_k=4)
    hs = spec.submit([3, 1, 4], **req)
    spec.run()
    assert hs.tokens == hb.tokens
    assert spec.stats()["spec"]["sampled_fallbacks"] == \
        spec.stats()["decode_dispatches"]


def test_spec_knobs(engines):
    teng = engines["dense"][1]
    with pytest.raises(ValueError, match="spec_k"):
        teng.serving(num_slots=2, page=PAGE, spec_k=-1)
    srv = teng.serving(num_slots=2, page=PAGE, spec_k=1)
    assert srv.spec_k == 0 and "spec" not in srv.stats()
