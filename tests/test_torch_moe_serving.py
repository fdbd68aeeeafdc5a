"""Qwen3-MoE served on both lanes against the JAX package's server, on
the CPU in fp32.

The JAX MoE megakernel engine (one-device mesh, Pallas in interpret
mode, ``tiny_moe`` at 2 layers with 4 experts, top-2, ``tile_w=16``,
paged with page 8, buckets (4, 8), seed 5) draws the weights;
``from_jax_params`` carries them to the port, and the JAX layer engine
(``Engine(model=qwen_moe)``, mode "xla") takes the same ones. Prompts of
3, 5 and 9 tokens sit on both sides of each bucket edge. Greedy
tokens must be IDENTICAL to the JAX server's on the chunked megakernel
lane, on the one-token megakernel lane and on the layer lane, and the
megakernel server's expert totals equal to JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.megakernel.engine import MegaKernelEngine as JaxMega
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import qwen_moe as jqwen_moe
from triton_dist_tpu.models.config import ModelConfig as JaxConfig
from triton_dist_tpu.serving import ServingEngine as JaxServingEngine

from triton_dist_tpu_torch.megakernel import MegaKernelEngine
from triton_dist_tpu_torch.models import Engine, ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.serving import ServingEngine, server

KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, head_dim=8,
          num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32)
CFG = ModelConfig.tiny_moe(**KW)
JCFG = JaxConfig.tiny_moe(**KW)
BUCKETS = (4, 8)
ENGINE_KW = dict(batch=2, max_len=32, tile_w=16, t_tile=8, paged=True,
                 page=8, num_pages=2 * 4 + 1)
LAYER_SERVE = dict(num_slots=2, page=8, prefill_buckets=BUCKETS)
PROMPT_LENS, GEN = (3, 5, 9), 3


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


@pytest.fixture(scope="module")
def jax_mega(mesh):
    return JaxMega(JCFG, mesh, seed=5, keep_params=True,
                   prefill_buckets=BUCKETS, **ENGINE_KW)


@pytest.fixture(scope="module")
def params(jax_mega):
    return from_jax_params(jax.tree.map(np.asarray, jax_mega.params), CFG,
                           "cpu", torch.float32)


def _prompts():
    rng = np.random.RandomState(4)
    return [[int(t) for t in rng.randint(1, CFG.vocab_size, n)]
            for n in PROMPT_LENS]


def _serve(srv, handles=None):
    hs = [srv.submit(p, max_new_tokens=GEN) for p in _prompts()]
    srv.run()
    if handles is not None:
        handles.extend(hs)
    return [h.tokens for h in hs]


def _mega(params, **kw):
    return MegaKernelEngine(CFG, params=params, device="cpu",
                            dtype=torch.float32, **ENGINE_KW, **kw)


def test_megakernel_lanes_token_exact(jax_mega, params):
    """The chunked lane and the one-token lane against JAX's chunked
    megakernel server; the stats carry the routed totals."""
    jsrv = JaxServingEngine(jax_mega, prefill_buckets=BUCKETS)
    want = _serve(jsrv)
    eng = _mega(params, prefill_buckets=BUCKETS)
    srv = ServingEngine(eng, prefill_buckets=BUCKETS)
    handles = []
    assert _serve(srv, handles) == want
    assert [len(t) for t in want] == [GEN] * len(PROMPT_LENS)
    st, jst = srv.stats(), jsrv.stats()
    assert st["dispatch_transport"] == jst["dispatch_transport"] == \
        "in-kernel-tp"
    assert st["expert_totals"] == jst["expert_totals"]
    np.testing.assert_allclose(st["expert_load"], jst["expert_load"],
                               rtol=1e-12)
    # Every row of every launch routed top-2 in both layers, parked and
    # padding rows included; the chunk launches before the first decode
    # tick are outside the server's totals, as in the JAX server.
    chunk_rows = sum(b for h in handles for _, b, _ in h.chunks)
    assert eng.expert_counts().sum() == \
        (2 * st["decode_dispatches"] + chunk_rows) * 2 * 2
    assert 0 < sum(st["expert_totals"]) < eng.expert_counts().sum()
    lane = ServingEngine(_mega(params))
    assert _serve(lane) == want


def test_layer_lane_token_exact(mesh, jax_mega, params):
    jeng = JaxEngine(JCFG, mesh, mode="xla", dtype=jnp.float32, max_len=32,
                     params=jax_mega.params, model=jqwen_moe)
    want = _serve(JaxServingEngine(jeng, **LAYER_SERVE))
    teng = Engine(CFG, device="cpu", dtype=torch.float32, max_len=32,
                  params=params)
    srv = teng.serving(**LAYER_SERVE)
    assert _serve(srv) == want
    assert srv.stats()["dispatch_transport"] is None


def test_rebalance_reprioritizes_dynamic_engine(params, monkeypatch):
    """A rebalance every tick on a dynamic-schedule engine: a changed hot
    set re-emits the claim order, an unchanged one does not; tokens stay
    those of the static schedule."""
    want = _serve(ServingEngine(_mega(params)))
    eng = _mega(params, schedule="dynamic")
    calls = []
    set_load = eng.set_expert_load

    def recording(load):
        calls.append(None if load is None else list(load))
        set_load(load)

    eng.set_expert_load = recording
    monkeypatch.setattr(server, "REBALANCE_EVERY", 1)
    monkeypatch.setattr(server, "HOT_EXPERT_FACTOR", 1.2)
    srv = ServingEngine(eng)
    assert _serve(srv) == want
    assert calls, "a hot set never formed"
    assert len(calls) < srv.stats()["decode_dispatches"]
    assert srv._mk_load_sig is None or all(
        srv.expert_ewma[e] > 1.2 * srv.expert_ewma.mean()
        for e in srv._mk_load_sig)
