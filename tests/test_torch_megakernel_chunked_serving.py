"""The megakernel lane's chunked admission as a whole: the port's
``ServingEngine`` over a ``MegaKernelEngine`` built with
``prefill_buckets`` against the JAX package's, on the CPU in fp32.

The JAX engine (one-device mesh, Pallas in interpret mode, the tiny
config of ``tests/test_megakernel.py`` at 2 layers, paged with page 8 and
a pool of batch * p_max + 1 pages, buckets (4, 8), seed 5) draws the
weights; ``from_jax_params`` carries them to the port. Prompts of 3, 4,
5, 8 and 9 tokens sit on both sides of each bucket edge. Greedy tokens
must be IDENTICAL to the JAX server's, to the port's one-token megakernel
lane and to its layer lane on the same weights, and the chunk plans must
be the JAX server's."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.megakernel.engine import MegaKernelEngine as JaxEngine
from triton_dist_tpu.models.config import ModelConfig as JaxConfig
from triton_dist_tpu.serving import ServingEngine as JaxServingEngine

from triton_dist_tpu_torch.megakernel import MegaKernelEngine
from triton_dist_tpu_torch.models import Engine, ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.serving import ServingEngine

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=32,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=8)
CFG = ModelConfig.tiny(**KW)
BUCKETS = (4, 8)
ENGINE_KW = dict(batch=2, max_len=32, tile_w=16, t_tile=8, paged=True,
                 page=8, num_pages=2 * 4 + 1)
PROMPT_LENS, GEN = (3, 4, 5, 8, 9), 3


@pytest.fixture(scope="module")
def jax_engine():
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    return JaxEngine(JaxConfig.tiny(**KW), mesh, seed=5, keep_params=True,
                     prefill_buckets=BUCKETS, **ENGINE_KW)


@pytest.fixture(scope="module")
def params(jax_engine):
    return from_jax_params(jax.tree.map(np.asarray, jax_engine.params), CFG,
                           "cpu", torch.float32)


def _mega(params, **kw):
    return MegaKernelEngine(CFG, params=params, device="cpu",
                            dtype=torch.float32, **ENGINE_KW, **kw)


def _prompts():
    rng = np.random.RandomState(4)
    return [[int(t) for t in rng.randint(1, CFG.vocab_size, n)]
            for n in PROMPT_LENS]


def _serve(srv):
    handles = [srv.submit(p, max_new_tokens=GEN) for p in _prompts()]
    srv.run()
    return [h.tokens for h in handles], [h.chunks for h in handles]


def test_chunked_lane_token_exact(jax_engine, params):
    got, chunks = _serve(ServingEngine(_mega(params, prefill_buckets=BUCKETS),
                                       prefill_buckets=BUCKETS))
    want, jchunks = _serve(JaxServingEngine(jax_engine,
                                            prefill_buckets=BUCKETS))
    assert got == want
    assert chunks == jchunks
    assert [len(t) for t in got] == [GEN] * len(PROMPT_LENS)
    # The port's one-token megakernel lane and its layer lane agree.
    lane = ServingEngine(_mega(params)).generate(_prompts(),
                                                 max_new_tokens=GEN)
    layer = Engine(CFG, device="cpu", dtype=torch.float32, max_len=32,
                   params=params).serving(num_slots=2, page=8,
                                          prefill_buckets=BUCKETS)
    assert lane == got
    assert layer.generate(_prompts(), max_new_tokens=GEN) == got


def test_chunked_lane_counts_one_launch_per_chunk(params):
    """Every chunk is one launch and every decode tick one; the prompt's
    first token comes from its last chunk."""
    eng = _mega(params, prefill_buckets=BUCKETS)
    srv = ServingEngine(eng, prefill_buckets=BUCKETS)
    _, chunks = _serve(srv)
    st = srv.stats()
    assert st["prefill_chunks"] == sum(len(c) for c in chunks) == 7
    assert st["prefill_tokens"] == sum(PROMPT_LENS)
    assert eng.steps_done == st["prefill_chunks"] + st["decode_dispatches"]
    assert st["prefill_buckets"] == list(BUCKETS)
    assert st["prefill_cache_size"] == len(BUCKETS)
    assert st["pool"]["used_pages"] == 0, "all pages recycled"


def test_prefix_reuse_never_rewrites_resident_pages(params):
    """The second sharer's stream starts past the resident prefix, its
    attend-only codes leave the shared pages' bytes untouched, and tokens
    equal the one-token lane's."""
    shared = [int(t) for t in np.random.RandomState(3).randint(1, 64, 16)]
    p1, p2 = shared + [30, 31], shared + [40]
    want = ServingEngine(_mega(params)).generate([p1, p2], max_new_tokens=3)
    eng = _mega(params, prefill_buckets=BUCKETS)
    srv = ServingEngine(eng, prefill_buckets=BUCKETS, prefix_reuse=True)
    h1 = srv.submit(p1, max_new_tokens=3)
    for _ in range(3):
        srv.step()                          # p1 prefilled: 8 + 8 + 4(2)
    h2 = srv.submit(p2, max_new_tokens=3)   # while h1 still decodes
    k_before, v_before = eng.k_cache.clone(), eng.v_cache.clone()
    srv.step()
    assert srv.manager.prefix_hits(h2.slot) == 2
    for pid in srv.manager.table_row(h2.slot)[:2]:
        assert torch.equal(eng.k_cache[:, int(pid)], k_before[:, int(pid)])
        assert torch.equal(eng.v_cache[:, int(pid)], v_before[:, int(pid)])
    srv.run()
    assert [h1.tokens, h2.tokens] == want
    assert h1.chunks == [(0, 8, 8), (8, 8, 8), (16, 4, 2)]
    assert h2.chunks == [(16, 4, 1)]


@pytest.mark.parametrize("engine_buckets,server_buckets",
                         [(BUCKETS, None), (None, BUCKETS), (BUCKETS, (4,))],
                         ids=["engine-only", "server-only", "different"])
def test_prefill_buckets_mismatch_raises(params, engine_buckets,
                                         server_buckets):
    eng = _mega(params, prefill_buckets=engine_buckets)
    with pytest.raises(ValueError, match="prefill_buckets mismatch"):
        ServingEngine(eng, prefill_buckets=server_buckets)
