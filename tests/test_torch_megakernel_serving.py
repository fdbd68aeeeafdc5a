"""The megakernel serving lane as a whole: the port's ``ServingEngine``
over its ``MegaKernelEngine`` against the JAX package's ``ServingEngine``
over JAX's ``MegaKernelEngine``, on the CPU in fp32.

The JAX engine (one-device mesh, Pallas in interpret mode, the tiny config
of ``tests/test_megakernel.py``, paged with page 8 and a pool of
batch * p_max + 1 pages, seed 5) draws the weights; ``from_jax_params``
carries them to the port. Three requests (prompts of 3, 5 and 4 tokens,
4-5 new tokens) stream through the prefill lane and decode on two slots;
the third joins when the first finishes. Greedy tokens, tick count and
decode dispatches must be IDENTICAL."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.megakernel.engine import MegaKernelEngine as JaxEngine
from triton_dist_tpu.models.config import ModelConfig as JaxConfig
from triton_dist_tpu.serving import ServingEngine as JaxServingEngine

from triton_dist_tpu_torch.megakernel import MegaKernelEngine
from triton_dist_tpu_torch.models import ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.serving import ServingEngine

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=32,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=8)
CFG = ModelConfig.tiny(**KW)
ENGINE_KW = dict(batch=2, max_len=32, tile_w=16, t_tile=8, paged=True,
                 page=8, num_pages=2 * 4 + 1)
PROMPT_LENS, GEN = (3, 5, 4), (4, 5, 4)


@pytest.fixture(scope="module")
def engines():
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jeng = JaxEngine(JaxConfig.tiny(**KW), mesh, seed=5, keep_params=True,
                     **ENGINE_KW)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), CFG,
                             "cpu", torch.float32)
    return jeng, params


def _prompts():
    rng = np.random.RandomState(3)
    return [[int(t) for t in rng.randint(0, CFG.vocab_size, n)]
            for n in PROMPT_LENS]


def _drive(srv):
    """Two requests at once; the third joins when the first is done."""
    prompts = _prompts()
    hs = [srv.submit(p, max_new_tokens=g)
          for p, g in zip(prompts[:2], GEN[:2])]
    ticks = 0
    while not srv.sched.idle:
        if hs[0].done and len(hs) == 2:
            hs.append(srv.submit(prompts[2], max_new_tokens=GEN[2]))
        srv.step()
        ticks += 1
    return [h.tokens for h in hs], ticks, srv.stats()


def test_megakernel_serving_token_exact_with_jax(engines):
    jeng, params = engines
    teng = MegaKernelEngine(CFG, params=params, device="cpu",
                            dtype=torch.float32, **ENGINE_KW)
    got, ticks, st = _drive(ServingEngine(teng))
    want, jticks, jst = _drive(JaxServingEngine(jeng))
    assert got == want
    assert [len(t) for t in got] == list(GEN)
    assert ticks == jticks <= 15
    assert st["decode_dispatches"] == jst["decode_dispatches"] == ticks
    assert teng.steps_done == ticks
    assert st["engine_kind"] == "mega" and st["completed"] == 3
    assert st["pool"]["used_pages"] == 0, "all pages recycled"


def test_dense_megakernel_engine_is_not_served(engines):
    """The lane serves the paged engine; a dense-cache engine (one
    (max_len,) row per slot) is driven through its own decode_step."""
    _, params = engines
    eng = MegaKernelEngine(CFG, params=params, device="cpu",
                           dtype=torch.float32, batch=2, max_len=32,
                           tile_w=16, t_tile=8)
    with pytest.raises(NotImplementedError, match="paged=True"):
        ServingEngine(eng)
