"""The port's HuggingFace loader against the JAX package's and against
``transformers``, on the committed checkpoints
``tests/fixtures/qwen3_tiny`` and ``qwen3_moe_tiny`` (written by the real
transformers model classes, ``tests/fixtures/make_qwen3_tiny.py``).

- ``ModelConfig.from_hf_config`` equals JAX's mapper on every field the
  port carries, and raises where JAX's would or where the port lacks the
  feature (hybrid GDN, projection biases, no q/k norm).
- The loaded weights equal JAX's ``load_hf_checkpoint`` parameters bit
  for bit (fp32; JAX stores the transpose of every linear weight).
- The port's all-token logits match transformers' within JAX's own limit
  for the same fixtures, 2e-3 (``tests/test_hf_real_checkpoint.py``).
- ``Engine.serve`` on each checkpoint gives exactly the JAX ``Engine``'s
  greedy tokens (fused mode)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import qwen_moe as jqwen_moe
from triton_dist_tpu.models.config import ModelConfig as JaxConfig
from triton_dist_tpu.models.hf_loader import (
    load_hf_checkpoint as jax_load)

from triton_dist_tpu_torch.models import Engine, ModelConfig, dense, qwen_moe
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.models.hf_loader import load_hf_checkpoint

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
DIRS = {"dense": os.path.join(FIX, "qwen3_tiny"),
        "moe": os.path.join(FIX, "qwen3_moe_tiny")}
IDS = np.array([[3, 17, 250, 9, 77, 1, 128, 64],
                [5, 5, 200, 11, 0, 42, 7, 99]], np.int32)


def _hf(name):
    with open(os.path.join(DIRS.get(name, os.path.join(FIX, name)),
                           "config.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_config_matches_jax(name):
    hf = _hf(name)
    got, want = ModelConfig.from_hf_config(hf), JaxConfig.from_hf_config(hf)
    for f in ModelConfig.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f


def test_config_rejects_what_is_not_ported():
    hf = _hf("dense")
    for field in ("hidden_size", "vocab_size", "num_hidden_layers"):
        bad = {k: v for k, v in hf.items() if k != field}
        with pytest.raises(KeyError, match=field):
            ModelConfig.from_hf_config(bad)
    with pytest.raises(NotImplementedError, match="MoE schedule"):
        ModelConfig.from_hf_config(dict(_hf("moe"), decoder_sparse_step=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ModelConfig.from_hf_config(_hf("qwen3_next_tiny"))
    with pytest.raises(NotImplementedError, match="attention_bias"):
        ModelConfig.from_hf_config(dict(hf, attention_bias=True))
    with pytest.raises(NotImplementedError, match="qk_norm"):
        ModelConfig.from_hf_config(dict(hf, model_type="qwen2",
                                        attention_bias=False))


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_weights_match_jax_bit_for_bit(name):
    cfg, got = load_hf_checkpoint(DIRS[name], torch.float32, "cpu")
    jcfg, jparams = jax_load(DIRS[name], dtype=jnp.float32)
    want = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu",
                           torch.float32)
    assert type(got) is type(want)
    sd_got, sd_want = got.state_dict(), want.state_dict()
    assert sd_got.keys() == sd_want.keys()
    for k in sd_got:
        assert torch.equal(sd_got[k], sd_want[k]), k
    assert got.embed.device.type == "cpu" and got.embed.dtype == torch.float32


def _transformers_logits(path):
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(path).float().eval()
    with torch.no_grad():
        return model(torch.from_numpy(IDS).long()).logits.numpy()


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_logits_match_transformers(name):
    cfg, params = load_hf_checkpoint(DIRS[name], torch.float32, "cpu")
    model = qwen_moe if cfg.is_moe else dense
    with torch.no_grad():
        got = model.forward_tokens(params, torch.from_numpy(IDS), cfg)
    np.testing.assert_allclose(got.numpy(), _transformers_logits(DIRS[name]),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_checkpoint_serve_token_exact_with_jax(name):
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jcfg, jparams = jax_load(DIRS[name], dtype=jnp.float32)
    kw = dict(model=jqwen_moe) if jcfg.is_moe else {}
    jeng = JaxEngine(jcfg, mesh, mode="fused", dtype=jnp.float32,
                     max_len=32, params=jparams, **kw)
    cfg, params = load_hf_checkpoint(DIRS[name], torch.float32, "cpu")
    teng = Engine(cfg, mode="fused", device="cpu", dtype=torch.float32,
                  max_len=32, params=params)
    want = np.asarray(jeng.serve(jnp.asarray(IDS), gen_len=8))
    np.testing.assert_array_equal(teng.serve(IDS, gen_len=8).numpy(), want)
