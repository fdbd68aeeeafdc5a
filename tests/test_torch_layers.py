"""Layers of the PyTorch port held against the JAX package: the same
seeded numpy inputs through ``rms_norm``, ``apply_rope``,
``decode_project`` and the SwiGLU MLP on both sides, fp32, atol 1e-5
(both sides compute in fp32; only the order of float sums differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.layers import norm as jnorm, rope as jrope
from triton_dist_tpu.layers import tp_attn as jattn, tp_mlp as jmlp
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch.layers import norm, rope, tp_attn, tp_mlp
from triton_dist_tpu_torch.models import ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params

ATOL = 1e-5
KW = dict(num_key_value_heads=2)


def _np(x):
    return np.asarray(x, np.float32)


def _torch_layer(jparams, cfg):
    """The port's first decoder layer carrying ``jparams``'s layer 0."""
    model = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return model.layers[0]


@pytest.fixture(scope="module")
def weights():
    from triton_dist_tpu.models import dense as jdense

    jcfg = JaxConfig.tiny(**KW)
    params = jdense.init_params(jax.random.PRNGKey(5), jcfg, jnp.float32)
    return jcfg, ModelConfig.tiny(**KW), params


def test_rms_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 3, 16).astype(np.float32) * 3
    w = rng.randn(16).astype(np.float32)
    want = jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = norm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("head_dim", [8, 128])
def test_apply_rope_matches_jax(head_dim):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 4, head_dim).astype(np.float32)
    pos = rng.randint(0, 4000, (2, 7)).astype(np.int32)
    jf = jrope.rope_freqs(head_dim, 1_000_000.0)
    tf = rope.rope_freqs(head_dim, 1_000_000.0)
    np.testing.assert_allclose(tf.numpy(), _np(jf), rtol=1e-6, atol=0)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jf)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tf)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)


def test_decode_project_matches_jax(weights):
    jcfg, cfg, params = weights
    rng = np.random.RandomState(2)
    x = rng.randn(6, cfg.hidden_size).astype(np.float32)
    pos = np.array([0, 1, 7, 8, 33, 63], np.int32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jp = params["layers"][0]["attn"]
    f = spmd(mesh, lambda p, a, b: jattn.decode_project(p, a, jcfg, b),
             (jax.tree.map(lambda _: P(), jp), P(), P()), (P(), P(), P()))
    want = f(jp, jnp.asarray(x), jnp.asarray(pos))
    attn = _torch_layer(params, cfg).attn
    got = tp_attn.decode_project(attn, torch.from_numpy(x), cfg,
                                 torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), _np(w), atol=ATOL, rtol=0)
    o = rng.randn(6, cfg.num_attention_heads * cfg.head_dim).astype(np.float32)
    want_o = jnp.dot(jnp.asarray(o), jp["wo"])
    got_o = tp_attn.decode_output(attn, torch.from_numpy(o))
    np.testing.assert_allclose(got_o.numpy(), _np(want_o), atol=ATOL, rtol=0)


def test_swiglu_mlp_matches_jax(weights):
    _, cfg, params = weights
    jm = params["layers"][0]["mlp"]
    rng = np.random.RandomState(3)
    x = rng.randn(5, cfg.hidden_size).astype(np.float32)
    h = jmlp._swiglu(jnp.asarray(x), jm["w_gate"], jm["w_up"])
    want = jnp.dot(h, jm["w_down"], preferred_element_type=jnp.float32)
    mlp = _torch_layer(params, cfg).mlp
    got_h = tp_mlp._swiglu(torch.from_numpy(x), mlp.w_gate, mlp.w_up)
    np.testing.assert_allclose(got_h.numpy(), _np(h), atol=ATOL, rtol=0)
    got = tp_mlp.fwd(mlp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [dict(max_len=64, page=8, num_slots=2),
                                dict(max_len=4096, page=32, num_slots=4)])
def test_kv_cache_plan_matches_jax(kw):
    """The bf16 pool plan (bytes at 2 per element) is the JAX plan, and so
    is the int8 one (one byte per element plus the per-page scales)."""
    jplan = JaxConfig.qwen3_8b().kv_cache_plan(dtype_bytes=2, **kw)
    assert ModelConfig.qwen3_8b().kv_cache_plan(**kw) == jplan
    assert ModelConfig.qwen3_8b().kv_cache_plan(kv_dtype="int8", **kw) == \
        JaxConfig.qwen3_8b().kv_cache_plan(dtype_bytes=2, kv_dtype="int8",
                                           **kw)
