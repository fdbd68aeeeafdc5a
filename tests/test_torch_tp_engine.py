"""The port's tensor-parallel dense engine against the JAX package's, on
the CPU in fp32: ``Engine(cfg, mesh=make_mesh(tp=4, device="cpu"),
mode=m)`` for m in ``"xla"``, ``"fused"`` and ``"fused_ar"`` (every fused
op through its plain version) against the JAX ``Engine`` over a 4-device
mesh in ``mode="xla"`` (JAX's own ``tests/test_e2e_dense.py`` holds its
fused modes to its xla mode; its fused engine takes minutes on the CPU), on the
same weights (``from_jax_params``). Prefill logits and the KV cache (the
JAX cache's global view) within 1e-4, greedy tokens over 4 steps
identical; tp = 2 and tp = 4 against the port's tp = 1; and the errors:
heads that do not split, B·S not divisible by tp, the expert-parallel MoE
regime and what ``serving()`` does not take at tp > 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.layers import tp_attn as jtp_attn
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.parallel.mesh import make_mesh as jax_make_mesh

from triton_dist_tpu_torch import Engine, ModelConfig, make_mesh
from triton_dist_tpu_torch.layers import tp_attn
from triton_dist_tpu_torch.models.convert import from_jax_params

ATOL = 1e-4
KW = dict(num_key_value_heads=4)
MAX_LEN = 24
GEN = 4


@pytest.fixture(scope="module")
def jax_run():
    """The JAX tp = 4 xla engine: its weights, prefill and greedy tokens."""
    mesh = jax_make_mesh(tp=4, devices=jax.devices()[:4])
    jeng = JaxEngine(JaxConfig.tiny(**KW), mesh, mode="xla",
                     dtype=jnp.float32, max_len=MAX_LEN, seed=5)
    ids = np.random.RandomState(0).randint(0, 256, (2, 12)).astype(np.int32)
    logits, cache = jeng.prefill(ids)
    toks = np.asarray(jeng.serve(ids, gen_len=GEN))
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params),
                             ModelConfig.tiny(**KW), "cpu", torch.float32)
    return dict(ids=ids, logits=np.asarray(logits), k=np.asarray(cache.k),
                v=np.asarray(cache.v), toks=toks, params=params)


def _engine(params, n, mode, **kw):
    return Engine(ModelConfig.tiny(**KW), mesh=make_mesh(tp=n, device="cpu"),
                  mode=mode, dtype=torch.float32, max_len=MAX_LEN,
                  params=params, **kw)


@pytest.mark.parametrize("mode", ["xla", "fused", "fused_ar"])
def test_tp4_engine_matches_jax(jax_run, mode):
    eng = _engine(jax_run["params"], 4, mode)
    logits, cache = eng.prefill(jax_run["ids"])
    np.testing.assert_allclose(logits.numpy(), jax_run["logits"], atol=ATOL,
                               rtol=0)
    assert cache.k.shape == jax_run["k"].shape and cache.length == 12
    np.testing.assert_allclose(cache.k.numpy(), jax_run["k"], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(cache.v.numpy(), jax_run["v"], atol=ATOL,
                               rtol=0)
    toks = eng.serve(jax_run["ids"], gen_len=GEN).numpy()
    np.testing.assert_array_equal(toks, jax_run["toks"])


@pytest.mark.parametrize("n", [2, 4])
def test_tp_engine_matches_one_rank(jax_run, n):
    """Every mode at tp = n against the port's one-rank engine: the same
    function up to the order of fp32 sums."""
    one = Engine(ModelConfig.tiny(**KW), mode="xla", device="cpu",
                 dtype=torch.float32, max_len=MAX_LEN,
                 params=jax_run["params"])
    ids = jax_run["ids"]
    want_logits, want_cache = one.prefill(ids)
    want_k = want_cache.k.clone()
    want_step, _ = one.decode(torch.argmax(want_logits, -1), want_cache)
    want_toks = one.serve(ids, gen_len=GEN)
    for mode in ("xla", "fused", "fused_ar"):
        eng = _engine(jax_run["params"], n, mode)
        logits, cache = eng.prefill(ids)
        torch.testing.assert_close(logits, want_logits, atol=1e-5, rtol=0)
        torch.testing.assert_close(cache.k, want_k, atol=1e-5, rtol=0)
        logits, cache = eng.decode(torch.argmax(logits, -1), cache)
        torch.testing.assert_close(logits, want_step, atol=1e-5, rtol=0)
        torch.testing.assert_close(cache.v, want_cache.v, atol=1e-5, rtol=0)
        assert torch.equal(eng.serve(ids, gen_len=GEN), want_toks)


@pytest.mark.parametrize("kw", [
    dict(num_attention_heads=6, num_key_value_heads=2),
    dict(num_key_value_heads=2)], ids=["heads", "kv-heads"])
def test_head_split_errors_equal_jax(kw):
    """Heads that do not split over the ranks: the JAX message, from the
    engine and from ``_head_split``."""
    with pytest.raises(ValueError) as want:
        jtp_attn._head_split(JaxConfig.tiny(**kw), 4)
    with pytest.raises(ValueError) as got:
        Engine(ModelConfig.tiny(**kw), mesh=make_mesh(tp=4, device="cpu"),
               dtype=torch.float32)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        tp_attn._head_split(ModelConfig.tiny(**kw), 4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["xla", "fused"])
def test_tokens_not_divisible_by_tp_raise(jax_run, mode):
    """B·S not divisible by tp in the token-sharded modes: JAX fails in a
    reshape (TypeError), the port names the cause with the same type."""
    with pytest.raises(TypeError, match="B\\*S=22 tokens over tp=4"):
        _engine(jax_run["params"], 4, mode).prefill(jax_run["ids"][:, :11])


def test_fused_ar_takes_any_token_count(jax_run):
    """In "fused_ar" the tokens are replicated: any B·S prefills."""
    logits, _ = _engine(jax_run["params"], 4, "fused_ar").prefill(
        jax_run["ids"][:, :11])
    assert logits.shape == (2, 256)


def test_moe_at_tp_raises():
    """A MoE model at tp > 1 runs its experts tensor-parallel
    (``tests/test_torch_tp_moe.py``) or expert-parallel over the tp ranks
    (``tests/test_torch_ep_engine.py``); a hierarchical ``ep_axis`` must be
    the engine's own (outer, inner) axis, so over one tp axis it raises."""
    with pytest.raises(ValueError, match="over the engine's own"):
        Engine(ModelConfig.tiny_moe(num_experts=4),
               mesh=make_mesh(tp=4, device="cpu"), dtype=torch.float32,
               moe_impl="ep", ep_axis=("dcn", "tp"))


def test_serving_at_tp_raises(jax_run):
    """Dense paged serving at tp > 1 is ported
    (``tests/test_torch_tp_serving.py``); what stays for later raises,
    naming queue A item 8: quantized pools and ``spec_k`` at tp > 1, and a
    MoE engine's paged lanes."""
    eng = _engine(jax_run["params"], 4, "fused")
    for kw in (dict(kv_dtype="int8"), dict(spec_k=2)):
        with pytest.raises(ValueError, match="queue A item 8"):
            eng.serving(num_slots=2, page=8, **kw)
    moe = Engine(ModelConfig.tiny_moe(num_experts=4),
                 mesh=make_mesh(tp=4, device="cpu"), dtype=torch.float32)
    with pytest.raises(ValueError, match="queue A item 8"):
        moe.serving(num_slots=2, page=8)


def test_device_must_be_the_mesh_device(jax_run):
    with pytest.raises(ValueError, match="not the mesh's device"):
        _engine(jax_run["params"], 4, "xla", device="meta")


@pytest.mark.parametrize("axis,item", [
    ("ep", "item 5"), ("sp", "item 6"),
    pytest.param("dp", "data-parallel replicas", id="dp-dp"), ("pp", "pp")])
def test_unported_mesh_axes_raise(axis, item):
    """A dp axis makes a two-axis mesh (``tests/test_torch_tp2d.py``); an
    engine sharding over its tp axis alone would hold data-parallel
    replicas, which are not ported. A pp axis makes a mesh that no Engine
    runs over (the pipeline is the layer ``layers.pp_comm``, as in JAX)."""
    with pytest.raises(ValueError, match=item):
        mesh = make_mesh(tp=2, device="cpu", **{axis: 2})
        Engine(ModelConfig.tiny(**KW), mesh=mesh, dtype=torch.float32)
