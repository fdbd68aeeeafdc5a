"""The port's MoE model family against the JAX package's, on the CPU in
fp32: the config presets, the router (``ep_moe.route``), the one-rank
tensor-parallel expert block (``tp_moe.fwd_ar``) and the two paged
serving steps of ``qwen_moe`` (decode and a bucketed prefill chunk).

Geometry of the JAX megakernel MoE test (``tests/test_megakernel.py``):
``tiny_moe(vocab_size=64, hidden_size=32, num_hidden_layers=2,
num_attention_heads=4, num_key_value_heads=2, head_dim=8, num_experts=4,
num_experts_per_tok=2, moe_intermediate_size=32)``. The JAX weights come
across through ``from_jax_params``; both sides compute in fp32 and differ
only in the order of float sums, so values agree within atol 2e-5 and
the routed expert ids are equal. A routing flip would move a row by the
difference of two experts' outputs, orders of magnitude above 2e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.layers import ep_moe as jep_moe, tp_moe as jtp_moe
from triton_dist_tpu.models import qwen_moe as jqwen_moe
from triton_dist_tpu.models.config import ModelConfig as JaxConfig
from triton_dist_tpu.serving import blocks as jblocks
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch.layers import ep_moe, tp_moe
from triton_dist_tpu_torch.models import Engine, ModelConfig, dense, qwen_moe
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.ops.group_gemm import sort_by_expert
from triton_dist_tpu_torch.serving import blocks as tblocks

ATOL = 2e-5
KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, head_dim=8,
          num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32)
CFG = ModelConfig.tiny_moe(**KW)
JCFG = JaxConfig.tiny_moe(**KW)
L, N, PG, PM, S = 2, 9, 4, 4, 2          # layers, pages, page, p_max, slots


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


@pytest.fixture(scope="module")
def weights():
    jparams = jqwen_moe.init_params(jax.random.PRNGKey(3), JCFG)
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams), CFG,
                                    "cpu", torch.float32)


def test_configs_match_jax():
    fields = [f.name for f in dataclasses.fields(ModelConfig)]
    for name in ("qwen3_moe_30b_a3b", "qwen3_8b"):
        t, j = getattr(ModelConfig, name)(), getattr(JaxConfig, name)()
        assert {f: getattr(t, f) for f in fields} == \
            {f: getattr(j, f) for f in fields}
        assert t.is_moe == j.is_moe
    assert {f: getattr(CFG, f) for f in fields} == \
        {f: getattr(JCFG, f) for f in fields}
    big = ModelConfig.qwen3_moe_30b_a3b()
    assert (big.num_hidden_layers, big.hidden_size, big.num_experts,
            big.num_experts_per_tok, big.moe_intermediate_size,
            big.norm_topk_prob) == (48, 2048, 128, 8, 768, True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ModelConfig.tiny_moe(shared_expert_intermediate_size=16)


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no-norm"])
def test_route_matches_jax(weights, norm):
    """Random rows plus a zero row (every probability equal: the lower
    expert ids win the ties, as jax.lax.top_k)."""
    jparams, tparams = weights
    rng = np.random.RandomState(0)
    x = rng.randn(7, CFG.hidden_size).astype(np.float32)
    x[3] = 0.0
    jr = jparams["layers"][0]["moe"]["router"]
    ids, w = jep_moe.route(jr, jnp.asarray(x), 2, norm_topk_prob=norm)
    tids, tw = ep_moe.route(tparams.layers[0].moe.router,
                            torch.from_numpy(x), 2, norm_topk_prob=norm)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    assert tids[3].tolist() == [0, 1]


def test_sort_by_expert_matches_jax():
    from triton_dist_tpu.ops.group_gemm import sort_by_expert as jsort

    rng = np.random.RandomState(1)
    tok = rng.randn(9, 3).astype(np.float32)
    ids = rng.randint(-1, 4, 9).astype(np.int32)
    want = jsort(jnp.asarray(tok), jnp.asarray(ids), 4)
    got = sort_by_expert(torch.from_numpy(tok), torch.from_numpy(ids), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fwd_ar_matches_jax(mesh, weights):
    jparams, tparams = weights
    x = np.random.RandomState(2).randn(6, CFG.hidden_size).astype(np.float32)
    jmoe = jparams["layers"][1]["moe"]
    f = spmd(mesh, lambda p, a: jtp_moe.fwd_ar(
        p, a, topk=2, num_experts=4, norm_topk_prob=True),
        (jtp_moe.param_specs("tp"), P(None, None)), P(None, None))
    want = f(jmoe, jnp.asarray(x))
    got = tp_moe.fwd_ar(tparams.layers[1].moe, torch.from_numpy(x), topk=2,
                        num_experts=4, norm_topk_prob=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _caches(seed):
    """One random pool history on both sides: slot 0 at length 6 over
    pages (2, 5), slot 1 parked."""
    rng = np.random.RandomState(seed)
    shape = (L, N, CFG.num_key_value_heads, PG, CFG.head_dim)
    k = (rng.randn(*shape) * 0.5).astype(np.float32)
    v = (rng.randn(*shape) * 0.5).astype(np.float32)
    tbl = np.array([[2, 5, 7, 0], [0, 0, 0, 0]], np.int32)
    lens, live = np.array([6, 0], np.int32), np.array([1, 0], np.int32)
    jc = jblocks.PagedKVCache.empty(L, N, PG, CFG.num_key_value_heads,
                                    CFG.head_dim, num_slots=S, p_max=PM)
    jc = dataclasses.replace(jc, k_pages=jnp.asarray(k),
                             v_pages=jnp.asarray(v),
                             block_table=jnp.asarray(tbl),
                             lens=jnp.asarray(lens), live=jnp.asarray(live))
    tc = tblocks.PagedKVCache.empty(L, N, PG, CFG.num_key_value_heads,
                                    CFG.head_dim, num_slots=S, p_max=PM,
                                    device="cpu", dtype=torch.float32)
    for dst, src in ((tc.k_pages, k), (tc.v_pages, v), (tc.block_table, tbl),
                     (tc.lens, lens), (tc.live, live)):
        dst.copy_(torch.from_numpy(src))
    return jc, tc


def _check_pools(jc, tc):
    real = list(range(1, N))                 # page 0 is the scratch page
    for got, want in ((tc.k_pages, jc.k_pages), (tc.v_pages, jc.v_pages)):
        np.testing.assert_allclose(got.numpy()[:, real],
                                   np.asarray(want)[:, real], atol=ATOL,
                                   rtol=0)


def test_decode_step_paged_matches_jax(mesh, weights):
    jparams, tparams = weights
    jc, tc = _caches(3)
    toks = np.array([17, 40], np.int32)
    specs = jqwen_moe.paged_cache_specs("tp")
    f = spmd(mesh, lambda p, t, c: jqwen_moe.decode_step_paged(p, t, c, JCFG),
             (jqwen_moe.param_specs(JCFG, moe_impl="tp"), P(None), specs),
             (P(None, None), specs))
    want, jc = f(jparams, jnp.asarray(toks), jc)
    got = qwen_moe.decode_step_paged(tparams, torch.from_numpy(toks), tc, CFG)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0],
                               atol=ATOL, rtol=0)
    _check_pools(jc, tc)
    np.testing.assert_array_equal(tc.lens.numpy(), np.asarray(jc.lens))


@pytest.mark.parametrize("start,wfrom,valid", [(6, 6, 5), (4, 6, 8)],
                         ids=["append", "prefix-resident"])
def test_prefill_chunk_paged_matches_jax(mesh, weights, start, wfrom, valid):
    """An 8-row chunk of slot 0: 5 valid rows after its 6 resident
    positions, or rows 4-11 with positions below 6 attend-only."""
    jparams, tparams = weights
    jc, tc = _caches(4)
    toks = np.zeros(8, np.int32)
    toks[:valid] = np.random.RandomState(5).randint(0, 64, valid)
    row = np.array([2, 5, 7, 0], np.int32)
    specs = jqwen_moe.paged_cache_specs("tp")
    f = spmd(mesh, lambda p, t, c, r: jqwen_moe.prefill_chunk_paged(
        p, t, c, r, JCFG, start=start, wfrom=wfrom, valid=valid),
        (jqwen_moe.param_specs(JCFG, moe_impl="tp"), P(None), specs,
         P(None)), (P(None), specs))
    want, jc = f(jparams, jnp.asarray(toks), jc, jnp.asarray(row))
    got = qwen_moe.prefill_chunk_paged(
        tparams, torch.from_numpy(toks), tc, torch.from_numpy(row), CFG,
        start=start, wfrom=wfrom, valid=valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    _check_pools(jc, tc)


def test_engine_model_choice(weights):
    _, tparams = weights
    eng = Engine(CFG, device="cpu", dtype=torch.float32, max_len=16,
                 params=tparams)
    assert eng.model is qwen_moe
    with pytest.raises(ValueError, match="MoE config"):
        Engine(ModelConfig.tiny(), model=qwen_moe, device="cpu",
               dtype=torch.float32)
    with pytest.raises(ValueError, match="dense config"):
        Engine(CFG, model=dense, device="cpu", dtype=torch.float32,
               params=tparams)
