"""The MoE megakernel (Qwen3-MoE task graph, ``MOE_WEIGHTS`` and
``WEIGHTED_ADD``) against the JAX package's, on the CPU in fp32.

Geometry of the JAX megakernel MoE test (``tests/test_megakernel.py``):
``tiny_moe`` at 2 layers (vocab 64, hidden 32, 4/2 heads, head_dim 8, 4
experts, top-2, expert ffn 32), ``tile_w=16`` (so E = 4 < w and the
router tile carries 12 masked columns), ``t_tile=8``, page 8, batch 2,
``max_len=32``. JAX runs on a one-device mesh with its Pallas kernel in
interpret mode. Host logic must match exactly: task types, args, layers,
experts and dependencies, pruned edges, schedule tables and claim lists
(also after ``set_expert_load``), arena regions with ``moe_counts`` and
the packed arena. Logits within rtol = atol = 2e-3 (JAX's own megakernel
tolerance) and ``expert_counts()`` equal to JAX's, for the decode, chunk
and batched-prefill row modes and with ``norm_topk_prob=False``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.megakernel import ModelBuilder as JaxBuilder
from triton_dist_tpu.megakernel.engine import MegaKernelEngine as JaxEngine
from triton_dist_tpu.models.config import ModelConfig as JaxConfig

from triton_dist_tpu_torch.megakernel import (MegaKernelEngine, ModelBuilder,
                                              TaskType)
from triton_dist_tpu_torch.megakernel import kernels as mkk
from triton_dist_tpu_torch.models import ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.ops.chunked_prefill import chunk_row_codes

KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, head_dim=8,
          num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32)
B, MAXLEN, TILE_W, T_TILE, PAGE, SEQ = 2, 32, 16, 8, 8, 4
BUCKETS = (4, 8)
P_MAX = MAXLEN // PAGE
PAGED = dict(batch=B, max_len=MAXLEN, tile_w=TILE_W, t_tile=T_TILE,
             paged=True, page=PAGE, num_pages=B * P_MAX + 1)
TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


def _cfgs(**extra):
    kw = dict(KW, **extra)
    return ModelConfig.tiny_moe(**kw), JaxConfig.tiny_moe(**kw)


BUILDS = {
    "decode-static": dict(batch=B, paged=True, page=PAGE, counts_rows=8),
    "decode-dynamic-dense": dict(batch=B, schedule="dynamic", num_cores=2),
    "chunk": dict(batch=8, seq=8, chunk=True, paged=True, page=PAGE,
                  counts_rows=8),
    "prefill": dict(batch=B * SEQ, seq=SEQ, paged=True, page=PAGE),
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_builder_tables_match_jax(mesh, name):
    kw = dict(BUILDS[name], max_len=MAXLEN, tile_w=TILE_W, t_tile=T_TILE)
    cfg, jcfg = _cfgs()
    j = JaxBuilder(jcfg, mesh, **kw)
    t = ModelBuilder(cfg, **kw)
    assert ([(x.task_type, x.args, x.layer, x.expert, x.deps)
             for x in t.graph.tasks]
            == [(x.task_type, x.args, x.layer, x.expert, x.deps)
                for x in j.graph.tasks])
    assert (t.task_types == int(TaskType.MOE_WEIGHTS)).sum() == 2
    assert (t.task_types == int(TaskType.WEIGHTED_ADD)).sum() == 2 * 4
    for attr in ("task_types", "task_args"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr),
                                      err_msg=attr)
    for got, want in zip(t._pruned_edges, j._pruned_edges):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t._cost, j._cost)
    for k, want in j.sched.items():
        np.testing.assert_array_equal(t.sched[k], want, err_msg=k)
    assert t.schema.describe() == j.schema.describe()
    assert (t.qlen, t.arena_rows, t.moe_counts_off, t.ffe_tiles) == \
        (j.qlen, j.arena_rows, j.moe_counts_off, j.ffe_tiles)
    slots = (j.claims if kw.get("schedule") == "dynamic"
             else j.sched["queue"]).reshape(-1)
    np.testing.assert_array_equal(t.claim_list, slots[slots >= 0])


@pytest.mark.parametrize("extra,match", [
    (dict(num_experts=32), "num_experts=32"),
    (dict(num_experts_per_tok=5), "num_experts_per_tok=5"),
], ids=["E>w", "topk>E"])
def test_moe_builder_checks_match_jax(mesh, extra, match):
    cfg, jcfg = _cfgs(**extra)
    kw = dict(batch=B, max_len=MAXLEN, tile_w=TILE_W, t_tile=T_TILE)
    with pytest.raises(ValueError, match=match):
        JaxBuilder(jcfg, mesh, **kw)
    with pytest.raises(ValueError, match=match):
        ModelBuilder(cfg, **kw)


def _pair(mesh, seed, *, extra=None, **kw):
    """A JAX engine (interpret mode) and the port's on its weights."""
    cfg, jcfg = _cfgs(**(extra or {}))
    jeng = JaxEngine(jcfg, mesh, seed=seed, keep_params=True, **kw)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                             "cpu", torch.float32)
    teng = MegaKernelEngine(cfg, params=params, device="cpu",
                            dtype=torch.float32, keep_params=True, **kw)
    return jeng, teng


def _set_pools(mesh, jeng, teng, seed):
    rng = np.random.RandomState(seed)
    shape = tuple(teng.k_cache.shape)
    k0 = (rng.randn(*shape) * 0.5).astype(np.float32)
    v0 = (rng.randn(*shape) * 0.5).astype(np.float32)
    kv_sh = NamedSharding(mesh, P(None, None, None, "tp", None))
    jeng.k_cache = jax.device_put(jnp.asarray(k0), kv_sh)
    jeng.v_cache = jax.device_put(jnp.asarray(v0), kv_sh)
    teng.k_cache.copy_(torch.from_numpy(k0))
    teng.v_cache.copy_(torch.from_numpy(v0))


@pytest.fixture(scope="module")
def chunked(mesh):
    """Decode and chunk builds sharing one arena, random history."""
    jeng, teng = _pair(mesh, 6, prefill_buckets=BUCKETS, **PAGED)
    packed = teng.arena.numpy().copy(), np.asarray(jeng._arena)
    _set_pools(mesh, jeng, teng, 1)
    return jeng, teng, packed


def test_shared_arena_pack_matches_jax(chunked):
    """Every build claims one moe_counts span (rows = the largest build,
    8) right after the weights; the packed arenas are equal."""
    jeng, teng, (got, want) = chunked
    regions = [b.schema.region("moe_counts")
               for b in (teng.builder, *teng.chunk_builders.values())]
    assert {(r.offset, r.rows, r.kind) for r in regions} == \
        {(jeng.builder.moe_counts_off, 8, "counter")}
    buf = teng.builder.schema.region("expert_counters")
    assert (buf.kind, buf.shape, buf.in_arena) == ("counter", (8, TILE_W),
                                                   False)
    np.testing.assert_array_equal(got, want)


def test_steps_match_jax(chunked):
    """Two decode steps (reversed block table, ragged lengths), then a
    chunk with attend-only rows and one with dead padding rows: logits
    within 2e-3 and the expert counters equal to JAX's after each."""
    jeng, teng, _ = chunked
    table = np.arange(B * P_MAX, dtype=np.int32)[::-1].copy() + 1
    jeng.block_table = jnp.asarray(table)
    teng.block_table = table
    rng = np.random.RandomState(0)
    lens = np.array([6, 13], np.int32)
    for i in range(2):
        toks = rng.randint(0, 64, B).astype(np.int32)
        want = np.asarray(jeng.decode_step(jnp.asarray(toks),
                                           jnp.asarray(lens + i)))
        got = teng.decode_step(toks, lens + i)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_array_equal(teng.expert_counts(),
                                      jeng.expert_counts())
    row = table.reshape(B, P_MAX)[1]
    for start, bucket, valid, wfrom in ((12, 8, 8, 16), (20, 4, 2, 0)):
        toks = np.zeros(bucket, np.int32)
        toks[:valid] = rng.randint(0, 64, valid)
        codes = chunk_row_codes(start, bucket, valid, wfrom)
        want = np.asarray(jeng.prefill_chunk(
            jnp.asarray(toks), jnp.asarray(codes), jnp.asarray(row)))
        got = teng.prefill_chunk(toks, codes, row).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(teng.expert_counts(),
                                      jeng.expert_counts())
    # Every row of every launch routed top-2 in each of the 2 layers.
    assert teng.expert_counts().sum() == (2 * B + 8 + 4) * 2 * 2
    np.testing.assert_allclose(teng.k_cache.numpy(),
                               np.asarray(jeng.k_cache), **TOL)


@pytest.mark.parametrize("extra", [{}, dict(norm_topk_prob=False)],
                         ids=["norm", "no-norm"])
def test_prefill_matches_jax(mesh, extra):
    """Batched prefill (prefill_seq=4) from position 0, then a decode
    step over it."""
    jeng, teng = _pair(mesh, 9, extra=extra, prefill_seq=SEQ, **PAGED)
    prompt = np.random.RandomState(5).randint(0, 64, (B, SEQ)).astype(
        np.int32)
    want = np.asarray(jeng.prefill(jnp.asarray(prompt), start_pos=0))
    got = teng.prefill(prompt, start_pos=0).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    toks = np.array([3, 9], np.int32)
    want = np.asarray(jeng.decode_step(jnp.asarray(toks), jnp.asarray(SEQ)))
    got = teng.decode_step(toks, SEQ).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(teng.expert_counts(), jeng.expert_counts())
    assert teng.expert_counts().sum() == (B * SEQ + B) * 2 * 2


def test_expert_load_claim_order_matches_jax(mesh):
    """``set_expert_load`` re-emits the dynamic claim order of the decode
    and chunk builds exactly as JAX's; ``None`` restores the uniform
    one."""
    jeng, teng = _pair(mesh, 2, prefill_buckets=BUCKETS, schedule="dynamic",
                       **PAGED)
    uniform = teng.builder.claim_list.copy()
    for load in ([0.7, 0.1, 0.1, 0.1], [0.05, 0.05, 0.1, 0.8], None):
        jeng.set_expert_load(load)
        teng.set_expert_load(load)
        for t, j in ((teng.builder, jeng.builder),
                     *((teng.chunk_builders[c], jeng.chunk_builders[c])
                       for c in BUCKETS)):
            np.testing.assert_array_equal(t.claims, j.claims)
            slots = j.claims.reshape(-1)
            np.testing.assert_array_equal(t.claim_list, slots[slots >= 0])
        if load is not None:
            assert not np.array_equal(teng.builder.claim_list, uniform)
    np.testing.assert_array_equal(teng.builder.claim_list, uniform)
    with pytest.raises(ValueError, match="dynamic"):
        ModelBuilder(_cfgs()[0], batch=B, max_len=MAXLEN,
                     tile_w=TILE_W).reprioritize([1.0] * 4)


def _moe_step_state(logits):
    """A (b, 16) arena holding a logit tile at row 0, the combine tile
    after it, and int32 counters."""
    b, w = logits.shape
    arena = torch.zeros(2 * b, w)
    arena[:b] = torch.from_numpy(logits)
    st = mkk.StepState(arena=arena, k_cache=None, v_cache=None, tokens=[],
                       lens=[], table=None,
                       counts=torch.zeros(4, w, dtype=torch.int32))
    return arena, st


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no-norm"])
def test_moe_weights_body_rules(norm):
    """Ties go to the lower column; columns >= E never win over a real
    expert and weigh 0; renormalised rows sum to one; each selected
    (row, expert) counts once per launch."""
    cfg = mkk.KernelConfig(w=16, batch=3, h_loc=1, kv_loc=1, hd=16,
                           rope_theta=1.0, rms_eps=1e-6, moe_topk=3,
                           moe_norm=norm)
    lg = np.zeros((3, 16), np.float32)
    lg[0, :6] = [1.0, 2.0, 2.0, 0.5, 2.0, -1.0]     # a three-way tie
    lg[1, :6] = [-50.0, -60.0, -70.0, -80.0, -90.0, -99.0]
    lg[1, 6:] = 100.0                               # masked columns
    lg[2] = 0.0                                     # all equal
    arena, st = _moe_step_state(lg)
    mkk.moe_weights_body(cfg, (0, 3, 6, 0), st)
    wbe = arena[3:6].numpy()
    picked = [sorted(np.nonzero(r)[0].tolist()) for r in wbe]
    assert picked == [[1, 2, 4], [0, 1, 2], [0, 1, 2]]
    assert (wbe[:, 6:] == 0).all()
    if norm:
        np.testing.assert_allclose(wbe.sum(1), 1.0, rtol=1e-6)
    else:
        np.testing.assert_allclose(wbe[2, :3], 1.0 / 6, rtol=1e-6)
    mkk.moe_weights_body(cfg, (0, 3, 6, 0), st)
    assert st.counts.sum().item() == 2 * 3 * 3
    assert st.counts[0, [1, 2, 4]].tolist() == [2, 2, 2]
    assert st.counts[3].sum().item() == 0


def test_weighted_add_body():
    cfg = mkk.KernelConfig(w=16, batch=2, h_loc=1, kv_loc=1, hd=16,
                           rope_theta=1.0, rms_eps=1e-6)
    rng = np.random.RandomState(0)
    arena = torch.from_numpy(rng.randn(12, 16).astype(np.float32))
    st = mkk.StepState(arena=arena, k_cache=None, v_cache=None, tokens=[],
                       lens=[], table=None)
    part, wbe = arena[2:6].clone(), arena[6:8].clone()
    # acc (rows 8-11, 2 tiles) = part * wbe[:, 3], then += part * wbe[:, 5]
    mkk.weighted_add_body(cfg, (8, 2, 6, 3, 2, 1), st)
    mkk.weighted_add_body(cfg, (8, 2, 6, 5, 2, 0), st)
    w = (wbe[:, 3] + wbe[:, 5]).repeat(2)[:, None]
    torch.testing.assert_close(arena[8:12], part * w, rtol=1e-6, atol=1e-6)
