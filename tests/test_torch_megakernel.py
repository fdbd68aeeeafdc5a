"""The port's megakernel runtime against the JAX package's, on the CPU.

Geometry of the JAX megakernel tests (``tests/test_megakernel.py``): the
tiny config (vocab 64, hidden 32, ff 32, 2 layers, 4/2 heads, head_dim 8),
``tile_w=16``, ``t_tile=8``, ``page=8``, batch 2, ``max_len=32``; JAX on a
one-device mesh with its Pallas kernel in interpret mode. Host logic must
match exactly: task types, args, layers and dependencies, pruned edges,
schedule tables (every output of the native scheduler), claim lists,
arena regions and the packed fp32 arena. The plain step must match JAX's
``MegaKernelEngine.decode_step`` within rtol = atol = 2e-3 (JAX's own
megakernel tolerance, ``tests/test_megakernel.py:170``), and so must the
pool rows it writes, while every other pool row stays bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.megakernel import ModelBuilder as JaxBuilder
from triton_dist_tpu.megakernel import graph as jax_graph
from triton_dist_tpu.megakernel import scheduler as jax_sched
from triton_dist_tpu.megakernel.engine import MegaKernelEngine as JaxEngine
from triton_dist_tpu.models import dense as jax_dense
from triton_dist_tpu.models.config import ModelConfig as JaxConfig
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch.megakernel import (
    MegaKernelEngine, ModelBuilder, TaskType, graph, scheduler)
from triton_dist_tpu_torch.megakernel import builder as mkb
from triton_dist_tpu_torch.megakernel import kernels as mkk
from triton_dist_tpu_torch.models import ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.serving import ServingEngine

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=32,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=8)
CFG = ModelConfig.tiny(**KW)
B, MAXLEN, TILE_W, T_TILE, PAGE = 2, 32, 16, 8, 8
P_MAX = MAXLEN // PAGE
ENGINE_KW = dict(batch=B, max_len=MAXLEN, tile_w=TILE_W, t_tile=T_TILE,
                 paged=True, page=PAGE, num_pages=B * P_MAX + 1)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


SCHEDULES = [
    dict(paged=True, schedule="static"),
    dict(paged=True, schedule="dynamic"),
    dict(paged=False, schedule="static", num_cores=2, strategy="cost_lpt"),
    dict(paged=False, schedule="dynamic", num_cores=2),
]


@pytest.mark.parametrize("kw", SCHEDULES,
                         ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_graph_and_tables_match_jax(mesh, kw):
    kw = dict(kw, batch=B, max_len=MAXLEN, tile_w=TILE_W, t_tile=T_TILE,
              page=PAGE if kw["paged"] else None)
    j = JaxBuilder(JaxConfig.tiny(**KW), mesh, **kw)
    t = ModelBuilder(CFG, **kw)
    assert ([(x.task_type, x.args, x.layer, x.deps) for x in t.graph.tasks]
            == [(x.task_type, x.args, x.layer, x.deps)
                for x in j.graph.tasks])
    for name in ("task_types", "task_args"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    for got, want in zip(t._pruned_edges, j._pruned_edges):
        np.testing.assert_array_equal(got, want)
    for k, want in j.sched.items():
        np.testing.assert_array_equal(t.sched[k], want, err_msg=k)
    assert t.schema.describe() == j.schema.describe()
    assert (t.qlen, t.arena_rows) == (j.qlen, j.arena_rows)
    # The device contract: every task claimed once, after its preds.
    claimed = {int(x): i for i, x in enumerate(t.claim_list)}
    assert sorted(claimed) == list(range(len(t.graph.tasks)))
    for tid in range(len(t.graph.tasks)):
        for p in t.preds[t.pred_start[tid]:t.pred_start[tid + 1]]:
            assert claimed[int(p)] < claimed[tid]


def test_region_overlap_index_matches_jax_graph():
    """Random accesses with overlapping, nested and empty regions: the
    indexed overlap query gives JAX's scanning Graph's exact deps."""
    rng = np.random.RandomState(0)
    jg, tg = jax_graph.Graph(), graph.Graph()
    for _ in range(300):
        regions = [(int(rng.randint(0, 400)), int(rng.choice(
            [0, 1, 2, 3, 8, 17, 64, 150]))) for _ in range(rng.randint(1, 4))]
        split = rng.randint(0, len(regions) + 1)
        a = jg.add(TaskType.ADD, (1,), reads=regions[:split],
                   writes=regions[split:])
        b = tg.add(TaskType.ADD, (1,), reads=regions[:split],
                   writes=regions[split:])
        assert b.deps == a.deps


DAGS = [
    (4, [0, 1, 2], [1, 2, 3]),
    (5, [0, 0, 1, 2, 3, 0], [1, 2, 3, 3, 4, 4]),
    (7, [0, 0, 1, 1, 2, 4, 3, 0], [1, 2, 3, 4, 5, 6, 6, 6]),
    # Relabelled so that edges point to lower ids too (the unbounded
    # search): a diamond 5 -> {2, 3} -> 0 with the redundant 5 -> 0, a
    # duplicate 2 -> 0, and 0 -> 4 made redundant for 5 -> 4.
    (6, [5, 5, 2, 3, 5, 2, 0, 5, 1], [2, 3, 0, 0, 0, 0, 4, 4, 4]),
    (5, [4, 3, 3, 1, 4, 2], [3, 1, 2, 0, 0, 0]),
]


@pytest.mark.parametrize("dag", DAGS, ids=["chain", "diamond", "wide",
                                           "backward-diamond",
                                           "backward-chain"])
def test_scheduler_matches_jax(dag):
    n, src, dst = dag
    np.testing.assert_array_equal(scheduler.prune_deps(n, src, dst),
                                  jax_sched.prune_deps(n, src, dst))
    for cores in (1, 2, 3):
        for strat in ("round_robin", "zig_zag"):
            got = scheduler.schedule(n, src, dst, num_cores=cores,
                                     strategy=strat)
            want = jax_sched.schedule(n, src, dst, num_cores=cores,
                                      strategy=strat)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        cost = np.arange(1, n + 1)
        pin = np.where(np.arange(n) == 1, 0, -1)
        for strat in ("round_robin", "zig_zag", "cost_lpt"):
            got = scheduler.schedule_mc(n, src, dst, num_cores=cores,
                                        strategy=strat, task_cost=cost,
                                        pin_core=pin)
            want = jax_sched.schedule_mc(n, src, dst, num_cores=cores,
                                         strategy=strat, task_cost=cost,
                                         pin_core=pin)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(
                list(scheduler.simulate_static(n, src, dst, got["queue"],
                                               task_cost=cost).values()),
                list(jax_sched.simulate_static(n, src, dst, want["queue"],
                                               task_cost=cost).values()))
        prio = (np.arange(n) * 7) % 5
        got = scheduler.schedule_dyn(n, src, dst, num_cores=cores,
                                     priority=prio, bucket=prio % 2,
                                     task_cost=cost, pin_core=pin)
        want = jax_sched.schedule_dyn(n, src, dst, num_cores=cores,
                                      priority=prio, bucket=prio % 2,
                                      task_cost=cost, pin_core=pin)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for fn in (lambda m: m.schedule(2, [0, 1], [1, 0]),
               lambda m: m.schedule_mc(2, [0, 1], [1, 0], num_cores=2),
               lambda m: m.schedule_dyn(2, [0, 1], [1, 0], num_cores=1,
                                        dep_opt=False)):
        with pytest.raises(ValueError, match="cycle"):
            fn(scheduler)


def test_comm_priority_matches_jax(mesh):
    t = ModelBuilder(CFG, batch=B, max_len=MAXLEN, tile_w=TILE_W,
                     t_tile=T_TILE)
    j = JaxBuilder(JaxConfig.tiny(**KW), mesh, batch=B, max_len=MAXLEN,
                   tile_w=TILE_W, t_tile=T_TILE)
    for n_ranks in (1, 4):
        assert graph.comm_priority(t.graph.tasks, n_ranks=n_ranks,
                                   task_cost=t._cost) == \
            jax_graph.comm_priority(j.graph.tasks, n_ranks=n_ranks,
                                    task_cost=j._cost)


def _jax_params(seed):
    params = jax_dense.init_params(jax.random.PRNGKey(seed),
                                   JaxConfig.tiny(**KW))
    return params, from_jax_params(jax.tree.map(np.asarray, params), CFG,
                                   "cpu", torch.float32)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_pack_arena_matches_jax(mesh, paged):
    jparams, tparams = _jax_params(2)
    kw = dict(batch=B, max_len=MAXLEN, tile_w=TILE_W, t_tile=T_TILE,
              paged=paged, page=PAGE if paged else None)
    jb = JaxBuilder(JaxConfig.tiny(**KW), mesh, **kw)
    want = spmd(mesh, jb.pack_arena, (jax_dense.param_specs(jb.cfg),),
                P("tp", None))(jparams)
    got = ModelBuilder(CFG, **kw).pack_arena(tparams, dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def engines(mesh):
    jeng = JaxEngine(JaxConfig.tiny(**KW), mesh, seed=5, keep_params=True,
                     **ENGINE_KW)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), CFG,
                             "cpu", torch.float32)
    teng = MegaKernelEngine(CFG, params=params, device="cpu",
                            dtype=torch.float32, keep_params=True,
                            **ENGINE_KW)
    return jeng, teng


def test_plain_step_matches_jax(mesh, engines):
    """Three steps over a reversed block table at ragged per-row lengths
    (row 0 crosses from page 0 into page 1 at position 8)."""
    jeng, teng = engines
    rng = np.random.RandomState(0)
    shape = tuple(teng.k_cache.shape)
    k0 = (rng.randn(*shape) * 0.5).astype(np.float32)
    v0 = (rng.randn(*shape) * 0.5).astype(np.float32)
    kv_sh = NamedSharding(mesh, P(None, None, None, "tp", None))
    jeng.k_cache = jax.device_put(jnp.asarray(k0), kv_sh)
    jeng.v_cache = jax.device_put(jnp.asarray(v0), kv_sh)
    teng.k_cache.copy_(torch.from_numpy(k0))
    teng.v_cache.copy_(torch.from_numpy(v0))
    table = np.arange(B * P_MAX, dtype=np.int32)[::-1].copy()
    jeng.block_table = jnp.asarray(table)
    teng.block_table = table
    lens = np.array([6, 13], np.int32)
    for i in range(3):
        toks = rng.randint(0, CFG.vocab_size, B).astype(np.int32)
        want = np.asarray(jeng.decode_step(jnp.asarray(toks),
                                           jnp.asarray(lens + i)))
        got = teng.decode_step(toks, lens + i)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    for tpool, jpool, init in ((teng.k_cache, jeng.k_cache, k0),
                               (teng.v_cache, jeng.v_cache, v0)):
        tpool, jpool = tpool.numpy(), np.asarray(jpool)
        np.testing.assert_allclose(tpool, jpool, rtol=2e-3, atol=2e-3)
        written = jpool != init
        # layers x rows x steps x KV heads positions, hd values each.
        assert written.sum() == 2 * B * 3 * 2 * 8
        np.testing.assert_array_equal(tpool[~written], init[~written])


def test_dense_engine_matches_paged(engines):
    """The dense cache (one (max_len,) row per slot) gives the paged
    engine's logits and tokens through prefill_chain and generate."""
    _, teng = engines
    dense_eng = MegaKernelEngine(CFG, batch=B, max_len=MAXLEN, tile_w=TILE_W,
                                 t_tile=T_TILE, params=teng.params,
                                 device="cpu", dtype=torch.float32)
    paged_eng = MegaKernelEngine(CFG, params=teng.params, device="cpu",
                                 dtype=torch.float32, **ENGINE_KW)
    paged_eng.block_table = (np.random.RandomState(1).permutation(
        B * P_MAX) + 1).astype(np.int32)
    prompt = np.random.RandomState(2).randint(0, CFG.vocab_size, (B, 5))
    outs = []
    for eng in (dense_eng, paged_eng):
        last = eng.prefill_chain(prompt)
        logits = eng.decode_step(last, 4)
        toks = eng.generate(torch.argmax(logits, -1), 4, start_pos=5)
        outs.append((logits, toks))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-5)
    assert torch.equal(outs[0][1], outs[1][1])
    assert dense_eng.steps_done == 4 + 1 + 4


def test_unported_options_raise(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="prefill_buckets mismatch"):
        ServingEngine(teng, prefill_buckets=(4, 8))
    small = MegaKernelEngine(CFG, params=teng.params, device="cpu",
                             dtype=torch.float32,
                             **dict(ENGINE_KW, num_pages=B * P_MAX))
    with pytest.raises(ValueError, match="scratch"):
        ServingEngine(small)


UNPORTED = sorted(set(TaskType) - mkb.KERNEL_TYPES - {TaskType.NOOP})


@pytest.mark.parametrize("task_type", UNPORTED, ids=lambda t: t.name)
def test_unported_task_set_raises(task_type):
    """Every task type outside the ported sets names its ROADMAP item,
    in the plain interpreter and (by KERNEL_TYPES) on the card."""
    assert UNPORTED == [TaskType.GDN_DECODE]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mkk.BODIES[task_type](None, (), None)


def test_device_rules(engines):
    """``device=None`` is the card; a non-CPU tensor goes to the kernel
    path, which raises here instead of running the plain version."""
    _, teng = engines
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MegaKernelEngine(CFG, batch=B, max_len=MAXLEN, tile_w=TILE_W)
    b = teng.builder
    meta = [x.to("meta") for x in (teng.arena, teng.k_cache, teng.v_cache)]
    before = mkb.KERNEL.launches
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        b.step(*meta, np.zeros(B, np.int32), 0, teng.block_table)
    assert mkb.KERNEL.launches == before
