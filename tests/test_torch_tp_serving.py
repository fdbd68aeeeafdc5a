"""Tensor-parallel paged serving of the port against the JAX package's, on
the CPU: both serving lanes at tp > 1 over simulated ranks.

- The layer lane: the port's ``Engine(cfg, mesh=make_mesh(tp=4))`` serves
  staggered requests under bucketed and then monolithic admission, in
  each of ``"fused"``, ``"fused_ar"`` and ``"xla"`` (every op's plain
  version on CPU tensors); the greedy tokens, and the per-slot lengths
  and block tables after every tick, equal those of JAX's tp = 4
  ``"xla"`` server on the same fp32 weights (JAX's fused modes run
  interpret-mode Pallas, tens of seconds for a tiny engine).
- The megakernel's host logic at tp = 2, at ``tests/test_megakernel.py``'s
  geometry (the tiny config, ``tile_w=16``, ``t_tile=8``, ``page=8``,
  batch 2, ``max_len=32``): the task list with its ``ALLREDUCE`` and
  ``GATHER`` args, the arena regions, ``ar_ws_off``, ``vocab_loc``, every
  schedule table and each rank's packed fp32 arena equal JAX's
  ``ModelBuilder(cfg, tp2_mesh)`` exactly.
- The paged tp = 2 megakernel: its plain steps' logits and the pool rows
  they write are within rtol = atol = 2e-3 of JAX's paged tp = 2
  ``MegaKernelEngine`` (JAX's own tolerance, ``tests/test_megakernel.py:
  170``), and the greedy tokens it serves through ``ServingEngine`` with
  one-token prompts equal JAX's. JAX's tests never run its chunk builds
  at tp > 1, so chunk admission at tp = 2 is held to the port's one-rank
  megakernel lane, which ``tests/test_torch_megakernel_chunked_serving.py``
  holds to JAX.

The tests loop over modes and admission forms inside each test: the
number of collected tests decides how the tier-1 run's xdist workers
split the reference tests (ROADMAP.md, "A reference-test hang decides
the count")."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.megakernel import ModelBuilder as JaxBuilder
from triton_dist_tpu.megakernel.engine import MegaKernelEngine as JaxMegaEngine
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models import dense as jax_dense
from triton_dist_tpu.serving import ServingEngine as JaxServingEngine
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch import make_mesh
from triton_dist_tpu_torch.megakernel import MegaKernelEngine, ModelBuilder
from triton_dist_tpu_torch.megakernel.task import TaskType
from triton_dist_tpu_torch.models import Engine, ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.serving import ServingEngine

# The megakernel geometry of tests/test_megakernel.py.
MK_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=32,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=8)
MK_CFG = ModelConfig.tiny(**MK_KW)
B, MAXLEN, TILE_W, T_TILE, PAGE = 2, 32, 16, 8, 8
P_MAX = MAXLEN // PAGE
NTP = 2


def _jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("tp",))


# The layer lane: the tiny config (8 heads, 8 KV heads: 2 of each a rank
# at tp = 4), two slots and a pool of five pages, so that decode growth
# preempts a request, under a seeded arrival schedule.
TP, MAX_LEN, LANE_PAGE = 4, 64, 8
PROMPT_LENS, GEN = (3, 9, 13, 6, 5), 5


def _serve_trace(srv, prompts):
    """Drive ``srv`` through the seeded arrival schedule (0-2 submissions
    a tick); returns each request's tokens and, after every tick, the
    per-slot lengths and block-table rows."""
    arrivals = np.random.RandomState(8)
    pending, handles, trace = list(prompts), [], []
    while pending or not srv.sched.idle:
        for _ in range(int(arrivals.randint(0, 3))):
            if pending:
                handles.append(srv.submit(pending.pop(0),
                                          max_new_tokens=GEN))
        srv.step()
        trace.append((srv._lens.tolist(),
                      [list(srv.manager.table_row(s))
                       for s in range(srv.num_slots)]))
    assert all(h.status == "done" for h in handles)
    return [list(h.tokens) for h in handles], trace


def test_tp_layer_lane_matches_jax():
    jeng = JaxEngine(JaxConfig.tiny(), _jax_mesh(TP), mode="xla",
                     dtype=jnp.float32, max_len=MAX_LEN, seed=3)
    cfg = ModelConfig.tiny()
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                             "cpu", torch.float32)
    mesh = make_mesh(tp=TP, device="cpu")
    rng = np.random.RandomState(7)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in PROMPT_LENS]
    for buckets in ((4, 8), None):
        serve = dict(num_slots=2, page=LANE_PAGE, num_pages=5,
                     prefill_buckets=buckets)
        jsrv = JaxServingEngine(jeng, **serve)
        want = _serve_trace(jsrv, prompts)
        assert jsrv.stats()["preemptions"] >= 1
        for mode in ("fused", "fused_ar", "xla"):
            eng = Engine(cfg, mesh=mesh, mode=mode, dtype=torch.float32,
                         max_len=MAX_LEN, params=params)
            srv = eng.serving(**serve)
            assert srv.plan["kv_heads_loc"] == cfg.num_key_value_heads // TP
            assert srv.plan == jsrv.plan
            got = _serve_trace(srv, prompts)
            assert got[0] == want[0], (buckets, mode)
            assert got[1] == want[1], (buckets, mode)


def test_tp_megakernel_host_matches_jax():
    jmesh, mesh = _jax_mesh(NTP), make_mesh(tp=NTP, device="cpu")
    jparams = jax_dense.init_params(jax.random.PRNGKey(2),
                                    JaxConfig.tiny(**MK_KW))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), MK_CFG,
                              "cpu", torch.float32)
    for kw in (dict(paged=True, page=PAGE, schedule="static"),
               dict(paged=True, page=PAGE, schedule="dynamic"),
               dict(paged=True, page=PAGE, seq=4, chunk=True, batch=4),
               dict(paged=False, schedule="static", num_cores=2,
                    strategy="cost_lpt")):
        kw = dict(dict(batch=B, max_len=MAXLEN, tile_w=TILE_W,
                       t_tile=T_TILE), **kw)
        j = JaxBuilder(JaxConfig.tiny(**MK_KW), jmesh, **kw)
        t = ModelBuilder(MK_CFG, mesh=mesh, **kw)
        assert t.n == j.n == NTP
        assert ([(x.task_type, x.args, x.layer, x.deps)
                 for x in t.graph.tasks]
                == [(x.task_type, x.args, x.layer, x.deps)
                    for x in j.graph.tasks]), kw
        types = [x.task_type for x in t.graph.tasks]
        assert types.count(TaskType.ALLREDUCE) == 2 * MK_CFG.num_hidden_layers + 1
        gather = t.graph.tasks[types.index(TaskType.GATHER)]
        assert gather.args[3] == MK_CFG.vocab_size // NTP
        for name in ("task_types", "task_args", "qlen", "arena_rows",
                     "ar_ws_off", "ar_max_tiles", "vocab_loc", "h_loc",
                     "kv_loc", "ff_tiles"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                          err_msg=name)
        for got, want in zip(t._pruned_edges, j._pruned_edges):
            np.testing.assert_array_equal(got, want)
        for k, want in j.sched.items():
            np.testing.assert_array_equal(t.sched[k], want, err_msg=k)
        assert t.schema.describe() == j.schema.describe()
        want = spmd(jmesh, j.pack_arena, (jax_dense.param_specs(j.cfg),),
                    P("tp", None))(jparams)
        got = t.pack_arena(tparams, dtype=torch.float32)
        assert tuple(got.shape) == (NTP, t.arena_rows, TILE_W)
        np.testing.assert_array_equal(got.reshape(-1, TILE_W).numpy(),
                                      np.asarray(want))


def _serve_tokens(srv, prompts, gen):
    handles = [srv.submit(p, max_new_tokens=gen) for p in prompts]
    srv.run()
    return [list(h.tokens) for h in handles]


def test_tp_megakernel_matches_jax():
    """Three plain steps of the paged tp = 2 megakernel over a reversed
    block table at ragged lengths against JAX's paged tp = 2 engine
    (logits and written pool rows), then one-token-prompt serving on both
    engines, then chunk admission at tp = 2 against the port's one-rank
    megakernel lane."""
    jmesh = _jax_mesh(NTP)
    engine_kw = dict(batch=B, max_len=MAXLEN, tile_w=TILE_W, t_tile=T_TILE,
                     paged=True, page=PAGE, num_pages=B * P_MAX + 1)
    jeng = JaxMegaEngine(JaxConfig.tiny(**MK_KW), jmesh, seed=5,
                         keep_params=True, **engine_kw)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), MK_CFG,
                             "cpu", torch.float32)
    mesh = make_mesh(tp=NTP, device="cpu")
    teng = MegaKernelEngine(MK_CFG, mesh=mesh, params=params, device="cpu",
                            dtype=torch.float32, **engine_kw)
    assert tuple(teng.arena.shape)[:1] == (NTP,)
    rng = np.random.RandomState(0)
    shape = tuple(teng.k_cache.shape)
    k0 = (rng.randn(*shape) * 0.5).astype(np.float32)
    v0 = (rng.randn(*shape) * 0.5).astype(np.float32)
    kv_sh = NamedSharding(jmesh, P(None, None, None, "tp", None))
    jeng.k_cache = jax.device_put(jnp.asarray(k0), kv_sh)
    jeng.v_cache = jax.device_put(jnp.asarray(v0), kv_sh)
    teng.k_cache.copy_(torch.from_numpy(k0))
    teng.v_cache.copy_(torch.from_numpy(v0))
    table = np.arange(B * P_MAX, dtype=np.int32)[::-1].copy()
    jeng.block_table = jnp.asarray(table)
    teng.block_table = table
    lens = np.array([6, 13], np.int32)
    for i in range(3):
        toks = rng.randint(0, MK_CFG.vocab_size, B).astype(np.int32)
        want = np.asarray(jeng.decode_step(jnp.asarray(toks),
                                           jnp.asarray(lens + i)))
        got = teng.decode_step(toks, lens + i)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    for tpool, jpool, init in ((teng.k_cache, jeng.k_cache, k0),
                               (teng.v_cache, jeng.v_cache, v0)):
        tpool, jpool = tpool.numpy(), np.asarray(jpool)
        np.testing.assert_allclose(tpool, jpool, rtol=2e-3, atol=2e-3)
        written = jpool != init
        # layers x rows x steps x KV heads (both ranks') positions.
        assert written.sum() == 2 * B * 3 * 2 * 8
        np.testing.assert_array_equal(tpool[~written], init[~written])

    # One-token prompts through the megakernel lane of both servers.
    prompts = [[int(t)] for t in rng.randint(0, MK_CFG.vocab_size, 3)]
    want = _serve_tokens(JaxServingEngine(jeng), prompts, 3)
    assert _serve_tokens(ServingEngine(teng), prompts, 3) == want

    # Chunk admission (buckets 4 and 8) at tp = 2 against one rank.
    prompts = [[int(t) for t in rng.randint(0, MK_CFG.vocab_size, n)]
               for n in (11, 3, 6)]
    chunked = dict(engine_kw, prefill_buckets=(4, 8))
    got = [_serve_tokens(ServingEngine(
        MegaKernelEngine(MK_CFG, params=params, device="cpu",
                         dtype=torch.float32, **dict(chunked, **extra)),
        prefill_buckets=(4, 8)), prompts, 4)
        for extra in ({"mesh": mesh}, {})]
    assert got[0] == got[1]
