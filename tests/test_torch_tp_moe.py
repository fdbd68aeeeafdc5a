"""The port's tensor-parallel Qwen3-MoE against the JAX package's, on the
CPU in fp32 (``ModelConfig.tiny_moe()``, seeded numpy inputs, JAX weights
carried across with ``from_jax_params``).

- Ops: ``ag_group_gemm``, ``moe_reduce_rs`` and ``moe_reduce_ar`` over 2
  and 4 simulated ranks (their plain versions on CPU tensors) against
  JAX's ``ag_moe_ref``, ``moe_reduce_rs_ref`` and ``moe_reduce_ar_ref`` in
  a ``shard_map`` over as many CPU devices, within 1e-5 (sums in other
  orders). The JAX Pallas kernels are not run here: in interpret mode
  they take 12-39 s each, and JAX's own tests hold them to these
  references. Their argument errors are JAX's, message for message.
- Layer: ``tp_moe.fwd``, ``fwd_ar`` and ``fwd_fused`` (both epilogues) at
  tp = 4 against JAX's ``tp_moe.fwd`` / ``fwd_ar`` on the same weights,
  within 1e-5.
- Engine: ``Engine(tiny_moe, mesh=make_mesh(tp=4, device="cpu"), mode=m)``
  for m in ``"xla"``, ``"fused"`` and ``"fused_ar"`` against JAX's tp = 4
  ``"xla"`` MoE engine: prefill logits and the KV cache within 1e-4,
  greedy tokens over 4 steps identical; tp = 2 and 4 against the port's
  tp = 1; and ``moe_impl``'s errors."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.layers import tp_moe as jtp_moe
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models import qwen_moe as jqwen_moe
from triton_dist_tpu.ops import ag_moe as jag_moe
from triton_dist_tpu.ops import moe_reduce as jmoe_reduce
from triton_dist_tpu.parallel.mesh import MeshContext as JaxMeshContext
from triton_dist_tpu.parallel.mesh import make_mesh as jax_make_mesh
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch import Engine, ModelConfig, make_mesh
from triton_dist_tpu_torch.layers import tp_moe
from triton_dist_tpu_torch.models import dense, qwen_moe
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.ops import ag_moe, moe_reduce

TOL = dict(rtol=1e-5, atol=1e-5)
ATOL = 1e-4
MAX_LEN, GEN = 24, 4
CFG, JCFG = ModelConfig.tiny_moe(), JaxConfig.tiny_moe()


def _jmesh(n):
    mesh = jax_make_mesh(tp=n, devices=jax.devices()[:n])
    return mesh, JaxMeshContext.from_mesh(mesh)


@pytest.fixture(scope="module")
def weights():
    jparams = jqwen_moe.init_params(jax.random.PRNGKey(7), JCFG)
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams), CFG,
                                    "cpu", torch.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _layouts(n, t_loc, d, e, k, block_m, seed):
    """n ranks' sorted layouts of random tokens: x_s (n, S_loc, d), te (n,
    n_i), row_src (n, S_loc), the row tile."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, t_loc, d).astype(np.float32)
    ids = np.stack([[rng.choice(e, k, replace=False) for _ in range(t_loc)]
                    for _ in range(n)]).astype(np.int32)
    tm = ag_moe.suggested_block_m(t_loc, k, e, block_m)
    x_s, te, src = (torch.stack(v) for v in zip(*(
        ag_moe.prepare_grouped_tokens(_t(x[r]), _t(ids[r]), e, tm)
        for r in range(n))))
    return x_s, te, src, tm


@pytest.mark.parametrize("n", [2, 4])
def test_ag_group_gemm_matches_jax_ref(n):
    """Rank r's output: the gathered chunks times its (gate, up) shards,
    against JAX's oracle over the concatenated ``w_gu`` shards."""
    jm, _ = _jmesh(n)
    e, d, f = 6, 16, 8 * n
    x_s, te, src, tm = _layouts(n, 5, d, e, 2, 8, n)
    rng = np.random.RandomState(10 + n)
    gate, up = (rng.randn(e, f, d).astype(np.float32) for _ in range(2))
    fl = f // n
    # JAX's w (E, d, n·2F_loc): rank r's columns are [gate_r, up_r].
    w_gu = np.concatenate([np.concatenate(
        [gate[:, r * fl:(r + 1) * fl], up[:, r * fl:(r + 1) * fl]], 1)
        for r in range(n)], 1).transpose(0, 2, 1)
    f_ref = spmd(jm, lambda x, w, t: jag_moe.ag_moe_ref(x, w, t),
                 (P("tp", None), P(None, None, "tp"), P("tp")),
                 P(None, "tp"))
    want = np.asarray(f_ref(jnp.asarray(x_s.reshape(-1, d).numpy()),
                            jnp.asarray(w_gu),
                            jnp.asarray(te.reshape(-1).numpy())))
    sh = tp_moe.param_specs(SimpleNamespace(
        router=None, w_gate=_t(gate), w_up=_t(up),
        w_down=torch.zeros(e, d, f)), n)
    ctx = ag_moe.create_ag_moe_context(make_mesh(tp=n, device="cpu"),
                                       num_experts=e, block_m=tm)
    got = ag_moe.ag_group_gemm(x_s, (sh["w_gate"], sh["w_up"]), te, ctx,
                               te_all=te, used=ag_moe.tiles_used(src, tm))
    assert got.shape == (n, n * x_s.shape[1], 2 * fl)
    np.testing.assert_allclose(
        got.permute(1, 0, 2).reshape(n * x_s.shape[1], -1).numpy(), want,
        **TOL)
    np.testing.assert_array_equal(
        ag_moe.tiles_used(src, tm).numpy(),
        [(src[r].view(-1, tm) >= 0).any(1).sum() for r in range(n)])


@pytest.mark.parametrize("n", [2, 4])
def test_moe_reduce_matches_jax_refs(n):
    jm, _ = _jmesh(n)
    t, k, d = 4 * n, 3, 8
    rng = np.random.RandomState(n)
    y = rng.randn(n, t, k, d).astype(np.float32)
    w = rng.rand(t, k).astype(np.float32)
    w_all = np.tile(w, (n, 1))                      # every rank's copy
    specs = (P("tp", None, None), P("tp", None))
    rs = spmd(jm, lambda a, b: jmoe_reduce.moe_reduce_rs_ref(a, b), specs,
              P("tp", None))
    ar = spmd(jm, lambda a, b: jmoe_reduce.moe_reduce_ar_ref(a, b), specs,
              P(None, None))
    args = jnp.asarray(y.reshape(n * t, k, d)), jnp.asarray(w_all)
    ty, tw = _t(y), _t(w).expand(n, t, k)
    mesh = make_mesh(tp=n, device="cpu")
    got = moe_reduce.moe_reduce_rs(ty, tw, ctx=mesh)
    assert got.shape == (n, t // n, d)
    np.testing.assert_allclose(got.reshape(t, d).numpy(),
                               np.asarray(rs(*args)), **TOL)
    got = moe_reduce.moe_reduce_ar(ty, tw, ctx=mesh)
    assert got.shape == (n, t, d)
    for r in range(n):
        np.testing.assert_allclose(got[r].numpy(), np.asarray(ar(*args)),
                                   **TOL)


def _same_value_error(jax_call, port_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["rs-tokens", "rs-weights", "ar-weights",
                                  "ag-block", "ag-tiles"])
def test_argument_errors_equal_jax(case):
    """The JAX ops raise these at trace time, before any kernel runs."""
    n = 4
    jm, jctx = _jmesh(n)
    mesh = make_mesh(tp=n, device="cpu")
    if case.startswith("ag"):
        s_loc, d, e, f = 24 if case == "ag-block" else 16, 8, 3, 8
        tiles = 2 if case == "ag-block" else 3
        x = np.zeros((n * s_loc, d), np.float32)
        te = np.zeros((n * tiles,), np.int32)
        w = np.zeros((e, d, n * f), np.float32)
        jc = jag_moe.create_ag_moe_context(jctx, num_experts=e, block_m=16)
        f_j = spmd(jm, lambda a, b, c: jag_moe.ag_group_gemm(a, b, c, jc),
                   (P("tp", None), P(None, None, "tp"), P("tp")),
                   P(None, "tp"))
        tw = torch.zeros(n, e, f, d)
        c = ag_moe.create_ag_moe_context(mesh, num_experts=e, block_m=16)
        _same_value_error(
            lambda: f_j(jnp.asarray(x), jnp.asarray(w), jnp.asarray(te)),
            lambda: ag_moe.ag_group_gemm(_t(x).view(n, s_loc, d), tw,
                                         _t(te).view(n, tiles), c))
        return
    t = 6 if case == "rs-tokens" else 8
    kw = 3 if case.endswith("weights") else 2
    y = np.zeros((n * t, 2, 8), np.float32)
    w = np.zeros((n * t, kw), np.float32)
    jop, op = ((jmoe_reduce.moe_reduce_ar, moe_reduce.moe_reduce_ar)
               if case.startswith("ar") else
               (jmoe_reduce.moe_reduce_rs, moe_reduce.moe_reduce_rs))
    f_j = spmd(jm, lambda a, b: jop(a, b, ctx=jctx),
               (P("tp", None, None), P("tp", None)), P(None, None))
    _same_value_error(
        lambda: f_j(jnp.asarray(y), jnp.asarray(w)),
        lambda: op(_t(y).view(n, t, 2, 8), _t(w).view(n, t, kw), ctx=mesh))


@pytest.fixture(scope="module")
def layer_case(weights):
    """Layer 0's MoE block on both sides and 16 tokens (tp = 4)."""
    jparams, tparams = weights
    x = np.random.RandomState(4).randn(16, CFG.hidden_size).astype(
        np.float32)
    jm, jctx = _jmesh(4)
    kw = dict(topk=CFG.num_experts_per_tok, num_experts=CFG.num_experts)
    specs = jtp_moe.param_specs("tp")
    jmoe = jparams["layers"][0]["moe"]
    want_fwd = spmd(jm, lambda p, a: jtp_moe.fwd(p, a, **kw),
                    (specs, P("tp", None)), P("tp", None))(
        jmoe, jnp.asarray(x))
    want_ar = spmd(jm, lambda p, a: jtp_moe.fwd_ar(p, a, **kw),
                   (specs, P(None, None)), P(None, None))(
        jmoe, jnp.asarray(x))
    return dict(moe=tparams.layers[0].moe, x=_t(x), kw=kw,
                fwd=np.asarray(want_fwd), ar=np.asarray(want_ar))


@pytest.mark.parametrize("form", ["fwd", "fwd-fused-rs", "fwd-fused-ar",
                                  "fwd-rs-op", "fwd_ar"])
def test_tp4_layer_matches_jax(layer_case, form):
    c = layer_case
    moe, x, kw = c["moe"], c["x"], c["kw"]
    mesh = make_mesh(tp=4, device="cpu")
    xs = x.view(4, 4, -1)                            # token-sharded
    if form == "fwd":
        got, want = tp_moe.fwd(moe, xs, **kw).reshape(16, -1), c["fwd"]
    elif form == "fwd-rs-op":
        got = tp_moe.fwd(moe, xs, mesh_ctx=mesh, **kw).reshape(16, -1)
        want = c["fwd"]
    elif form == "fwd-fused-rs":
        got = tp_moe.fwd_fused(moe, xs, mesh_ctx=mesh, block_m=8,
                               **kw).reshape(16, -1)
        want = c["fwd"]
    else:
        got = (tp_moe.fwd_fused(moe, xs, mesh_ctx=mesh, epilogue="ar", **kw)
               if form == "fwd-fused-ar"
               else tp_moe.fwd_ar(moe, x.expand(4, *x.shape), **kw))
        assert got.shape == (4, 16, CFG.hidden_size)
        assert all(torch.equal(got[r], got[0]) for r in range(4))
        got, want = got[0], c["ar"]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX tp = 4 xla MoE engine (tensor-parallel experts): its
    weights, prefill and greedy tokens."""
    mesh = jax_make_mesh(tp=4, devices=jax.devices()[:4])
    jeng = JaxEngine(JCFG, mesh, mode="xla", dtype=jnp.float32,
                     max_len=MAX_LEN, seed=5, model=jqwen_moe)
    ids = np.random.RandomState(0).randint(0, 256, (2, 12)).astype(np.int32)
    logits, cache = jeng.prefill(ids)
    toks = np.asarray(jeng.serve(ids, gen_len=GEN))
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), CFG,
                             "cpu", torch.float32)
    return dict(ids=ids, logits=np.asarray(logits), k=np.asarray(cache.k),
                v=np.asarray(cache.v), toks=toks, params=params)


def _engine(params, n, mode, **kw):
    return Engine(CFG, mesh=make_mesh(tp=n, device="cpu"), mode=mode,
                  dtype=torch.float32, max_len=MAX_LEN, params=params, **kw)


@pytest.mark.parametrize("mode", ["xla", "fused", "fused_ar"])
def test_tp4_moe_engine_matches_jax(jax_run, mode):
    eng = _engine(jax_run["params"], 4, mode)
    assert eng.moe_impl == "tp"
    logits, cache = eng.prefill(jax_run["ids"])
    np.testing.assert_allclose(logits.numpy(), jax_run["logits"], atol=ATOL,
                               rtol=0)
    assert cache.k.shape == jax_run["k"].shape and cache.length == 12
    np.testing.assert_allclose(cache.k.numpy(), jax_run["k"], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(cache.v.numpy(), jax_run["v"], atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(
        eng.serve(jax_run["ids"], gen_len=GEN).numpy(), jax_run["toks"])


@pytest.mark.parametrize("n", [2, 4])
def test_tp_moe_engine_matches_one_rank(jax_run, n):
    """Every mode at tp = n against the port's one-rank engine, and the
    all-token forward against the one-rank one: the same function up to
    the order of fp32 sums."""
    one = Engine(CFG, mode="xla", device="cpu", dtype=torch.float32,
                 max_len=MAX_LEN, params=jax_run["params"])
    ids = jax_run["ids"]
    want_logits, want_cache = one.prefill(ids)
    want_k = want_cache.k.clone()
    want_step, _ = one.decode(torch.argmax(want_logits, -1), want_cache)
    want_toks = one.serve(ids, gen_len=GEN)
    t_ids = torch.as_tensor(ids).long()
    want_all = qwen_moe.forward_tokens(jax_run["params"], t_ids, CFG)
    for mode in ("xla", "fused", "fused_ar"):
        eng = _engine(jax_run["params"], n, mode)
        mesh = make_mesh(tp=n, device="cpu")
        torch.testing.assert_close(qwen_moe.forward_tokens(
            jax_run["params"], t_ids, CFG, mode=mode, mesh=mesh,
            ctxs=dense.make_fwd_contexts(mesh)), want_all, atol=1e-5, rtol=0)
        logits, cache = eng.prefill(ids)
        torch.testing.assert_close(logits, want_logits, atol=1e-5, rtol=0)
        torch.testing.assert_close(cache.k, want_k, atol=1e-5, rtol=0)
        logits, cache = eng.decode(torch.argmax(logits, -1), cache)
        torch.testing.assert_close(logits, want_step, atol=1e-5, rtol=0)
        assert torch.equal(eng.serve(ids, gen_len=GEN), want_toks)


def test_moe_impl_errors(jax_run):
    """``"ep"`` over a hierarchical ``ep_axis`` that is not the engine's
    own (outer, inner) axis raises; a dense model takes no ``moe_impl``
    (JAX's message); the ffn dimension must split over the ranks."""
    with pytest.raises(ValueError, match="over the engine's own"):
        _engine(jax_run["params"], 4, "fused", moe_impl="ep",
                ep_axis=("dcn", "tp"))
    with pytest.raises(ValueError, match="unknown moe_impl"):
        _engine(jax_run["params"], 4, "fused", moe_impl="bogus")
    with pytest.raises(ValueError, match=r"moe_impl='tp' given, but model "
                       r"'triton_dist_tpu_torch.models.dense' is not a MoE"):
        Engine(ModelConfig.tiny(), device="cpu", dtype=torch.float32,
               moe_impl="tp")
    with pytest.raises(ValueError, match="moe_intermediate_size=32 not "
                       "divisible by tp=3"):
        Engine(ModelConfig.tiny_moe(vocab_size=258, num_attention_heads=6,
                                    num_key_value_heads=3),
               mesh=make_mesh(tp=3, device="cpu"), dtype=torch.float32)


def test_grouped_gemm_tiles_takes_strided_rank_shards():
    """Row 17's wrapper on the ranks' ffn shards as views (expert stride
    f·d for gate/up, row pitch f for down) and a leading rank dimension:
    the same as on contiguous copies of each shard, rank by rank."""
    from triton_dist_tpu_torch.ops import group_gemm

    n, e, d, f = 4, 5, 16, 32
    x_s, te, _, _ = _layouts(n, 6, d, e, 2, 8, 11)
    rng = np.random.RandomState(12)
    gate, up = _t(rng.randn(e, f, d).astype(np.float32)), _t(
        rng.randn(e, f, d).astype(np.float32))
    down = _t(rng.randn(e, d, f).astype(np.float32))
    sh = tp_moe.param_specs(SimpleNamespace(router=None, w_gate=gate,
                                            w_up=up, w_down=down), n)
    assert not sh["w_down"].is_contiguous()
    assert sh["w_gate"].data_ptr() == gate.data_ptr()      # views
    te_full = te.reshape(-1)
    x_full = x_s.reshape(-1, d)
    xs = x_full.expand(n, *x_full.shape)
    act = _t(rng.randn(n, x_full.shape[0], f // n).astype(np.float32))
    got = group_gemm.grouped_gemm_tiles(xs, (sh["w_gate"], sh["w_up"]),
                                        te_full)
    got_down = group_gemm.grouped_gemm_tiles(act, sh["w_down"], te_full)
    for r in range(n):
        want = group_gemm.grouped_gemm_tiles(
            x_full, (sh["w_gate"][r].contiguous(),
                     sh["w_up"][r].contiguous()), te_full)
        np.testing.assert_allclose(got[r].numpy(), want.numpy(), **TOL)
        np.testing.assert_allclose(
            got_down[r].numpy(), group_gemm.grouped_gemm_tiles(
                act[r], sh["w_down"][r].contiguous(), te_full).numpy(),
            **TOL)


@pytest.mark.parametrize("op", ["ag", "rs", "ar"])
def test_ops_take_the_plain_version_only_on_cpu(op):
    """Any device but the CPU launches the kernel or raises."""
    n = 4
    mesh = make_mesh(tp=n, device="cpu")
    if op == "ag":
        x_s, te, src, tm = _layouts(n, 5, 8, 3, 2, 8, 1)
        w = torch.zeros(n, 3, 4, 8)
        ctx = ag_moe.create_ag_moe_context(mesh, num_experts=3, block_m=tm)
        kernel = ag_moe.KERNEL

        def call(dev):
            return ag_moe.ag_group_gemm(x_s.to(dev), w.to(dev), te.to(dev),
                                        ctx)
    else:
        y, w = torch.zeros(n, 8, 2, 16), torch.zeros(n, 8, 2)
        fn = moe_reduce.moe_reduce_rs if op == "rs" else \
            moe_reduce.moe_reduce_ar
        kernel = moe_reduce.RS_KERNEL if op == "rs" else moe_reduce.AR_KERNEL

        def call(dev):
            return fn(y.to(dev), w.to(dev), ctx=mesh)
    before = kernel.launches
    assert call("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        call("meta")
    assert kernel.launches == before
