"""The port's sequence-parallel slice against the JAX package's, on the CPU
in fp32 over n = 2 and 4 simulated ranks (S 64, d 64, 8 / 4 heads of 16),
the same seeded numpy inputs through both. JAX runs under ``shard_map``
on the conftest's CPU devices, through its XLA forms (``impl="xla"``, the
``*_ref`` oracles, and ``TRITON_DIST_TPU_FORCE_XLA`` for the fused ops,
which routes them to their XLA contracts); no interpret-mode Pallas
kernel runs. The port runs its plain versions on ``device="cpu"`` meshes.
fp32 results within 1e-5; exchanges, groupings and argument errors
exactly.

- ``pre_attn_a2a`` / ``post_attn_a2a`` / ``ulysses_attn`` (rows 18 and
  its plain form);
- ``a2a_gemm`` (row 28) in every impl and both swizzles;
- ``qkv_gemm_a2a`` / ``o_a2a_gemm`` (rows 29, 30) and the weight
  groupings, then ``ulysses_attn_fused``;
- ``sp_ag_attention_ref`` / ``sp_ag_attention`` / ``sp_ag_attention_fused``
  (row 31) causal, non-causal, GQA and varlen on JAX's ``CU_*``
  boundaries (``tests/test_sp.py:177-179``);
- ``layers.ulysses_sp.fwd`` in each impl against JAX's
  ``fwd(impl="xla")`` and a one-rank dense layer;
- JAX's argument errors, what still raises, and the wrappers' plain
  versions taken for CPU tensors only.

The kernels themselves run on the card: ``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py`` phases 36-37."""

import dataclasses
import functools
import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.layers import ulysses_sp as jul
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models.dense import init_params as jax_init_params
from triton_dist_tpu.ops import ulysses as jus
from triton_dist_tpu.ops import ulysses_fused as juf
from triton_dist_tpu.parallel.mesh import MeshContext as JaxMeshContext
from triton_dist_tpu.parallel.mesh import make_mesh as jax_make_mesh
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch import Engine, ModelConfig, make_mesh
from triton_dist_tpu_torch.layers import sp_flash_decode, tp_attn, ulysses_sp
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.ops import ulysses
from triton_dist_tpu_torch.ops import ulysses_fused as uf

# ``ops`` exports functions named as these modules, in both packages.
jag = importlib.import_module("triton_dist_tpu.ops.a2a_gemm")
jsp = importlib.import_module("triton_dist_tpu.ops.sp_ag_attention")
ag = importlib.import_module("triton_dist_tpu_torch.ops.a2a_gemm")
spa = importlib.import_module("triton_dist_tpu_torch.ops.sp_ag_attention")

TOL = dict(rtol=1e-5, atol=1e-5)
S, D, H, KV, HD = 64, 64, 8, 4, 16
FORCE_XLA = ("TRITON_DIST_TPU_FORCE_XLA", "ulysses_fused,sp_ag_attention")
CU = {"mixed": [0, 5, 19, 40, 51, 64], "padded": [0, 24, 64, 64, 64, 64, 64],
      "single": [0, 64]}


def _jmesh(n, axis="sp"):
    mesh = jax_make_mesh(**{axis: n}, devices=jax.devices()[:n])
    return mesh, JaxMeshContext.from_mesh(mesh)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _n(t):
    return t.detach().cpu().numpy()


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _sharded(a, n):
    """JAX's global (n·X, ...) array as the port's stacked (n, X, ...)."""
    a = np.asarray(a)
    return a.reshape(n, a.shape[0] // n, *a.shape[1:])


# ---- the Ulysses exchanges ------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_exchanges_against_jax(n):
    """``pre_attn_a2a`` exactly, the round trip exactly, ``ulysses_attn``
    within 1e-5 of JAX's (and of one rank's causal attention), in both of
    the port's transports."""
    q, k, v = _rand(1, S, H, HD), _rand(2, S, KV, HD), _rand(3, S, KV, HD)
    jm, _ = _jmesh(n)
    sh = P("sp", None, None)

    def run(a, b, c):
        pre = jus.pre_attn_a2a(a, axis="sp", impl="xla")
        return (pre, jus.post_attn_a2a(pre, axis="sp", impl="xla"),
                jus.ulysses_attn(a, b, c, axis="sp", impl="xla"))

    jpre, jpost, jatt = spmd(jm, run, (sh,) * 3, (sh,) * 3)(q, k, v)
    np.testing.assert_array_equal(np.asarray(jpost), q)
    mesh = make_mesh(sp=n, device="cpu")
    tq, tk, tv = (_t(_sharded(a, n)) for a in (q, k, v))
    dense = tp_attn.sdpa(_t(q)[None], _t(k)[None], _t(v)[None], causal=True)
    for impl in ("pallas", "xla"):
        pre = ulysses.pre_attn_a2a(tq, ctx=mesh, impl=impl)
        np.testing.assert_array_equal(_n(pre), _sharded(jpre, n))
        post = ulysses.post_attn_a2a(pre, ctx=mesh, impl=impl)
        np.testing.assert_array_equal(_n(post), _n(tq))
        att = ulysses.ulysses_attn(tq, tk, tv, ctx=mesh, impl=impl)
        np.testing.assert_allclose(_n(att), _sharded(jatt, n), **TOL)
        np.testing.assert_allclose(_n(att).reshape(S, H, HD),
                                   _n(dense[0]), **TOL)


# ---- row 28 ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_a2a_gemm(n):
    """JAX's ``a2a_gemm_ref`` on the ``tp`` axis (its default): x, the
    shared weight (d, N) and rank r's output rows."""
    c, n_out = 8, 24
    x = _rand(10 + n, n * n, c, D)        # rank s's (n, C, d), stacked
    w = _rand(20 + n, D, n_out) * D ** -0.5
    jm, _ = _jmesh(n, "tp")
    out = spmd(jm, lambda xs, ws: jag.a2a_gemm_ref(xs, ws, axis="tp"),
               (P("tp", None, None), P(None, None)), P("tp", None))(x, w)
    return x.reshape(n, n, c, D), w, _sharded(out, n)


@pytest.mark.parametrize("impl", ["fused", "pallas", "xla"])
@pytest.mark.parametrize("n", [2, 4])
def test_a2a_gemm_against_jax(n, impl):
    """Every impl within 1e-5 of JAX's oracle; the fused one in both
    swizzles, with the received rows (the exchange, exactly) and with one
    weight per rank."""
    x, w, want = _jax_a2a_gemm(n)
    mesh = make_mesh(tp=n, device="cpu")
    tx, tw = _t(x), _t(w.T)
    got = ag.a2a_gemm(tx, tw, ctx=mesh, axis="tp", impl=impl)
    np.testing.assert_allclose(_n(got), want, **TOL)
    if impl != "fused":
        return
    for mode in ag.SWIZZLE_MODES:
        ctx = ag.create_a2a_gemm_context(mesh, "tp", swizzle_mode=mode)
        out, recv = ag.a2a_gemm_fused(tx, tw, ctx, return_recv=True)
        np.testing.assert_allclose(_n(out), want, **TOL)
        np.testing.assert_array_equal(
            _n(recv), x.transpose(1, 0, 2, 3).reshape(n, -1, D))
    per_rank = torch.stack([tw * (r + 1) for r in range(n)])
    got = ag.a2a_gemm_fused(tx, per_rank, ag.create_a2a_gemm_context(
        mesh, "tp"))
    np.testing.assert_allclose(
        _n(got), want * np.arange(1, n + 1)[:, None, None], **TOL)


# ---- rows 29 and 30 -------------------------------------------------------

def _qkv_weights(seed):
    """JAX's (d, (H + 2·KV)·hd) QKV and (H·hd, d) O weights."""
    return (_rand(seed, D, (H + 2 * KV) * HD) * D ** -0.5,
            _rand(seed + 1, H * HD, D) * (H * HD) ** -0.5)


@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_fused_ops_against_jax(n, monkeypatch):
    """The weight groupings exactly (the port's are JAX's transposed per
    owner); ``qkv_gemm_a2a`` and ``o_a2a_gemm`` within 1e-5 of JAX's XLA
    contracts (its fused ops routed there) on the grouped weights."""
    monkeypatch.setenv(*FORCE_XLA)
    w_qkv, w_o = _qkv_weights(30 + n)
    kw = dict(n=n, num_heads=H, head_dim=HD)
    jq = np.asarray(juf.group_qkv_columns(w_qkv, num_kv_heads=KV, **kw))
    jo = np.asarray(juf.group_o_rows(w_o, **kw))
    tq = uf.group_qkv_columns(_t(w_qkv.T), num_kv_heads=KV, **kw)
    to = uf.group_o_rows(_t(w_o.T), **kw)
    np.testing.assert_array_equal(_n(tq), jq.transpose(0, 2, 1))
    np.testing.assert_array_equal(_n(to), jo.transpose(0, 2, 1))
    jm, jctx = _jmesh(n)
    fctx = juf.create_ulysses_fused_context(jctx, axis="sp")
    x = _rand(40 + n, S, D)
    o = _rand(50 + n, n * S, H * HD // n)
    jqkv = spmd(jm, lambda a, w: juf.qkv_gemm_a2a(a, w, fctx)[None],
                (P("sp", None), P(None, None, None)),
                P("sp", None, None, None))(x, jq)
    jout = spmd(jm, lambda a, w: juf.o_a2a_gemm(a, w, fctx),
                (P("sp", None), P(None, None, None)), P("sp", None))(o, jo)
    ctx = uf.create_ulysses_fused_context(make_mesh(sp=n, device="cpu"))
    np.testing.assert_allclose(
        _n(uf.qkv_gemm_a2a(_t(_sharded(x, n)), tq, ctx)), np.asarray(jqkv),
        **TOL)
    np.testing.assert_allclose(
        _n(uf.o_a2a_gemm(_t(_sharded(o, n)), to, ctx)), _sharded(jout, n),
        **TOL)


@pytest.mark.parametrize("n,causal", [(2, True), (4, False)])
def test_ulysses_attn_fused_against_jax(n, causal, monkeypatch):
    """The fused block (rows 29, 30 around the attention) within 1e-5 of
    JAX's on its XLA contracts."""
    monkeypatch.setenv(*FORCE_XLA)
    w_qkv, w_o = _qkv_weights(60 + n)
    kw = dict(n=n, num_heads=H, head_dim=HD)
    jq = juf.group_qkv_columns(w_qkv, num_kv_heads=KV, **kw)
    jo = juf.group_o_rows(w_o, **kw)
    x = _rand(70 + n, S, D)
    jm, jctx = _jmesh(n)
    fctx = juf.create_ulysses_fused_context(jctx, axis="sp")
    heads = dict(num_heads=H, num_kv_heads=KV, head_dim=HD, causal=causal)
    want = spmd(jm, lambda a, q_, o_: juf.ulysses_attn_fused(
        a, q_, o_, fctx, **heads), (P("sp", None), P(None, None, None),
                                    P(None, None, None)), P("sp", None))(
        x, jq, jo)
    ctx = uf.create_ulysses_fused_context(make_mesh(sp=n, device="cpu"))
    got = uf.ulysses_attn_fused(
        _t(_sharded(x, n)), _t(np.asarray(jq).transpose(0, 2, 1)),
        _t(np.asarray(jo).transpose(0, 2, 1)), ctx, **heads)
    np.testing.assert_allclose(_n(got), _sharded(want, n), **TOL)


# ---- row 31 ---------------------------------------------------------------

FORMS = {"causal": (4, True, None), "non-causal": (4, False, None),
         "gqa": (8, True, None), "cu-mixed": (4, True, "mixed"),
         "cu-padded": (4, True, "padded"), "cu-single": (4, True, "single")}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("n", [2, 4])
def test_sp_ag_attention_against_jax(n, form):
    """``sp_ag_attention_ref``, the ring ``sp_ag_attention`` and
    ``sp_ag_attention_fused`` (its plain version on the CPU) within 1e-5 of
    JAX's ``sp_ag_attention_ref``."""
    h, causal, cu_name = FORMS[form]
    cu = None if cu_name is None else np.array(CU[cu_name], np.int32)
    q, k, v = _rand(80, S, h, HD), _rand(81, S, 4, HD), _rand(82, S, 4, HD)
    jm, _ = _jmesh(n)
    sh = P("sp", None, None)
    jcu = None if cu is None else jnp.asarray(cu)
    want = spmd(jm, lambda a, b, c: jsp.sp_ag_attention_ref(
        a, b, c, axis="sp", causal=causal, cu_seqlens=jcu),
        (sh,) * 3, sh)(q, k, v)
    tq, tk, tv = (_t(_sharded(a, n)) for a in (q, k, v))
    tcu = None if cu is None else _t(cu)
    kw = dict(causal=causal, cu_seqlens=tcu)
    mesh = make_mesh(sp=n, device="cpu")
    for got in (spa.sp_ag_attention_ref(tq, tk, tv, **kw),
                spa.sp_ag_attention(tq, tk, tv, **kw),
                spa.sp_ag_attention_fused(tq, tk, tv, ctx=mesh, **kw)):
        np.testing.assert_allclose(_n(got), _sharded(want, n), **TOL)


# ---- the layer ------------------------------------------------------------

LAYER_KW = dict(hidden_size=D, num_attention_heads=H, num_key_value_heads=KV,
                head_dim=HD, num_hidden_layers=1)


@functools.lru_cache(maxsize=None)
def _jax_layer(n):
    """JAX's layer weights (q/k norms random) and its ``fwd(impl="xla")``
    over n ranks."""
    jcfg = JaxConfig.tiny(**LAYER_KW)
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(n),
                                                    jcfg))
    attn = tree["layers"][0]["attn"]
    attn["q_norm"] = 1 + 0.2 * _rand(90 + n, HD)
    attn["k_norm"] = 1 + 0.2 * _rand(91 + n, HD)
    x = _rand(92 + n, S, D)
    jm, jctx = _jmesh(n)
    want = spmd(jm, lambda p, a: jul.fwd(p, a, jcfg, axis="sp", ctx=jctx,
                                         impl="xla"),
                (jul.param_specs(), P("sp", None)), P("sp", None))(attn, x)
    return tree, x, np.asarray(want)


@pytest.mark.parametrize("impl", list(ulysses_sp.IMPLS))
@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_layer_against_jax(n, impl):
    """``ulysses_sp.fwd`` within 1e-5 of JAX's ``fwd(impl="xla")`` and of
    the port's one-rank dense layer on the same weights (``tp_attn``'s
    tree through ``from_jax_params``); the fused path groups its weights
    once per parameter set."""
    tree, x, want = _jax_layer(n)
    cfg = ModelConfig.tiny(**LAYER_KW)
    p = from_jax_params(tree, cfg, "cpu", torch.float32).layers[0].attn
    mesh = make_mesh(sp=n, device="cpu")
    got = ulysses_sp.fwd(p, _t(_sharded(x, n)), cfg, ctx=mesh, impl=impl)
    np.testing.assert_allclose(_n(got), _sharded(want, n), **TOL)
    dense, _ = tp_attn.fwd_prefill(p, _t(x), cfg, batch=1)
    np.testing.assert_allclose(_n(got).reshape(S, D), _n(dense), **TOL)
    if impl == "fused":
        first = ulysses_sp.grouped_weights(p, cfg, n)[0]
        assert ulysses_sp.grouped_weights(p, cfg, n)[0] is first
        views = ulysses_sp.param_specs(p, n)
        assert views["wq"].shape == (n, *p.wq.shape)
        assert views["wq"].data_ptr() == p.wq.data_ptr()


# ---- errors, what still raises, the wrappers ------------------------------

def _raise_both(exc, match, jax_fn, port_fn):
    with pytest.raises(exc, match=match):
        jax_fn()
    with pytest.raises(exc, match=match):
        port_fn()


@pytest.mark.parametrize("kind", ["init", "heads", "sequence", "varlen",
                                  "swizzle"])
def test_argument_errors_match_jax(kind):
    n = 4
    jm, jctx = _jmesh(n)
    mesh = make_mesh(sp=n, device="cpu")
    sh = P("sp", None, None)
    if kind == "init":
        jcfg = JaxConfig.tiny(**LAYER_KW)
        pcfg = ModelConfig.tiny(**LAYER_KW)
        fields = {f.name: getattr(pcfg, f.name)
                  for f in dataclasses.fields(pcfg)}
        for bad in (dict(attention_bias=True), dict(qk_norm=False),
                    dict(attn_gate=True)):
            _raise_both(
                NotImplementedError, "Qwen3 layer shape",
                lambda: jul.init(jax.random.PRNGKey(0),
                                 dataclasses.replace(jcfg, **bad)),
                lambda: ulysses_sp.init(SimpleNamespace(**fields, **bad),
                                        generator=torch.Generator()))
    elif kind == "heads":
        x = _rand(0, 4 * n, 6, HD)
        _raise_both(ValueError, "heads 6 not divisible by sp=4",
                    lambda: spmd(jm, lambda a: jus.pre_attn_a2a(
                        a, axis="sp", impl="xla"), sh, sh)(x),
                    lambda: ulysses.pre_attn_a2a(
                        _t(_sharded(x, n)), ctx=mesh))
    elif kind == "sequence":
        x = _rand(0, 6 * n, 2, HD)
        _raise_both(ValueError, "sequence 6 not divisible by sp=4",
                    lambda: spmd(jm, lambda a: jus.post_attn_a2a(
                        a, axis="sp", impl="xla"), sh, sh)(x),
                    lambda: ulysses.post_attn_a2a(
                        _t(_sharded(x, n)), ctx=mesh))
    elif kind == "varlen":
        q = _rand(0, S, 4, HD)
        cu = np.array(CU["mixed"], np.int32)
        _raise_both(ValueError, "varlen .cu_seqlens. requires causal=True",
                    lambda: spmd(jm, lambda a: jsp.sp_ag_attention(
                        a, a, a, axis="sp", causal=False,
                        cu_seqlens=jnp.asarray(cu)), sh, sh)(q),
                    lambda: spa.sp_ag_attention_fused(
                        *(_t(_sharded(q, n)),) * 3, ctx=mesh, causal=False,
                        cu_seqlens=_t(cu)))
        with pytest.raises(ValueError, match="requires causal=True"):
            spa.sp_ag_attention(*(_t(_sharded(q, n)),) * 3, causal=False,
                                cu_seqlens=_t(cu))
    else:
        _raise_both(ValueError, "unknown a2a_gemm swizzle_mode 'ring'",
                    lambda: jag.create_a2a_gemm_context(
                        jctx, "sp", swizzle_mode="ring"),
                    lambda: ag.create_a2a_gemm_context(
                        mesh, "sp", swizzle_mode="ring"))
        _raise_both(ValueError, "unknown ulysses swizzle_mode 'ring'",
                    lambda: juf.create_ulysses_fused_context(
                        jctx, "sp", swizzle_mode="ring"),
                    lambda: uf.create_ulysses_fused_context(
                        mesh, "sp", swizzle_mode="ring"))


@pytest.mark.parametrize("form", ["sp_ag_attention_2d", "sp_flash_decode"])
def test_unported_sp_forms_raise(form):
    """The hierarchical KV-allgather attention and the sequence-sharded
    decode layer raise, naming ROADMAP.md queue A item 6."""
    mesh = make_mesh(dp=2, sp=2, device="cpu")
    x = torch.zeros(4, 8, 4, HD)
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        if form == "sp_ag_attention_2d":
            spa.sp_ag_attention_2d(x, x, x, ctx=mesh, inner_axis="sp",
                                   outer_axis="dp")
        else:
            sp_flash_decode.fwd(None, x, None, x, x, 3, axis="sp")


def test_sp_mesh_and_entry_points():
    """``make_mesh(sp=4)`` builds and indexes its axis as ``tp``'s; an SP op
    over one axis of a two-axis mesh, an Engine over an sp axis, and the
    ep axis raise (the pp axis is ported: ``tests/test_torch_pp.py``);
    without CUDA the mesh needs ``device="cpu"``."""
    mesh = make_mesh(sp=4, device="cpu")
    tp = make_mesh(tp=4, device="cpu")
    assert mesh.size("sp") == mesh.n_ranks == 4
    for r in range(4):
        assert mesh.rank("sp", r) == tp.rank("tp", r) == r
        assert [mesh.device_id("sp", t, r) for t in range(4)] == [0, 1, 2, 3]
    grid = make_mesh(dp=2, sp=2, device="cpu")
    assert grid.stride("dp") == 2 and grid.rank("sp", 3) == 1
    with pytest.raises(ValueError, match="data-parallel replicas"):
        ulysses.pre_attn_a2a(torch.zeros(4, 2, 4, HD), ctx=grid)
    with pytest.raises(ValueError, match="queue A item 6"):
        Engine(ModelConfig.tiny(), mesh=grid, dtype=torch.float32)
    with pytest.raises(ValueError, match="dp x pp x sp x tp ranks only"):
        make_mesh(device="cpu", ep=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(sp=4)


def _row_calls(device):
    """Each kernel wrapper on small operands of ``device``: (module, kernel
    counter, the call, its plain version)."""
    n, kw = 2, dict(device=device)
    mesh = make_mesh(sp=n, device="cpu")
    x4 = torch.randn(n, n, 4, 16, **kw)
    w = torch.randn(8, 16, **kw)
    xs = torch.randn(n, 4, 16, **kw)
    wq = torch.randn(n, 8, 16, **kw)
    o = torch.randn(n, 8, 16, **kw)
    wo = torch.randn(n, 8, 16, **kw)
    q, k = torch.randn(n, 4, 2, 16, **kw), torch.randn(n, 4, 1, 16, **kw)
    uctx = uf.create_ulysses_fused_context(mesh)
    return {
        28: (ag.KERNEL,
             lambda: ag.a2a_gemm_fused(x4, w, ag.create_a2a_gemm_context(
                 mesh, "sp")), lambda: ag.a2a_gemm_ref(x4, w)),
        29: (uf.QKV_KERNEL, lambda: uf.qkv_gemm_a2a(xs, wq, uctx),
             lambda: uf.qkv_gemm_a2a_ref(xs, wq)),
        30: (uf.O_KERNEL, lambda: uf.o_a2a_gemm(o, wo, uctx),
             lambda: uf.o_a2a_gemm_ref(o, wo)),
        31: (spa.KERNEL,
             lambda: spa.sp_ag_attention_fused(q, k, k, ctx=mesh),
             lambda: spa.sp_ag_attention_ref(q, k, k))}


@pytest.mark.parametrize("row", [28, 29, 30, 31])
def test_sp_wrappers_take_plain_version_only_on_cpu(row):
    """On CPU tensors each wrapper returns its plain version's result; on
    any other device it goes to the kernel path, which raises here, and
    nothing is counted as a launch."""
    kernel, call, plain = _row_calls("cpu")[row]
    torch.testing.assert_close(call(), plain(), rtol=0, atol=0)
    kernel, call, _ = _row_calls("meta")[row]
    before = kernel.launches
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        call()
    assert kernel.launches == before
