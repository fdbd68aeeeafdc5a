"""The port's expert-parallel ops and layer against the JAX package's, on
the CPU in fp32 over 4 simulated ranks (2 for the skew router), seeded
numpy inputs.

- Row 18: ``all_to_all`` against JAX's kernel in interpret mode (equal),
  and at one rank the identity; ``all_to_all_ref`` against JAX's
  ``all_to_all_ref`` (equal).
- Row 23's wire: ``quantize_rows`` (int8 and fp8 codes and scales equal),
  ``wire_roundtrip`` (within 1e-6); ``ll_a2a`` against JAX's kernel in
  interpret mode on two back-to-back steps of opposite parity over 2 ranks
  (within 1e-6: one dequantized fp32 product apart at most).
- ``ragged_exchange`` / ``ragged_return`` against JAX's in a ``shard_map``,
  with and without a receive envelope that cuts rows: the sort
  permutation, both counts matrices, the sent rows and every received and
  returned row equal.
- ``ep_dispatch`` / ``ep_combine`` (drop-free, drop-free with an int8 wire,
  capped without and with overflow) against JAX's with ``impl="xla"`` (no
  Pallas kernel): index and state tensors equal, rows within 1e-5.
- The layer: ``expert_swiglu`` against JAX's ``sort_by_expert`` +
  ``grouped_swiglu`` (ragged_dot); ``ep_moe.fwd`` (drop-free and capped,
  and the skew router of ``tests/test_ep_serving.py``, every assignment on
  rank 0's experts; the drop-free cases also against ``ep_moe_ref``, the
  dense oracle) and ``fwd_decode`` (``"ar"``, ``"ragged"``) against JAX's
  within 1e-5 (sums in other orders).
- Row 17's per-rank tile maps and used-tile counts against the per-rank
  product; the wrappers' CPU-only plain versions; what still raises.
- The tile-fused EP of ``ops/ep_fused.py`` (rows 25-26's plain versions:
  ``ep_route`` exactly, ``ep_moe_fused`` and ``fwd_fused`` within 1e-5
  with equal drops, an overflow mix included) against JAX's interpret-mode
  kernels on 4 ranks, and the hierarchical half on a 2 x 2 mesh
  (``ep_dispatch_2d``/``ep_combine_2d`` rows and states exactly,
  ``fwd_2d`` and the ``"ll2d"`` decode within 1e-5, ``ll_a2a_2d`` bit for
  bit): ``test_ep_forms_against_jax[fused|hierarchical]``, then what
  still raises (``test_unported_ep_forms_raise``).

Only rows 18, 23, 25 and 26 of the JAX kernels above run in interpret
mode."""

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.layers import ep_moe as jep_moe
from triton_dist_tpu.ops import ep_a2a as jep_a2a
from triton_dist_tpu.ops import group_gemm as jgg
from triton_dist_tpu.ops import low_latency as jll
from triton_dist_tpu.ops.all_to_all import all_to_all as jall_to_all
from triton_dist_tpu.ops.all_to_all import all_to_all_ref as jall_to_all_ref
from triton_dist_tpu.parallel.mesh import MeshContext as JaxMeshContext
from triton_dist_tpu.parallel.mesh import make_mesh as jax_make_mesh
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch import make_mesh
from triton_dist_tpu_torch.layers import ep_moe
from triton_dist_tpu_torch.ops import all_to_all as a2a
from triton_dist_tpu_torch.ops import ep_a2a, ep_fused, group_gemm, low_latency

# The JAX op modules (``triton_dist_tpu.ops`` re-exports functions of
# the same names).
jep_fused = importlib.import_module("triton_dist_tpu.ops.ep_fused")
jll2d = importlib.import_module("triton_dist_tpu.ops.ll_a2a_2d")

TOL = dict(rtol=1e-5, atol=1e-5)
N = 4
E, K, D, F = 8, 2, 16, 12


def _jmesh(n=N):
    mesh = jax_make_mesh(tp=n, devices=jax.devices()[:n])
    return mesh, JaxMeshContext.from_mesh(mesh)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(t):
    return t.detach().cpu().numpy()


def _weights(seed, e=E, d=D, f=F):
    """JAX's layout (router (d, E), gate/up (E, d, f), down (E, f, d)) and
    the port's transposes of the same numbers."""
    rng = np.random.RandomState(seed)
    jw = {"router": rng.randn(d, e).astype(np.float32) * d ** -0.5,
          "w_gate": rng.randn(e, d, f).astype(np.float32) * d ** -0.5,
          "w_up": rng.randn(e, d, f).astype(np.float32) * d ** -0.5,
          "w_down": rng.randn(e, f, d).astype(np.float32) * f ** -0.5}
    tw = SimpleNamespace(router=_t(jw["router"].T),
                         w_gate=_t(jw["w_gate"].swapaxes(1, 2)),
                         w_up=_t(jw["w_up"].swapaxes(1, 2)),
                         w_down=_t(jw["w_down"].swapaxes(1, 2)))
    return {k: jnp.asarray(v) for k, v in jw.items()}, tw


def _routing(seed, n, t, skew_rank0=False):
    """Tokens (n, t, D) and top-K ids (n, t, K) of distinct experts."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, t, D).astype(np.float32)
    pool = E // n if skew_rank0 else E
    ids = np.stack([[rng.choice(pool, K, replace=False) for _ in range(t)]
                    for _ in range(n)]).astype(np.int32)
    return x, ids


def _ctx(n=N, **kw):
    return ep_a2a.create_ep_context(make_mesh(tp=n, device="cpu"),
                                    num_experts=E, topk=K, axis="tp", **kw)


def _jctx(jctx, **kw):
    return jep_a2a.create_ep_context(jctx, num_experts=E, topk=K, axis="tp",
                                     impl="xla", **kw)


# ---- row 18 ---------------------------------------------------------------

def test_all_to_all_matches_jax_kernel():
    """Row 18 in JAX's interpret mode, and JAX's reference: the port's
    result equals both; at one rank the op returns its input."""
    jm, jctx = _jmesh()
    x = np.random.RandomState(1).randn(N * N, 3, D).astype(np.float32)
    f_k = spmd(jm, lambda v: jall_to_all(v, ctx=jctx, axis="tp"),
               P("tp", None, None), P("tp", None, None))
    f_r = spmd(jm, lambda v: jall_to_all_ref(v, axis="tp"),
               P("tp", None, None), P("tp", None, None))
    got = a2a.all_to_all(_t(x).view(N, N, 3, D),
                         ctx=make_mesh(tp=N, device="cpu"), axis="tp")
    for want in (np.asarray(f_k(jnp.asarray(x))),
                 np.asarray(f_r(jnp.asarray(x)))):
        np.testing.assert_array_equal(_n(got).reshape(N * N, 3, D), want)
    one = _t(x[:1]).view(1, 1, 3, D)
    assert a2a.all_to_all(one, ctx=make_mesh(device="cpu"), axis="tp") is one


# ---- row 23 ---------------------------------------------------------------

@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_quantize_rows_equal_jax(wire):
    """Codes and scales equal JAX's bit for bit (zero rows too), the round
    trip within 1e-6."""
    jdt, tdt = {"int8": (jnp.int8, torch.int8),
                "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}[wire]
    rng = np.random.RandomState(3)
    v = (rng.randn(6, 40) * np.logspace(-3, 2, 6)[:, None]).astype(np.float32)
    v[2] = 0.0
    jq, js = jll.quantize_rows(jnp.asarray(v), jdt)
    tq, ts = low_latency.quantize_rows(_t(v), tdt)
    np.testing.assert_array_equal(_n(tq.view(torch.uint8)),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(_n(ts), np.asarray(js))
    assert low_latency.wire_max(tdt) == jll.wire_max(jdt)
    np.testing.assert_allclose(
        _n(low_latency.wire_roundtrip(_t(v), tdt)),
        np.asarray(jll.wire_roundtrip(jnp.asarray(v), jdt)), rtol=0,
        atol=1e-6)


def test_ll_a2a_matches_jax_kernel_back_to_back():
    """Row 23 in JAX's interpret mode: two exchanges in a row at step
    parities 0 and 1, int8 on the wire; at one rank the wire round trip."""
    n = 2                     # interpret mode's DMAs grow with n * n
    jm, jctx = _jmesh(n)
    x = np.random.RandomState(4).randn(n * n, 4, 32).astype(np.float32)

    def two_steps(v):
        a = jll.ll_a2a(v, ctx=jctx, axis="tp", step=0)
        return jll.ll_a2a(a, ctx=jctx, axis="tp", step=1)

    want = np.asarray(spmd(jm, two_steps, P("tp", None, None),
                           P("tp", None, None))(jnp.asarray(x)))
    mesh = make_mesh(tp=n, device="cpu")
    a = low_latency.ll_a2a(_t(x).view(n, n, 4, 32), ctx=mesh, axis="tp",
                           step=0)
    got = low_latency.ll_a2a(a, ctx=mesh, axis="tp", step=1)
    np.testing.assert_allclose(_n(got).reshape(n * n, 4, 32), want, rtol=0,
                               atol=1e-6)
    one = _t(x[:1]).view(1, 1, 4, 32)
    torch.testing.assert_close(
        low_latency.ll_a2a(one, ctx=make_mesh(device="cpu"), axis="tp"),
        low_latency.wire_roundtrip(one, torch.int8), rtol=0, atol=0)


# ---- the ragged hop -------------------------------------------------------

@pytest.mark.parametrize("recv_rows", [None, 9])
def test_ragged_exchange_and_return_equal_jax(recv_rows):
    """Index state and every row equal JAX's; 9 rows a rank cuts the
    tail sources' rows (skewed destinations)."""
    jm, _ = _jmesh()
    rng = np.random.RandomState(5)
    rows = 7
    dst = rng.choice([-1, 0, 1, 1, 2, 3], (N, rows)).astype(np.int32)
    vals = rng.randn(N, rows, 3).astype(np.float32)
    tags = rng.randint(0, 100, (N, rows)).astype(np.int32)

    def jfn(v, tg, ds):
        (rv, rt), st = jep_a2a.ragged_exchange((v, tg), ds, "tp",
                                               fills=(0, -1),
                                               recv_rows=recv_rows)
        back = jep_a2a.ragged_return(rv * 2.0, st, "tp", out_rows=rows)
        return (rv, rt, back, st.perm[None], st.counts_mat[None],
                st.orig_counts_mat[None], st.sent_sorted[None])

    out = spmd(jm, jfn, (P("tp", None), P("tp"), P("tp")),
               (P("tp", None), P("tp"), P("tp", None), P("tp", None),
                P("tp", None, None), P("tp", None, None), P("tp", None)))(
        jnp.asarray(vals.reshape(N * rows, 3)),
        jnp.asarray(tags.reshape(-1)), jnp.asarray(dst.reshape(-1)))
    rv, rt, back, perm, cm, ocm, sent = (np.asarray(o) for o in out)
    (tv, tt), st = ep_a2a.ragged_exchange((_t(vals), _t(tags)), _t(dst),
                                          (0, -1), recv_rows)
    r = rv.shape[0] // N
    np.testing.assert_array_equal(_n(tv), rv.reshape(N, r, 3))
    np.testing.assert_array_equal(_n(tt), rt.reshape(N, r))
    np.testing.assert_array_equal(_n(st.perm), perm)
    for c in cm.reshape(N, N, N):
        np.testing.assert_array_equal(_n(st.counts_mat), c)
    for c in ocm.reshape(N, N, N):
        np.testing.assert_array_equal(_n(st.orig_counts_mat), c)
    np.testing.assert_array_equal(_n(st.sent_sorted), sent)
    got = ep_a2a.ragged_return(tv * 2.0, st, out_rows=rows)
    np.testing.assert_array_equal(_n(got), back.reshape(N, rows, 3))


# ---- dispatch / combine ---------------------------------------------------

DISPATCH = {"dropfree": {}, "dropfree-int8": {"wire": "int8"},
            "capped": {"capacity": 8}, "capped-overflow": {"capacity": 3}}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_dispatch_combine_matches_jax(case):
    kw = DISPATCH[case]
    wire = kw.get("wire")
    jm, jctx = _jmesh()
    t = 6
    x, ids = _routing(6, N, t)
    w = np.random.RandomState(7).rand(N, t, K).astype(np.float32)
    jkw = dict(capacity=kw.get("capacity"),
               wire_dtype=jnp.int8 if wire else None)
    jc = _jctx(jctx, **jkw)

    def jfn(tok, tid, tw):
        rt, re, st = jep_a2a.ep_dispatch(tok, tid, jc)
        y = jep_a2a.ep_combine(rt * 3.0, st, tw, jc)
        return rt, re, y, st.valid[None], st.num_dropped[None]

    rt, re, y, valid, dropped = (np.asarray(o) for o in spmd(
        jm, jfn, (P("tp", None), P("tp", None), P("tp", None)),
        (P("tp", None), P("tp"), P("tp", None), P("tp", None, None),
         P("tp")))(jnp.asarray(x.reshape(-1, D)),
                   jnp.asarray(ids.reshape(-1, K)),
                   jnp.asarray(w.reshape(-1, K))))
    tc = _ctx(capacity=kw.get("capacity"),
              wire_dtype=torch.int8 if wire else None)
    trt, tre, st = ep_a2a.ep_dispatch(_t(x), _t(ids), tc)
    r = rt.shape[0] // N
    np.testing.assert_allclose(_n(trt), rt.reshape(N, r, D), **TOL)
    np.testing.assert_array_equal(_n(tre), re.reshape(N, r))
    np.testing.assert_array_equal(_n(st.valid), valid)
    np.testing.assert_array_equal(_n(st.num_dropped), dropped)
    if case == "capped-overflow":
        assert int(st.num_dropped.sum()) > 0
    ty = ep_a2a.ep_combine(trt * 3.0, st, _t(w), tc)
    np.testing.assert_allclose(_n(ty), y.reshape(N, t, D), **TOL)


# ---- the layer ------------------------------------------------------------

def test_expert_swiglu_matches_jax_grouped_swiglu():
    """Every rank's received rows through the row-tile layout and row 17's
    plain version against JAX's sort_by_expert + grouped_swiglu
    (ragged_dot) + unsort; empty rows (-1) give zeros."""
    jw, tw = _weights(8)
    rng = np.random.RandomState(9)
    rows = rng.randn(N, 11, D).astype(np.float32)
    e_loc = E // N
    loc = rng.randint(-1, e_loc, (N, 11)).astype(np.int32)
    got = ep_moe.expert_swiglu(ep_moe.param_specs(tw, N), _t(rows), _t(loc),
                               block_m=8)
    for r in range(N):
        sl = slice(r * e_loc, (r + 1) * e_loc)
        s_tok, sizes, inv = jgg.sort_by_expert(jnp.asarray(rows[r]),
                                               jnp.asarray(loc[r]), e_loc)
        want = np.asarray(jgg.grouped_swiglu(
            s_tok, jw["w_gate"][sl], jw["w_up"][sl], jw["w_down"][sl],
            sizes)[inv])
        np.testing.assert_allclose(_n(got[r]), want, **TOL)
        assert not _n(got[r])[loc[r] < 0].any()


FWD = {"dropfree": {}, "capped": {"capacity": 5}, "skew": {}}


@pytest.mark.parametrize("case", list(FWD))
def test_ep_fwd_matches_jax(case):
    """``ep_moe.fwd`` on each rank's own rows. "skew": 2 ranks and JAX's
    adversarial router (a ±g pair in columns 0 and 1, zeros elsewhere:
    every assignment lands on rank 0's experts)."""
    n = 2 if case == "skew" else N
    jm, jctx = _jmesh(n)
    jw, tw = _weights(10)
    if case == "skew":
        g = np.random.RandomState(0).randn(D).astype(np.float32)
        r = np.zeros((D, E), np.float32)
        r[:, 0], r[:, 1] = g, -g
        jw["router"], tw.router = jnp.asarray(r), _t(r.T)
    t = 6
    x = np.random.RandomState(11).randn(n, t, D).astype(np.float32)
    jc = _jctx(jctx, capacity=FWD[case].get("capacity"))
    want = np.asarray(spmd(
        jm, lambda p, v: jep_moe.fwd(p, v, jc, topk=K),
        (jep_moe.param_specs("tp"), P("tp", None)), P("tp", None))(
        jw, jnp.asarray(x.reshape(-1, D))))
    tc = ep_a2a.create_ep_context(make_mesh(tp=n, device="cpu"),
                                  num_experts=E, topk=K, axis="tp",
                                  capacity=FWD[case].get("capacity"))
    got = ep_moe.fwd(tw, _t(x), tc, topk=K, block_m=8)
    np.testing.assert_allclose(_n(got).reshape(-1, D), want, **TOL)
    if case != "capped":     # the dense oracle drops nothing

        def expert(tok, e):
            h = (torch.nn.functional.silu(tok @ tw.w_gate[e].T)
                 * (tok @ tw.w_up[e].T))
            return h @ tw.w_down[e].T

        ids, w = ep_moe.route(tw.router, _t(x).reshape(-1, D), K)
        np.testing.assert_allclose(_n(got).reshape(-1, D), _n(
            ep_a2a.ep_moe_ref(_t(x).reshape(-1, D), ids, w, expert, E)),
            **TOL)
    if case == "skew":
        ids, _ = ep_moe.route(tw.router, _t(x).reshape(-1, D), K)
        assert int(ids.max()) < E // n


@pytest.mark.parametrize("transport", ["ar", "ragged"])
def test_ep_fwd_decode_matches_jax(transport):
    jm, jctx = _jmesh()
    jw, tw = _weights(12)
    b = 3
    x = np.random.RandomState(13).randn(b, D).astype(np.float32)
    jc = _jctx(jctx)
    want = np.asarray(spmd(
        jm, lambda p, v: jep_moe.fwd_decode(p, v, topk=K, axis="tp",
                                            transport=transport,
                                            ep_ctx=jc),
        (jep_moe.param_specs("tp"), P(None, None)), P(None, None))(
        jw, jnp.asarray(x)))
    got = ep_moe.fwd_decode(tw, _t(x).expand(N, b, D), topk=K, axis="tp",
                            transport=transport, ep_ctx=_ctx())
    for r in range(N):
        np.testing.assert_allclose(_n(got[r]), want, **TOL)


# ---- row 17's per-rank form ----------------------------------------------

def test_grouped_gemm_tiles_per_rank_maps_and_used_tiles():
    """Each rank's own tile map and used-tile count: the tiles before the
    count equal the per-rank product, the rest are zeros; a shared map
    with per-chunk counts (the tensor-parallel down projection) too."""
    rng = np.random.RandomState(14)
    n, tiles, tm, e, f, d = 3, 6, 4, 5, 7, 8
    x = _t(rng.randn(n, tiles * tm, d).astype(np.float32))
    w = _t(rng.randn(n, e, f, d).astype(np.float32))
    te = _t(rng.randint(0, e, (n, tiles)).astype(np.int32))
    used = _t(np.array([[6], [2], [0]], np.int32))
    got = group_gemm.grouped_gemm_tiles(x, w, te, used=used)
    for r in range(n):
        want = group_gemm.grouped_gemm_tiles_ref(x[r], w[r], te[r])
        cut = int(used[r, 0]) * tm
        torch.testing.assert_close(got[r, :cut], want[:cut])
        assert not got[r, cut:].any()
    shared = _t(np.array([2, 1, 3], np.int32))        # 3 chunks of 2 tiles
    got = group_gemm.grouped_gemm_tiles(x, w, te[0], used=shared)
    for r in range(n):
        want = group_gemm.grouped_gemm_tiles_ref(x[r], w[r], te[0])
        keep = torch.tensor([1, 1, 1, 0, 1, 1]).bool().repeat_interleave(tm)
        torch.testing.assert_close(got[r][keep], want[keep])
        assert not got[r][~keep].any()
    with pytest.raises(ValueError, match="equal chunks"):
        group_gemm.grouped_gemm_tiles(x, w, te, used=_t(np.ones((n, 4),
                                                                np.int32)))


# ---- wrappers, errors -----------------------------------------------------

def _a2a_call(dev):
    x = torch.zeros(N, N, 2, 8, device=dev)
    return a2a.all_to_all(x, ctx=make_mesh(tp=N, device="cpu"), axis="tp")


def _ragged_call(dev):
    m = torch.zeros(N, N, dtype=torch.int32, device=dev)
    return a2a.ragged_all_to_all(torch.zeros(N, 3, 8, device=dev),
                                 torch.zeros(N, 12, 8, device=dev), m, m, m,
                                 ctx=make_mesh(tp=N, device="cpu"),
                                 axis="tp")


def _ll_call(dev):
    x = torch.zeros(N, N, 2, 8, device=dev)
    return low_latency.ll_a2a(x, ctx=make_mesh(tp=N, device="cpu"),
                              axis="tp")


@pytest.mark.parametrize("call,mod", [(_a2a_call, a2a), (_ragged_call, a2a),
                                      (_ll_call, low_latency)],
                         ids=["all_to_all", "ragged", "ll_a2a"])
def test_wrappers_take_the_plain_version_only_on_cpu(call, mod):
    """Any device but the CPU launches the kernel or raises."""
    before = mod.KERNEL.launches
    assert call("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        call("meta")
    assert mod.KERNEL.launches == before


def _fused_against_jax():
    """Tile-fused EP (rows 25-26's plain versions) against JAX's, on 4
    ranks at ``tests/test_ep_fused.py``'s widths (its interpret-mode
    kernels stall on larger CPU workspaces): ``ep_route`` exactly, with a
    capacity that overflows (experts drawn from a pool of 3) and one that
    does not; ``ep_moe_fused`` on the overflow mix and ``fwd_fused`` on
    the ample capacity within 1e-5, with equal ``num_dropped``."""
    jm, jctx = _jmesh()
    mesh = make_mesh(tp=N, device="cpu")
    t, f = 4, 8
    jw, tw = _weights(21, f=f)
    rng = np.random.RandomState(22)
    x = rng.randn(N, t, D).astype(np.float32)
    ids = np.stack([[rng.choice(3, K, replace=False) for _ in range(t)]
                    for _ in range(N)]).astype(np.int32)
    wts = rng.rand(N, t, K).astype(np.float32)
    jx, jids = jnp.asarray(x.reshape(-1, D)), jnp.asarray(ids.reshape(-1, K))
    ctxs = {}
    for cap in (2, t * K):
        kw = dict(num_experts=E, topk=K, capacity_per_expert=cap, axis="tp")
        jc = jep_fused.create_ep_fused_context(jctx, block_f=2 * f,
                                               block_d=D, **kw)
        tc = ctxs[cap] = ep_fused.create_ep_fused_context(mesh, **kw)

        def jroute(tk, i, jc=jc):
            send, st = jep_fused.ep_route(tk, i, jc)
            return (send, st.slot_rank, st.slot_expert, st.slot_index,
                    st.valid, st.num_dropped[None])

        want = [np.asarray(o) for o in spmd(
            jm, jroute, (P("tp", None), P("tp", None)),
            (P("tp"),) + (P("tp", None),) * 4 + (P("tp"),))(jx, jids)]
        send, st = ep_fused.ep_route(_t(x), _t(ids), tc)
        for got, w in zip((send, st.slot_rank, st.slot_expert,
                           st.slot_index, st.valid, st.num_dropped), want):
            np.testing.assert_array_equal(_n(got), w.reshape(got.shape))
        assert (int(st.num_dropped.sum()) > 0) == (cap == 2)
    jc = jep_fused.create_ep_fused_context(
        jctx, num_experts=E, topk=K, capacity_per_expert=2, axis="tp",
        block_f=2 * f, block_d=D)
    sh = P("tp", None, None)

    def jfused(wg, wu, wd, tk, i, ww):
        out, dropped = jep_fused.ep_moe_fused(tk, i, ww, wg, wu, wd, jc)
        return out, dropped[None]

    jo, jd = spmd(jm, jfused, (sh, sh, sh) + (P("tp", None),) * 3,
                  (P("tp", None), P("tp")))(
        jw["w_gate"], jw["w_up"], jw["w_down"], jx, jids,
        jnp.asarray(wts.reshape(-1, K)))
    spec = ep_moe.param_specs(tw, N)
    to, td = ep_fused.ep_moe_fused(_t(x), _t(ids), _t(wts), spec["w_gate"],
                                   spec["w_up"], spec["w_down"], ctxs[2])
    np.testing.assert_allclose(_n(to), np.asarray(jo).reshape(N, t, D), **TOL)
    np.testing.assert_array_equal(_n(td), np.asarray(jd))
    jc = jep_fused.create_ep_fused_context(
        jctx, num_experts=E, topk=K, capacity_per_expert=t * K, axis="tp",
        block_f=2 * f, block_d=D)

    def jfwd(p, tk):
        out, dropped = jep_moe.fwd_fused(p, tk, jc, topk=K)
        return out, dropped[None]

    jo, jd = spmd(jm, jfwd, (jep_moe.param_specs("tp"), P("tp", None)),
                  (P("tp", None), P("tp")))(jw, jx)
    to, td = ep_moe.fwd_fused(tw, _t(x), ctxs[t * K], topk=K)
    np.testing.assert_allclose(_n(to), np.asarray(jo).reshape(N, t, D), **TOL)
    np.testing.assert_array_equal(_n(td), np.asarray(jd))


def _hierarchical_against_jax():
    """The hierarchical half against JAX's on a 2 x 2 mesh (dp outer, tp
    inner): ``ep_dispatch_2d`` / ``ep_combine_2d`` (received rows and
    experts, every hop's sort permutation and sent rows, each group's
    block of the counts matrices, exactly; the combine within 1e-5),
    ``fwd_2d`` and the ``"ar"``/``"ll2d"`` decode within 1e-5,
    ``ll_a2a_2d`` bit for bit on the int8 and fp8 wires in both hop
    ``impl``s (JAX's outside ``jit``, whose constant-divisor rewrite
    moves a scale by an ulp), its put ledger and ``hop_put_counts``
    equal."""
    ax = ("dp", "tp")
    jm = Mesh(np.array(jax.devices()[:N]).reshape(2, 2), ax)
    jctx = JaxMeshContext.from_mesh(jm)
    mesh = make_mesh(dp=2, tp=2, device="cpu")
    kw = dict(num_experts=E, topk=K, outer_axis="dp", inner_axis="tp")
    jc = jep_a2a.create_ep2d_context(jctx, **kw)
    tc = ep_a2a.create_ep2d_context(mesh, **kw)
    jw, tw = _weights(23)
    t = 6
    x, ids = _routing(24, N, t)
    w = np.random.RandomState(25).rand(N, t, K).astype(np.float32)

    def jfn(tok, tid, tw_):
        rt, re, st = jep_a2a.ep_dispatch_2d(tok, tid, jc)
        y = jep_a2a.ep_combine_2d(rt * 3.0, st, tw_, jc)
        return (rt, re, y) + tuple(
            a[None] for hop in (st.inner, st.outer) for a in (
                hop.perm, hop.counts_mat, hop.orig_counts_mat,
                hop.sent_sorted))

    hop_specs = (P(ax, None), P(ax, None, None), P(ax, None, None),
                 P(ax, None))
    out = [np.asarray(o) for o in spmd(
        jm, jfn, (P(ax, None),) * 3,
        (P(ax, None), P(ax), P(ax, None)) + hop_specs * 2)(
        jnp.asarray(x.reshape(-1, D)), jnp.asarray(ids.reshape(-1, K)),
        jnp.asarray(w.reshape(-1, K)))]
    rt, re, st = ep_a2a.ep_dispatch_2d(_t(x), _t(ids), tc)
    np.testing.assert_array_equal(_n(rt), out[0].reshape(rt.shape))
    np.testing.assert_array_equal(_n(re), out[1].reshape(re.shape))
    np.testing.assert_allclose(
        _n(ep_a2a.ep_combine_2d(rt * 3.0, st, _t(w), tc)),
        out[2].reshape(N, t, D), **TOL)
    for hop, axis, i in ((st.inner, "tp", 3), (st.outer, "dp", 7)):
        np.testing.assert_array_equal(_n(hop.perm), out[i].reshape(N, -1))
        np.testing.assert_array_equal(_n(hop.sent_sorted),
                                      out[i + 3].reshape(N, -1))
        for r in range(N):
            grp = np.ix_(*[[mesh.device_id(axis, p, r) for p in range(2)]] * 2)
            np.testing.assert_array_equal(_n(hop.counts_mat)[grp],
                                          out[i + 1][r])
            np.testing.assert_array_equal(_n(hop.orig_counts_mat)[grp],
                                          out[i + 2][r])
    want = spmd(jm, lambda p, v: jep_moe.fwd_2d(p, v, jc, topk=K),
                (jep_moe.param_specs(ax), P(ax, None)), P(ax, None))(
        jw, jnp.asarray(x.reshape(-1, D)))
    np.testing.assert_allclose(_n(ep_moe.fwd_2d(tw, _t(x), tc, topk=K)),
                               np.asarray(want).reshape(N, t, D), **TOL)
    b = 3
    xd = np.random.RandomState(26).randn(b, D).astype(np.float32)
    for transport in ("ar", "ll2d"):
        want = np.asarray(spmd(
            jm, lambda p, v: jep_moe.fwd_decode(
                p, v, topk=K, axis=ax, transport=transport, ep_ctx=jc),
            (jep_moe.param_specs(ax), P(None, None)), P(None, None))(
            jw, jnp.asarray(xd)))
        got = ep_moe.fwd_decode(tw, _t(xd).expand(N, b, D), topk=K, axis=ax,
                                transport=transport, ep_ctx=tc)
        for r in range(N):
            np.testing.assert_allclose(_n(got[r]), want, **TOL)
    xs = np.random.RandomState(27).randn(N, N, 3, 32).astype(np.float32)
    for jdt, tdt in ((jnp.int8, torch.int8),
                     (jnp.float8_e4m3fn, torch.float8_e4m3fn)):
        with jll2d.record_dispatch_puts() as jled:
            want = spmd(jm, lambda v: jll2d.ll_a2a_2d(
                v, ctx=jctx, outer_axis="dp", inner_axis="tp", step=1,
                wire_dtype=jdt), P(ax, None, None), P(ax, None, None),
                jit=False)(jnp.asarray(xs.reshape(N * N, 3, 32)))
        for impl in ("kernel", "xla"):
            with low_latency.record_dispatch_puts() as led:
                got = low_latency.ll_a2a_2d(
                    _t(xs), ctx=mesh, outer_axis="dp", inner_axis="tp",
                    step=1, wire_dtype=tdt, impl=impl)
            np.testing.assert_array_equal(_n(got),
                                          np.asarray(want).reshape(xs.shape))
            assert led == jled
    assert low_latency.hop_put_counts(
        mesh, outer_axis="dp", inner_axis="tp") == jll2d.hop_put_counts(
        jctx, outer_axis="dp", inner_axis="tp")
    return tc


@pytest.mark.parametrize("form", ["fused", "hierarchical"])
def test_ep_forms_against_jax(form):
    """The tile-fused EP (:func:`_fused_against_jax`) and the hierarchical
    half (:func:`_hierarchical_against_jax`) held to JAX."""
    if form == "fused":
        _fused_against_jax()
    else:
        _hierarchical_against_jax()


def test_unported_ep_forms_raise():
    """What stays for later slices raises, naming its ROADMAP.md item, and
    JAX's knob errors hold (the forms this test once held to raising are
    ported and held to JAX by :func:`test_ep_forms_against_jax`)."""
    ctx2d = ep_a2a.create_ep2d_context(
        make_mesh(dp=2, tp=2, device="cpu"), num_experts=E, topk=K,
        outer_axis="dp", inner_axis="tp")
    _, tw = _weights(15)
    x = torch.zeros(N, 2, D)
    with pytest.raises(ValueError, match="needs a hierarchical EP2DContext"):
        ep_moe.fwd_decode(tw, x, topk=K, transport="ll2d", ep_ctx=_ctx())
    with pytest.raises(ValueError, match="does not consult replicas"):
        ep_moe.fwd_decode(tw, x, topk=K, transport="ll2d", ep_ctx=ctx2d,
                          replicas={"slot_expert": torch.zeros(1)})
    with pytest.raises(ValueError, match="queue A item 8"):
        ep_moe.fwd_decode(tw, x, topk=K, transport="ll", ep_ctx=_ctx(),
                          replicas={"slot_expert": torch.zeros(1)})
    with pytest.raises(ValueError, match="transport must be one of"):
        ep_moe.fwd_decode(tw, x, topk=K, transport="bogus", ep_ctx=_ctx())
    with pytest.raises(ValueError, match="needs a flat EPContext"):
        ep_moe.fwd_decode(tw, x, topk=K, transport="ragged")
    with pytest.raises(ValueError, match="needs a flat EPContext"):
        ep_moe.fwd_decode(tw, x, topk=K, transport="ll", ep_ctx=ctx2d)
    assert ep_moe.resolve_transport("auto", ctx=_ctx(), batch=2, hidden=D,
                                    dtype=torch.float32, topk=K) == "ll"
    assert ep_moe.resolve_transport("auto", ctx=ctx2d, batch=2, hidden=D,
                                    dtype=torch.float32, topk=K) == "ll2d"
    assert ep_moe.resolve_transport("auto", ctx=None, batch=2, hidden=D,
                                    dtype=torch.float32, topk=K) == "ar"
    assert ep_moe.DECODE_TRANSPORTS == jep_moe.DECODE_TRANSPORTS
    with pytest.raises(ValueError, match="not divisible by ep=3"):
        ep_a2a.create_ep_context(make_mesh(tp=3, device="cpu"),
                                 num_experts=E, topk=K, axis="tp")
    with pytest.raises(ValueError, match="not divisible by dpxtp=4"):
        ep_a2a.create_ep2d_context(make_mesh(dp=2, tp=2, device="cpu"),
                                   num_experts=6, topk=K, outer_axis="dp",
                                   inner_axis="tp")
