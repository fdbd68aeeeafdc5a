"""The port's pipeline slice against the JAX package's, on the CPU in fp32:
the same seeded numpy inputs through both, JAX under ``shard_map`` on the
conftest's CPU devices, the port's plain versions on ``device="cpu"``
meshes.

- The one-sided ops (rows 32, 33, 2, 6) over 8 ranks: ``p2p_put`` (a
  shift, a partial permutation, a multicast forward) against JAX's
  ``p2p_put`` run as ``tests/test_collectives.py`` runs it (Pallas in
  interpret mode) and its ``ppermute_ref``; ``broadcast`` for roots 0 and
  5; ``all_gather(mode="full_mesh")``; ``all_reduce(method=RECURSIVE)``
  and its validation. The copies exactly, the recursive sum within 1e-5.
- ``layers.pp_comm`` over 4 stages: ``gpipe_forward`` with JAX's ``tanh(h
  @ w)`` stage in both boundary impls and both collects (JAX's schedule
  with its boundary in interpret mode for ``"pallas"``), its gradient
  under ``remat`` on ``impl="xla"`` against ``jax.grad``, and
  ``pipeline_forward`` against JAX's relay; within 1e-5.
- The slice as a whole: a 4-layer ``ModelConfig.tiny`` at ``pp=4`` (one
  layer a stage) through ``gpipe_forward`` against JAX's dense
  ``forward_tokens`` on the same weights (``from_jax_params``): logits
  within 1e-4, greedy tokens equal.
- ``make_mesh(pp=n)`` and what still raises.

The kernels themselves run on the card: ``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py`` phases 38-39."""

import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.layers import pp_comm as jpp
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models import dense as jdense
from triton_dist_tpu.ops import (AllReduceMethod as JMethod, all_gather as
                                 jall_gather, all_reduce as jall_reduce,
                                 broadcast as jbroadcast,
                                 broadcast_ref as jbroadcast_ref,
                                 p2p_put as jp2p_put,
                                 ppermute_ref as jppermute_ref)
from triton_dist_tpu.parallel.mesh import MeshContext as JaxMeshContext
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch import Engine, ModelConfig, make_mesh
from triton_dist_tpu_torch.layers import pp_comm
from triton_dist_tpu_torch.layers.norm import rms_norm
from triton_dist_tpu_torch.models import dense
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.ops import (AllReduceMethod, allgather, allreduce,
                                       p2p, p2p_put, ppermute_ref)

# ``ops`` exports a function named as this module.
bcast = importlib.import_module("triton_dist_tpu_torch.ops.broadcast")

TOL = dict(rtol=1e-5, atol=1e-5)
S, D, M, MB = 4, 16, 4, 3            # stages, width, microbatches, rows


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jmesh(n, axis):
    mesh = Mesh(np.array(jax.devices()[:n]), (axis,))
    return mesh, JaxMeshContext.from_mesh(mesh)


def _stacked(a, n):
    """JAX's global (n·X, ...) array as the port's stacked (n, X, ...)."""
    a = np.asarray(a)
    return a.reshape(n, a.shape[0] // n, *a.shape[1:])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _jrun(jm, fn, x, spec=P("tp", None)):
    return np.asarray(spmd(jm, fn, spec, spec)(jnp.asarray(x)))


# ---- the mesh and what still raises ---------------------------------------

def test_pp_mesh_and_what_still_raises():
    mesh = make_mesh(pp=4, device="cpu")
    assert mesh.size("pp") == mesh.n_ranks == 4 and mesh.stride("pp") == 1
    assert [mesh.rank("pp", r) for r in range(4)] == [0, 1, 2, 3]
    assert [mesh.device_id("pp", 3, r) for r in range(4)] == [3] * 4
    grid = make_mesh(dp=2, pp=2, tp=2, device="cpu")
    assert (grid.stride("dp"), grid.stride("pp"), grid.n_ranks) == (4, 2, 8)
    assert [grid.rank("pp", r) for r in range(8)] == [0, 0, 1, 1] * 2
    assert grid.device_id("pp", 1, 4) == 6
    # Over the pp axis of a 2 x 2 x 2 mesh each (dp, tp) group runs alone.
    x = torch.arange(8.0).view(8, 1)
    got = p2p_put(x, [(0, 1)], ctx=grid, axis="pp").flatten().tolist()
    assert got == [0, 0, 0, 1, 0, 0, 4, 5]
    assert bcast.broadcast(x, 1, ctx=grid, axis="pp").flatten(
    ).tolist() == [2, 3, 2, 3, 6, 7, 6, 7]
    with pytest.raises(ValueError, match="item 5"):
        make_mesh(pp=2, ep=2, device="cpu")
    for m in (mesh, grid):
        with pytest.raises(ValueError, match="pp > 1"):
            Engine(ModelConfig.tiny(), mesh=m, dtype=torch.float32)
    for fn in (p2p.migrate_pages_host, p2p.tier_pages_host):
        with pytest.raises(NotImplementedError, match="queue A item 7"):
            fn(np.zeros(1), np.zeros(1), mesh)
    w = torch.zeros(4, 2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        p2p_put(w * 1, [(0, 1)], ctx=mesh)
    with pytest.raises(ValueError, match="named twice"):
        p2p_put(x[:4], [(0, 1), (2, 1)], ctx=mesh)
    with pytest.raises(ValueError, match="out of range"):
        p2p_put(x[:4], [(0, 4)], ctx=mesh)
    with pytest.raises(ValueError, match="root=4 out of range"):
        bcast.broadcast(x[:4], 4, ctx=mesh, axis="pp")
    four = x[:4]
    assert bcast.broadcast(four, 0, ctx=make_mesh(tp=4, device="cpu"),
                               axis="pp") is four
    with pytest.raises(ValueError, match="pass ctx"):
        pp_comm.gpipe_forward(lambda h: h, torch.zeros(2, 1, 3))
    with pytest.raises(ValueError, match="boundary impl"):
        pp_comm.send_next(x[:4], ctx=mesh, impl="nccl")
    # Without ctx send_next shifts the leading dimension itself.
    assert pp_comm.send_next(x[:4], impl="pallas").flatten().tolist() == [
        3, 0, 1, 2]


# ---- rows 32, 33, 2, 6 against JAX over 8 ranks ----------------------------

def test_p2p_put_matches_jax(tp8_mesh, tp8_ctx):
    """JAX's kernel (interpret mode) and ``lax.ppermute`` against the
    port's op and its plain version, exactly; ranks that receive nothing
    hold zeros; a multicast forward matches JAX's kernel."""
    x = _rand(1, 64, 24)
    mesh = make_mesh(tp=8, device="cpu")
    tx = _t(_stacked(x, 8))
    for perm in ([(i, (i + 1) % 8) for i in range(8)], [(0, 3), (1, 2)],
                 [(0, 3), (0, 2), (1, 5)]):
        want = _stacked(_jrun(tp8_mesh, lambda v, p=perm: jp2p_put(
            v, p, ctx=tp8_ctx, axis="tp"), x), 8)
        got = p2p_put(tx, perm, ctx=mesh, axis="tp")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(perm))
        if len({s for s, _ in perm}) == len(perm):
            oracle = _stacked(_jrun(tp8_mesh, lambda v, p=perm: jppermute_ref(
                v, p, axis="tp"), x), 8)
            np.testing.assert_array_equal(
                ppermute_ref(tx, perm, ctx=mesh, axis="tp").numpy(), oracle)
        idle = sorted(set(range(8)) - {d for _, d in perm})
        assert not got[idle].any()


def test_broadcast_matches_jax(tp8_mesh, tp8_ctx):
    x = _rand(60, 64, 32)
    mesh = make_mesh(tp=8, device="cpu")
    tx = _t(_stacked(x, 8))
    for root in (0, 5):
        want = _jrun(tp8_mesh, lambda v, r=root: jbroadcast(
            v, r, ctx=tp8_ctx, axis="tp"), x)
        oracle = _jrun(tp8_mesh, lambda v, r=root: jbroadcast_ref(
            v, r, axis="tp"), x)
        np.testing.assert_array_equal(want, oracle)
        got = bcast.broadcast(tx, root, ctx=mesh, axis="tp")
        np.testing.assert_array_equal(got.numpy(), _stacked(want, 8))
        np.testing.assert_array_equal(
            bcast.broadcast_host(tx, root, mesh=mesh).numpy(),
            got.numpy())


def test_all_gather_full_mesh_matches_jax(tp8_mesh, tp8_ctx):
    """JAX's full-mesh kernel (interpret mode) against the port's op,
    exactly, and the port's two modes against each other."""
    x = _rand(0, 64, 128)
    want = np.asarray(spmd(
        tp8_mesh, lambda v: jall_gather(v, ctx=tp8_ctx, mode="full_mesh"),
        P("tp", None), P(None, None))(jnp.asarray(x)))
    mesh = make_mesh(tp=8, device="cpu")
    tx = _t(_stacked(x, 8))
    got = allgather.all_gather(tx, ctx=mesh, axis="tp", mode="full_mesh")
    for r in range(8):
        np.testing.assert_array_equal(got[r].numpy(), want)
    assert torch.equal(got, allgather.all_gather(tx, ctx=mesh, axis="tp"))


def test_all_reduce_recursive_matches_jax(tp8_mesh, tp8_ctx):
    """JAX's recursive halving-doubling kernel (interpret mode) within
    1e-5 in fp32; every rank of a group with the same bits, also in bf16
    on a two-axis mesh; JAX's precondition and message (its ``(32, 64)``
    case: 4 rows a rank, not a multiple of 8)."""
    x = _rand(50, 64, 64)
    want = _jrun(tp8_mesh, lambda v: jall_reduce(
        v, ctx=tp8_ctx, method=JMethod.RECURSIVE), x)
    mesh = make_mesh(tp=8, device="cpu")
    tx = _t(_stacked(x, 8))
    got = allreduce.all_reduce(tx, ctx=mesh, method=AllReduceMethod.RECURSIVE)
    np.testing.assert_allclose(got.numpy(), _stacked(want, 8), **TOL)
    np.testing.assert_allclose(got[0].numpy(), x.reshape(8, 8, 64).sum(0),
                               rtol=1e-4, atol=1e-4)
    grid = make_mesh(dp=2, tp=4, device="cpu")
    xb = torch.from_numpy(_rand(51, 8, 12, 16)).to(torch.bfloat16)
    for axis in ("dp", "tp"):
        got = allreduce.all_reduce(xb, ctx=grid, axis=axis,
                                   method="recursive")
        for r in range(8):
            assert torch.equal(got[r], got[grid.device_id(axis, 0, r)])
    bad = _rand(51, 32, 64)
    with pytest.raises(ValueError, match="RECURSIVE"):
        _jrun(tp8_mesh, lambda v: jall_reduce(
            v, ctx=tp8_ctx, method=JMethod.RECURSIVE), bad)
    with pytest.raises(ValueError, match="RECURSIVE"):
        allreduce.all_reduce(_t(_stacked(bad, 8)), ctx=mesh,
                             method=AllReduceMethod.RECURSIVE)
    with pytest.raises(ValueError, match="RECURSIVE"):
        allreduce.all_reduce(torch.zeros(6, 6, 2),
                             ctx=make_mesh(tp=6, device="cpu"),
                             method="recursive")


# ---- layers.pp_comm over 4 stages -----------------------------------------

def _stage_weights(seed):
    return _rand(seed, S, D, D) * D ** -0.5


def _tanh_stage(w):
    """The port's stacked stage: rank r's carry through ``tanh(h @ w[r])``."""
    return lambda h: torch.tanh(torch.bmm(h, w))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_gpipe_forward_matches_jax(impl):
    """JAX's schedule (its boundary in interpret mode for ``"pallas"``)
    against the port's in both collects; the port's ``remat`` form equal."""
    w, x_mb = _stage_weights(0), _rand(1, M, MB, D)
    jm, jctx = _jmesh(S, "pp")

    def run(w_loc, xs, collect):
        return jpp.gpipe_forward(lambda h: jnp.tanh(h @ w_loc[0]), xs,
                                 axis="pp", ctx=jctx, impl=impl,
                                 collect=collect)

    mesh = make_mesh(pp=S, device="cpu")
    for collect in ("broadcast", "last"):
        out_spec = (P(None, None, None) if collect == "broadcast"
                    else P("pp", None, None))
        want = np.asarray(spmd(jm, lambda a, b: run(a, b, collect),
                               (P("pp", None, None), P(None, None, None)),
                               out_spec)(jnp.asarray(w), jnp.asarray(x_mb)))
        for remat in (False, True):
            got = pp_comm.gpipe_forward(_tanh_stage(_t(w)), _t(x_mb),
                                        ctx=mesh, impl=impl, collect=collect,
                                        remat=remat)
            assert got.shape == (S, M, MB, D)
            if collect == "broadcast":
                for r in range(S):
                    np.testing.assert_allclose(got[r].numpy(), want, **TOL)
            else:
                np.testing.assert_allclose(
                    got.numpy(), want.reshape(S, M, MB, D), **TOL)


def test_gpipe_grad_with_remat_matches_jax():
    """``jax.grad`` through JAX's ``impl="xla"`` schedule with ``remat``
    (its per-rank loss carries 1/n, as in ``tests/test_pp.py``) against
    the port's autograd through the same schedule."""
    w, x_mb = _stage_weights(2), _rand(3, M, MB, D)
    jm, jctx = _jmesh(S, "pp")

    def loss(w_all, xs):
        out = jpp.gpipe_forward(lambda h: jnp.tanh(h @ w_all[0]), xs,
                                axis="pp", remat=True, impl="xla")
        return jnp.sum(out ** 2) / jax.lax.axis_size("pp")

    want = np.asarray(spmd(jm, lambda a, b: jax.grad(loss)(a, b),
                           (P("pp", None, None), P(None, None, None)),
                           P("pp", None, None))(jnp.asarray(w),
                                                jnp.asarray(x_mb)))
    tw = _t(w).requires_grad_()
    out = pp_comm.gpipe_forward(_tanh_stage(tw), _t(x_mb),
                                ctx=make_mesh(pp=S, device="cpu"),
                                impl="xla", remat=True)
    (out[0] ** 2).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), want, rtol=1e-4, atol=1e-4)


def test_pipeline_forward_matches_jax_relay():
    """The relay in both boundary impls against JAX's, and the schedule
    on the same stage (JAX's ``test_gpipe_vs_relay``)."""
    w, x = _stage_weights(4), _rand(5, 6, D)
    jm, _ = _jmesh(S, "pp")

    def relay(w_all, v):
        return jpp.pipeline_forward(lambda s, h: jnp.tanh(h @ w_all[s]), v,
                                    num_stages=S, axis="pp")

    want = np.asarray(spmd(jm, relay, (P(None, None, None), P(None, None)),
                           P(None, None))(jnp.asarray(w), jnp.asarray(x)))
    mesh = make_mesh(pp=S, device="cpu")
    tw = _t(w)
    for impl in ("xla", "pallas"):
        got = pp_comm.pipeline_forward(
            lambda s, h: torch.tanh(h @ tw[s]), _t(x), num_stages=S,
            ctx=mesh, impl=impl)
        for r in range(S):
            np.testing.assert_allclose(got[r].numpy(), want, **TOL)
    g = pp_comm.gpipe_forward(_tanh_stage(tw), _t(x)[None], ctx=mesh)
    np.testing.assert_allclose(g[0, 0].numpy(), want, **TOL)
    ones = pp_comm.pipeline_forward(lambda s, h: h + 1.0, _t(x),
                                    num_stages=S, ctx=mesh)
    np.testing.assert_allclose(ones[2].numpy(), x + S, **TOL)


# ---- the slice as a whole --------------------------------------------------

def smoke_module():
    """``chip_smoke.py``, loaded by path: its ``pp_stages`` is the stage
    closure that the card's pipeline phase runs, held here to JAX."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tiny_model_through_gpipe_matches_jax():
    """A 4-layer tiny model at ``pp=4`` (one layer a stage), M = 4
    microbatches of one 12-token sequence: the embedding before the
    pipeline, the final norm and ``lm_head`` after it, against JAX's
    dense ``forward_tokens`` of the four sequences on the same weights,
    in both boundary impls."""
    kw = dict(num_hidden_layers=4, num_key_value_heads=4)
    jcfg, cfg = JaxConfig.tiny(**kw), ModelConfig.tiny(**kw)
    jparams = jdense.init_params(jax.random.PRNGKey(7), jcfg, jnp.float32)
    ids = np.random.RandomState(8).randint(0, cfg.vocab_size, (M, 12)
                                           ).astype(np.int32)
    jm, _ = _jmesh(1, "tp")
    want = np.asarray(spmd(
        jm, lambda p, t: jdense.forward_tokens(p, t, jcfg),
        (P(), P()), P())(jparams, jnp.asarray(ids)))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu",
                             torch.float32)
    mesh = make_mesh(pp=4, device="cpu")
    x_mb = params.embed[torch.from_numpy(ids).long()][:, None]  # (M, 1, S, d)
    stages = smoke_module().pp_stages(params, cfg, 4)
    for impl in ("xla", "pallas"):
        with torch.no_grad():
            h = pp_comm.gpipe_forward(stages, x_mb,
                                      ctx=mesh, impl=impl)[0, :, 0]
            x = rms_norm(h, params.ln_f, cfg.rms_norm_eps)
            logits = dense.lm_head_logits(x, params.lm_head)
        np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      want.argmax(-1))
