"""The port's two-axis simulated mesh and its collectives against the JAX
package's, on the CPU.

(a) Layout and schedules, exactly: ``make_mesh(dp=2, tp=2)``'s rank r =
o·n_in + i is the shard ``shard_map`` places on device (o, i) for
``P(("dp", "tp"))`` and JAX's ``flat_axis_rank`` there; the two 2D
schedules of ``lang/overlap.py`` equal the index maps JAX's hierarchical
AG+GEMM and GEMM+RS hand their Pallas grids (read off the BlockSpecs, the
kernels never launched) at (n_o, n_in) in {(2, 2), (2, 4), (4, 2)}; and
``all_reduce``'s method choice equals JAX's on both sides of 1 MiB and for
a dim 0 that does not divide.

(b) Rows 1, 4, 5, ``TWO_SHOT`` and ``all_reduce_2d``: the port's plain
versions (CPU tensors, every rank stacked on the leading dimension)
against JAX's ops run as ``tests/test_collectives.py`` runs them (Pallas in
interpret mode) on a 2 x 2 CPU mesh, over each axis, in fp32 within 1e-5.

(c) The unported forms raise, naming their ROADMAP.md item (rows 2 and 6
are ported and held to JAX in ``tests/test_torch_pp.py``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.ops import (AllReduceMethod as JMethod, all_gather as
                                 jall_gather, all_reduce as jall_reduce,
                                 all_reduce_2d as jall_reduce_2d,
                                 reduce_scatter as jreduce_scatter)
from triton_dist_tpu.parallel.mesh import MeshContext as JaxMeshContext
from triton_dist_tpu.parallel.mesh import flat_axis_rank
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch import Engine, ModelConfig, make_mesh
from triton_dist_tpu_torch.lang import overlap
from triton_dist_tpu_torch.ops import (ag_gemm, allgather, allreduce,
                                       gemm_rs, reduce_scatter)

# The JAX op modules (``triton_dist_tpu.ops`` re-exports functions of
# the same names).
jag_mod = importlib.import_module("triton_dist_tpu.ops.ag_gemm")
jar_mod = importlib.import_module("triton_dist_tpu.ops.allreduce")
jrs_mod = importlib.import_module("triton_dist_tpu.ops.gemm_rs")

AX = ("dp", "tp")
TOL = dict(rtol=1e-5, atol=1e-5)


def _jmesh(n_o, n_in):
    mesh = Mesh(np.array(jax.devices()[:n_o * n_in]).reshape(n_o, n_in), AX)
    return mesh, JaxMeshContext.from_mesh(mesh)


def _fake_core_call(seen):
    """Stands in for the JAX ops' ``core_call``: records the BlockSpecs
    and returns zeros of the output shapes (no kernel is traced)."""
    def core_call(kernel, **kw):
        seen.update(kw)
        shapes = kw["out_shape"]
        return lambda *args: (
            tuple(jnp.zeros(s.shape, s.dtype) for s in shapes)
            if isinstance(shapes, tuple) else jnp.zeros(shapes.shape,
                                                        shapes.dtype))
    return core_call


def test_layout_and_schedules_equal_jax(monkeypatch):
    jm, jctx = _jmesh(2, 2)
    mesh = make_mesh(dp=2, tp=2, device="cpu")
    arr = jax.device_put(np.arange(8.0), NamedSharding(jm, P(AX)))
    devs = jm.devices
    for shard in arr.addressable_shards:
        o, i = (int(v[0]) for v in np.nonzero(devs == shard.device))
        r = int(shard.data[0]) // 2
        assert (mesh.rank("dp", r), mesh.rank("tp", r)) == (o, i)
        assert mesh.rank(AX, r) == r == o * 2 + i
        assert mesh.device_id("dp", 1 - o, r) == (1 - o) * 2 + i
    flat = spmd(jm, lambda x: flat_axis_rank(AX)[1][None].astype(
        jnp.float32) + 0 * x[:1], P(AX), P(AX))(jnp.zeros(4))
    assert [mesh.rank(AX, r) for r in range(4)] == np.asarray(flat).tolist()

    for n_o, n_in in ((2, 2), (2, 4), (4, 2)):
        jm, jctx = _jmesh(n_o, n_in)
        n = n_o * n_in
        seen = {}
        monkeypatch.setattr(jag_mod, "core_call", _fake_core_call(seen))
        monkeypatch.setattr(jrs_mod, "core_call", _fake_core_call(seen))
        agc = jag_mod.create_ag_gemm_context(jctx, axis=AX, block_m=16,
                                             block_n=8)
        rsc = jrs_mod.create_gemm_rs_context(jctx, axis=AX, block_m=16,
                                             block_n=8, block_k=8)

        def maps(a, b, a2, b2):
            jag_mod.ag_gemm(a, b, agc)
            ag_map = seen["out_specs"][0].index_map
            jrs_mod.gemm_rs(a2, b2, rsc)
            rs_map = seen["in_specs"][0].index_map
            return jnp.stack([jnp.stack([ag_map(q, 0, 0, 0)[0],
                                         rs_map(q, 0, 0, 0)[0]])
                              for q in range(n)])[None]

        got = np.asarray(spmd(
            jm, maps, (P(AX, None), P(None, AX), P(None, AX), P(AX, None)),
            P(AX))(jnp.zeros((16 * n, 8)), jnp.zeros((8, 8 * n)),
                              jnp.zeros((16 * n, 8 * n)),
                              jnp.zeros((8 * n, 8))))
        for r in range(n):
            o, i = divmod(r, n_in)
            want = [[overlap.ag_2d_step(q, o, i, n_o, n_in)[2],
                     overlap.rs_2d_step(q, o, i, n_o, n_in)[1]]
                    for q in range(n)]
            assert got[r].tolist() == want, (n_o, n_in, r)
            assert sorted(w[0] for w in want) == list(range(n))

    picked = []
    monkeypatch.setattr(jar_mod, "reduce_scatter",
                        lambda x, **kw: picked.append("two_shot") or x)
    monkeypatch.setattr(jar_mod, "all_gather", lambda x, **kw: x)
    monkeypatch.setattr(jar_mod, "core_call",
                        lambda k, **kw: lambda x: picked.append("one_shot")
                        or (x, x))
    jctx = _jmesh(2, 2)[1]
    for shape, dtype in (((4, 4096), jnp.bfloat16), ((512, 512), jnp.float32),
                         ((1024, 512), jnp.float32), ((1025, 512), jnp.float32),
                         ((2048, 4096), jnp.bfloat16)):
        jar_mod.all_reduce(jnp.zeros(shape, dtype), ctx=jctx, axis="dp")
        x = torch.empty((4, *shape), dtype=torch.bfloat16 if dtype ==
                        jnp.bfloat16 else torch.float32)
        assert allreduce.choose_method(x, 2).value == picked[-1], shape


@pytest.fixture(scope="module")
def meshes():
    jm, jctx = _jmesh(2, 2)
    return jm, jctx, make_mesh(dp=2, tp=2, device="cpu")


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_collectives_match_jax(meshes):
    """Each JAX op on the 2 x 2 mesh, every device's shard the rows of
    its flat rank (``P(("dp", "tp"))``), against the port's op on the
    same rows stacked by rank."""
    jm, jctx, mesh = meshes
    x = _x((4 * 8, 16), 3)                       # 8 rows a rank
    tx = torch.from_numpy(x).view(4, 8, 16)
    cases = []
    for axis in ("dp", "tp"):
        cases += [
            (lambda v, a=axis: jall_gather(v, ctx=jctx, axis=a),
             allgather.all_gather(tx, ctx=mesh, axis=axis)),
            (lambda v, a=axis: jreduce_scatter(v, ctx=jctx, axis=a),
             reduce_scatter.reduce_scatter(tx, ctx=mesh, axis=axis)),
            (lambda v, a=axis: jall_reduce(v, ctx=jctx, axis=a,
                                           method=JMethod.ONE_SHOT),
             allreduce.all_reduce(tx, ctx=mesh, axis=axis,
                                  method="one_shot")),
            (lambda v, a=axis: jall_reduce(v, ctx=jctx, axis=a,
                                           method=JMethod.TWO_SHOT),
             allreduce.all_reduce(tx, ctx=mesh, axis=axis,
                                  method=allreduce.AllReduceMethod.TWO_SHOT))]
    cases.append((lambda v: jall_reduce_2d(v, ctx=jctx),
                  allreduce.all_reduce_2d(tx, ctx=mesh)))
    for k, (jfn, got) in enumerate(cases):
        want = np.asarray(spmd(jm, jfn, P(AX, None), P(AX, None))(
            jnp.asarray(x)))
        np.testing.assert_allclose(got.reshape(want.shape).numpy(), want,
                                   err_msg=f"case {k}", **TOL)
    # Every rank of a group holds the group's sum.
    got = allreduce.all_reduce_ref(tx, ctx=mesh, axis="dp")
    assert torch.equal(got[0], got[2]) and torch.equal(got[1], got[3])
    # At one rank along the axis the input comes back, as in JAX.
    flat = make_mesh(tp=4, device="cpu")
    assert allgather.all_gather(tx, ctx=flat, axis="dp") is tx
    assert allreduce.all_reduce(tx, ctx=flat, axis="dp") is tx


def test_unported_forms_raise(meshes):
    """Rows 3, 8 and 11 name queue B; a MoE model over a tuple axis
    with tensor-parallel experts names queue A item 5 (its expert-parallel
    form is ported: ``tests/test_torch_ep_engine.py``); an engine over the
    tp axis alone of a dp x tp mesh (data-parallel replicas) names queue A
    item 4."""
    mesh = meshes[2]
    x = torch.zeros(4, 8, 16)
    for call in (
            lambda: allgather.all_gather_2d(x, ctx=mesh),
            lambda: ag_gemm.create_ag_gemm_context(mesh, AX,
                                                   variant="pipelined"),
            lambda: gemm_rs.create_gemm_rs_context(mesh, AX,
                                                   swizzle_mode="identity")):
        with pytest.raises(ValueError, match="ROADMAP.md queue B"):
            call()
    with pytest.raises(ValueError, match="queue A item 5"):
        Engine(ModelConfig.tiny_moe(num_experts=4), mesh=mesh, axis=AX,
               dtype=torch.float32)
    for axis in ("tp", "dp"):
        with pytest.raises(ValueError, match="data-parallel replicas"):
            Engine(ModelConfig.tiny(num_key_value_heads=4), mesh=mesh,
                   axis=axis, dtype=torch.float32)
    with pytest.raises(ValueError, match="not divisible by axis size 2"):
        reduce_scatter.reduce_scatter(torch.zeros(4, 3, 8), ctx=mesh,
                                      axis="dp")
    with pytest.raises(ValueError, match="item 5"):
        make_mesh(dp=2, ep=2, device="cpu")
