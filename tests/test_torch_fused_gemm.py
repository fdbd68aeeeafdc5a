"""The port's fused tensor-parallel GEMMs against the JAX package's, on the
CPU: ``ag_gemm`` (with and without ``return_ag``), ``gemm_rs`` and
``gemm_ar`` in both variants, each JAX op run over a 4-device mesh in
interpret mode as ``tests/test_fused_gemm.py`` runs it, and the port's
op over 4 simulated ranks on CPU tensors (its plain version), on the same
seeded numpy inputs at tiny shapes.

Layouts: JAX shards a global array over the mesh; the port stacks the
ranks' shards along a leading dimension and keeps weights ``(out, in)``
(column-parallel shards are row blocks of the weight, row-parallel ones
column slices, both views). fp32 results agree within 1e-5 relative (sums
in other orders); the bf16 case within 1e-2 + 2**-7 |want| (one bf16 unit
of last place: both round an fp32 sum once). The block-size errors are
the JAX ones, message for message; unported variants and swizzle modes
raise, naming ROADMAP.md queue B, and so do the tuple axes the
hierarchical forms cannot take."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.ops import (ag_gemm as jag_gemm,
                                 create_ag_gemm_context as jag_ctx,
                                 create_gemm_ar_context as jar_ctx,
                                 create_gemm_rs_context as jrs_ctx,
                                 gemm_ar as jgemm_ar, gemm_rs as jgemm_rs)
from triton_dist_tpu.parallel.mesh import MeshContext as JaxMeshContext
from triton_dist_tpu.parallel.mesh import make_mesh as jax_make_mesh
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch.ops import ag_gemm, gemm_ar, gemm_rs
from triton_dist_tpu_torch.ops.tp_gemm import column_shards, row_shards
from triton_dist_tpu_torch.parallel.mesh import make_mesh

N = 4
FP32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jmesh():
    mesh = jax_make_mesh(tp=N, devices=jax.devices()[:N])
    return mesh, JaxMeshContext.from_mesh(mesh)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(tp=N, device="cpu")


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("return_ag", [False, True])
def test_ag_gemm_matches_jax(jmesh, mesh, return_ag):
    jm, jctx = jmesh
    m, k, n_dim = 64, 32, 64                      # global A (m, k), B (k, n)
    a, b = _rand((m, k), 0), _rand((k, n_dim), 1)
    ctx = jag_ctx(jctx, block_m=16, block_n=8)
    out_spec = (P(None, "tp"), P(None, None)) if return_ag else P(None, "tp")
    f = spmd(jm, lambda x, w: jag_gemm(x, w, ctx, return_ag=return_ag),
             (P("tp", None), P(None, "tp")), out_spec)
    want = f(jnp.asarray(a), jnp.asarray(b))
    got = ag_gemm.ag_gemm(
        _t(a).view(N, m // N, k), column_shards(_t(b.T), N),
        ag_gemm.create_ag_gemm_context(mesh, block_m=16, block_n=8),
        return_ag=return_ag)
    if return_ag:
        want, want_ag = want
        got, got_ag = got
        for r in range(N):
            np.testing.assert_array_equal(got_ag[r].numpy(),
                                          np.asarray(want_ag))
    # Rank r's columns of the global output are its (m, N_loc) result.
    full = got.permute(1, 0, 2).reshape(m, n_dim).numpy()
    np.testing.assert_allclose(full, np.asarray(want), **FP32_TOL)


def _rs_inputs(m, k, n_dim, seed):
    a, b = _rand((m, k), seed), _rand((k, n_dim), seed + 1)
    # Rank r holds columns [r·k/N, ...) of A and rows of B (K-sharded).
    ta = _t(a).view(m, N, k // N).permute(1, 0, 2).contiguous()
    return a, b, ta


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_rs_matches_jax(jmesh, mesh, dtype):
    jm, jctx = jmesh
    m, k, n_dim = 64, 128, 32
    a, b, ta = _rs_inputs(m, k, n_dim, 2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ctx = jrs_ctx(jctx, block_m=16, block_n=32)
    f = spmd(jm, lambda x, w: jgemm_rs(x, w, ctx),
             (P(None, "tp"), P("tp", None)), P("tp", None))
    want = np.asarray(f(jnp.asarray(a, jdt), jnp.asarray(b, jdt)),
                      np.float32)
    got = gemm_rs.gemm_rs(
        ta.to(tdt), row_shards(_t(b.T, tdt), N),
        gemm_rs.create_gemm_rs_context(mesh, block_m=16, block_n=32))
    assert got.shape == (N, m // N, n_dim) and got.dtype == tdt
    got = got.reshape(m, n_dim).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
    else:
        assert np.all(np.abs(got - want) <= 1e-2 + 2.0 ** -7 * np.abs(want))


@pytest.mark.parametrize("variant", ["ll", "one_shot"])
def test_gemm_ar_matches_jax(jmesh, mesh, variant):
    jm, jctx = jmesh
    m, k, n_dim = 8, 128, 64
    a, b, ta = _rs_inputs(m, k, n_dim, 4)
    ctx = jar_ctx(jctx, block_n=32, variant=variant)
    f = spmd(jm, lambda x, w: jgemm_ar(x, w, ctx),
             (P(None, "tp"), P("tp", None)), P(None, None))
    want = np.asarray(f(jnp.asarray(a), jnp.asarray(b)))
    got = gemm_ar.gemm_ar(ta, row_shards(_t(b.T), N),
                          gemm_ar.create_gemm_ar_context(
                              mesh, block_n=32, variant=variant))
    assert got.shape == (N, m, n_dim)
    for r in range(N):
        np.testing.assert_allclose(got[r].numpy(), want, **FP32_TOL)


def _same_value_error(jax_call, port_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["ag", "rs", "ar"])
def test_block_errors_equal_jax(jmesh, mesh, kind):
    """Blocks that do not divide: the JAX op raises at trace time, the
    port's op at the call, with the same message."""
    jm, jctx = jmesh
    if kind == "ag":
        jop, jc = jag_gemm, jag_ctx(jctx, block_m=16, block_n=6)
        op, c = ag_gemm.ag_gemm, ag_gemm.create_ag_gemm_context(
            mesh, block_m=16, block_n=6)
        specs, out, (m, k, n_dim) = ((P("tp", None), P(None, "tp")),
                                     P(None, "tp"), (64, 32, 64))
    elif kind == "rs":
        jop, jc = jgemm_rs, jrs_ctx(jctx, block_m=16, block_k=6)
        op, c = gemm_rs.gemm_rs, gemm_rs.create_gemm_rs_context(
            mesh, block_m=16, block_k=6)
        specs, out, (m, k, n_dim) = ((P(None, "tp"), P("tp", None)),
                                     P("tp", None), (64, 32, 64))
    else:
        jop, jc = jgemm_ar, jar_ctx(jctx, block_n=24)
        op, c = gemm_ar.gemm_ar, gemm_ar.create_gemm_ar_context(
            mesh, block_n=24)
        specs, out, (m, k, n_dim) = ((P(None, "tp"), P("tp", None)),
                                     P(None, None), (8, 32, 64))
    a, b = np.zeros((m, k), np.float32), np.zeros((k, n_dim), np.float32)
    f = spmd(jm, lambda x, w: jop(x, w, jc), specs, out)
    if kind == "ag":
        ta, tb = _t(a).view(N, m // N, k), column_shards(_t(b.T), N)
    else:
        ta = _t(a).view(m, N, k // N).permute(1, 0, 2).contiguous()
        tb = row_shards(_t(b.T), N)
    _same_value_error(lambda: f(jnp.asarray(a), jnp.asarray(b)),
                      lambda: op(ta, tb, c))


@pytest.mark.parametrize("jax_make,port_make,kw", [
    (jag_ctx, ag_gemm.create_ag_gemm_context, dict(variant="bogus")),
    (jag_ctx, ag_gemm.create_ag_gemm_context, dict(swizzle_mode="bogus")),
    (jrs_ctx, gemm_rs.create_gemm_rs_context, dict(swizzle_mode="ag")),
    (jar_ctx, gemm_ar.create_gemm_ar_context, dict(variant="bogus"))],
    ids=["ag-variant", "ag-swizzle", "rs-swizzle", "ar-variant"])
def test_unknown_variants_raise_as_jax(jmesh, mesh, jax_make, port_make, kw):
    _same_value_error(lambda: jax_make(jmesh[1], **kw),
                      lambda: port_make(mesh, **kw))


def _on_2x2(make):
    """``make`` over a 2 x 2 (dp x tp) mesh, whatever mesh it is given."""
    return lambda mesh, **kw: make(make_mesh(dp=2, tp=2, device="cpu"), **kw)


def _gemm_rs_2d(mesh, m):
    ctx = gemm_rs.create_gemm_rs_context(mesh, ("dp", "tp"), block_m=2,
                                         block_n=16)
    return gemm_rs.gemm_rs(torch.zeros(N, m, 8), torch.zeros(N, 16, 8), ctx)


@pytest.mark.parametrize("make,kw,match", [
    (ag_gemm.create_ag_gemm_context, dict(variant="pipelined"),
     "ROADMAP.md queue B"),
    (ag_gemm.create_ag_gemm_context, dict(swizzle_mode="identity"),
     "ROADMAP.md queue B"),
    (_on_2x2(ag_gemm.create_ag_gemm_context), dict(axis=("tp", "dp")),
     "the outer one first"),
    (gemm_rs.create_gemm_rs_context, dict(swizzle_mode="identity"),
     "ROADMAP.md queue B"),
    (_on_2x2(_gemm_rs_2d), dict(m=6), "M=6 not divisible by axis size 4"),
    (_on_2x2(gemm_ar.create_gemm_ar_context), dict(axis=("tp", "tp")),
     "two different mesh axes")],
    ids=["ag-pipelined", "ag-identity", "ag-2d", "rs-identity", "rs-2d",
         "ar-2d"])
def test_unported_forms_raise(mesh, make, kw, match):
    """Unported variants and swizzle modes raise, naming queue B. The
    hierarchical forms themselves are ported (``tests/test_torch_tp2d.py``);
    what a tuple axis alone rules out raises too: an (outer, inner) pair
    out of the mesh's order (the ranks are stacked outer-major over it) or
    naming one axis twice, and an M that divides by each axis size (2) but
    not by their product (4)."""
    with pytest.raises(ValueError, match=match):
        make(mesh, **kw)


@pytest.mark.parametrize("op", ["ag", "rs", "ar"])
def test_ops_take_the_plain_version_only_on_cpu(mesh, op):
    """Any device but the CPU launches the kernel or raises."""
    a = torch.zeros(N, 16, 32, device="meta")
    b = torch.zeros(N, 16, 32, device="meta")
    call = {"ag": lambda: ag_gemm.ag_gemm(a, b, ag_gemm.create_ag_gemm_context(
                mesh, block_m=16, block_n=16)),
            "rs": lambda: gemm_rs.gemm_rs(a, b, gemm_rs.create_gemm_rs_context(
                mesh, block_m=4, block_n=16)),
            "ar": lambda: gemm_ar.gemm_ar(a, b, gemm_ar.create_gemm_ar_context(
                mesh, block_n=16))}[op]
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        call()
