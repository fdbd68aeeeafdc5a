"""The port's hierarchical (outer x inner) tensor parallelism against the
JAX package's, on the CPU in fp32, over ``make_mesh(dp=2, tp=2,
device="cpu")`` and a 2 x 2 JAX CPU mesh with axes ("dp", "tp").

(c) The fused ops on the tuple axis: ``ag_gemm`` (with ``return_ag``),
``gemm_rs`` and ``gemm_ar`` (both variants) against JAX's 2D ops run in
interpret mode as ``tests/test_fused_gemm.py`` runs them, at its small
tile shapes, within 1e-5.

(d) The engine: ``Engine(ModelConfig.tiny(num_key_value_heads=4),
mesh=make_mesh(dp=2, tp=2), axis=("dp", "tp"), mode=m)`` for m in
``"xla"``, ``"fused"`` and ``"fused_ar"`` against JAX's 2D ``"xla"``
engine on the same weights (JAX's fused 2D engine runs its kernels in
interpret mode and takes 31-79 s on a CPU, so it is not run): prefill logits
within 1e-4, the KV cache (the global view) within 1e-4, greedy tokens
equal; and every mode against the port's flat tp = 4 engine."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.ops import (ag_gemm as jag_gemm,
                                 create_ag_gemm_context as jag_ctx,
                                 create_gemm_ar_context as jar_ctx,
                                 create_gemm_rs_context as jrs_ctx,
                                 gemm_ar as jgemm_ar, gemm_rs as jgemm_rs)
from triton_dist_tpu.parallel.mesh import MeshContext as JaxMeshContext
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch import Engine, ModelConfig, make_mesh
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.ops import ag_gemm, gemm_ar, gemm_rs
from triton_dist_tpu_torch.ops.tp_gemm import column_shards, row_shards

AX = ("dp", "tp")
N = 4
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
ATOL = 1e-4
KW = dict(num_key_value_heads=4)
MAX_LEN = 24
GEN = 4


def _jmesh():
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(2, 2), AX)
    return mesh, JaxMeshContext.from_mesh(mesh)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_fused_2d_ops_match_jax():
    jm, jctx = _jmesh()
    mesh = make_mesh(dp=2, tp=2, device="cpu")
    # AG+GEMM: global A (64, 32) by rows, B (32, 32) by columns.
    a, b = _rand((64, 32), 7), _rand((32, 32), 8)
    f = spmd(jm, lambda x, w: jag_gemm(
        x, w, jag_ctx(jctx, axis=AX, block_m=16, block_n=8),
        return_ag=True), (P(AX, None), P(None, AX)),
        (P(None, AX), P(AX, None)))
    want, want_ag = (np.asarray(v) for v in f(jnp.asarray(a),
                                              jnp.asarray(b)))
    got, got_ag = ag_gemm.ag_gemm(
        _t(a).view(N, 16, 32), column_shards(_t(b.T), N),
        ag_gemm.create_ag_gemm_context(mesh, AX, block_m=16, block_n=8),
        return_ag=True)
    for r in range(N):
        np.testing.assert_allclose(got[r].numpy(),
                                   want[:, r * 8:(r + 1) * 8], **FP32_TOL)
        np.testing.assert_array_equal(got_ag[r].numpy(),
                                      want_ag[r * 64:(r + 1) * 64])
    # GEMM+RS: global A (64, 32) by columns, B (32, 16) by rows.
    a, b = _rand((64, 32), 13), _rand((32, 16), 14)
    f = spmd(jm, lambda x, w: jgemm_rs(
        x, w, jrs_ctx(jctx, axis=AX, block_m=16, block_n=16, block_k=8)),
        (P(None, AX), P(AX, None)), P(AX, None))
    want = np.asarray(f(jnp.asarray(a), jnp.asarray(b)))
    got = gemm_rs.gemm_rs(
        _t(a).view(64, N, 8).permute(1, 0, 2).contiguous(),
        row_shards(_t(b.T), N),
        gemm_rs.create_gemm_rs_context(mesh, AX, block_m=16, block_n=16,
                                       block_k=8))
    np.testing.assert_allclose(got.reshape(64, 16).numpy(), want,
                               **FP32_TOL)
    # GEMM+AR: global A (4, 32) by columns, B (32, 16) by rows, both
    # variants of the inner hop.
    a = _rand((4, 32), 15)
    for variant in ("ll", "one_shot"):
        f = spmd(jm, lambda x, w: jgemm_ar(
            x, w, jar_ctx(jctx, axis=AX, block_n=16, block_k=8,
                          variant=variant)),
            (P(None, AX), P(AX, None)), P(None, None))
        want = np.asarray(f(jnp.asarray(a), jnp.asarray(b)))
        got = gemm_ar.gemm_ar(
            _t(a).view(4, N, 8).permute(1, 0, 2).contiguous(),
            row_shards(_t(b.T), N),
            gemm_ar.create_gemm_ar_context(mesh, AX, block_n=16, block_k=8,
                                           variant=variant))
        for r in range(N):
            np.testing.assert_allclose(got[r].numpy(), want, **FP32_TOL)


def test_engine_2d_matches_jax():
    jm, _ = _jmesh()
    jeng = JaxEngine(JaxConfig.tiny(**KW), jm, axis=AX, mode="xla",
                     dtype=jnp.float32, max_len=MAX_LEN, seed=5)
    ids = np.random.RandomState(0).randint(0, 256, (2, 12)).astype(np.int32)
    want_logits, want_cache = jeng.prefill(ids)
    want_k, want_v = np.asarray(want_cache.k), np.asarray(want_cache.v)
    want_toks = np.asarray(jeng.serve(ids, gen_len=GEN))
    cfg = ModelConfig.tiny(**KW)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                             "cpu", torch.float32)
    flat = Engine(cfg, mesh=make_mesh(tp=N, device="cpu"), mode="xla",
                  dtype=torch.float32, max_len=MAX_LEN, params=params)
    flat_logits, flat_cache = flat.prefill(ids)
    flat_step, _ = flat.decode(torch.argmax(flat_logits, -1), flat_cache)
    mesh = make_mesh(dp=2, tp=2, device="cpu")
    for mode in ("xla", "fused", "fused_ar"):
        eng = Engine(cfg, mesh=mesh, axis=AX, mode=mode, dtype=torch.float32,
                     max_len=MAX_LEN, params=params)
        assert eng.tp == N
        logits, cache = eng.prefill(ids)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                                   atol=ATOL, rtol=0, err_msg=mode)
        np.testing.assert_allclose(cache.k[:, :, :12].numpy(),
                                   want_k[:, :, :12], atol=ATOL, rtol=0)
        np.testing.assert_allclose(cache.v[:, :, :12].numpy(),
                                   want_v[:, :, :12], atol=ATOL, rtol=0)
        torch.testing.assert_close(logits, flat_logits, atol=1e-5, rtol=0)
        step, cache = eng.decode(torch.argmax(logits, -1), cache)
        torch.testing.assert_close(step, flat_step, atol=1e-5, rtol=0)
        torch.testing.assert_close(cache.k[:, :, :13],
                                   flat_cache.k[:, :, :13], atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(
            eng.serve(ids, gen_len=GEN).numpy(), want_toks, err_msg=mode)
