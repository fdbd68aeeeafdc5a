"""The port's expert-major grouped GEMM path against the JAX package's, on
the CPU: the sorted layout (``ops/ag_moe.py``), the row-tile grouped GEMM
(``ops/group_gemm.py``, JAX's Pallas ``_gg_tiles_kernel`` in interpret
mode against the port's plain version), the plain ``grouped_gemm``, and
the fused tensor-parallel MoE forward at one rank (``layers/tp_moe.py``
``fwd``/``fwd_fused``) with both epilogues.

Index logic must match exactly: ``padded_rows``, ``suggested_block_m``
and every output of ``prepare_grouped_tokens`` (row tiles of 8 to 64,
including tail tiles made only of padding). Products are fp32 on both
sides and differ only in the order of float sums: within atol 2e-5 and
rtol 1e-5 (values of order 1). The (gate, up) weight pair must equal one
product against JAX's concatenated ``w_gu``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.layers import ep_moe as jep_moe, tp_moe as jtp_moe
from triton_dist_tpu.models.config import ModelConfig as JaxConfig
from triton_dist_tpu.ops import ag_moe as jag_moe, group_gemm as jgg
from triton_dist_tpu.parallel.mesh import MeshContext
from triton_dist_tpu.utils.testing import spmd

from triton_dist_tpu_torch.layers import tp_moe
from triton_dist_tpu_torch.models import ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.ops import ag_moe, group_gemm

TOL = dict(atol=2e-5, rtol=1e-5)

# (tokens, topk, experts, block_m): tm = 8 from a short prompt's cap,
# experts that own no row, and tails of whole padding tiles.
LAYOUTS = [(6, 2, 5, 8), (60, 8, 16, 64), (3, 1, 9, 16), (20, 4, 4, 32)]


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


def _ids(rng, t, k, e):
    return np.stack([rng.choice(e, size=k, replace=False)
                     for _ in range(t)]).astype(np.int32)


@pytest.mark.parametrize("t,k,e,bm", LAYOUTS)
def test_layout_matches_jax_exactly(t, k, e, bm):
    rng = np.random.RandomState(t + e)
    x = rng.randn(t, 8).astype(np.float32)
    ids = _ids(rng, t, k, e)
    tm = ag_moe.suggested_block_m(t, k, e, bm)
    assert tm == jag_moe.suggested_block_m(t, k, e, bm)
    assert ag_moe.padded_rows(t, k, e, tm) == jag_moe.padded_rows(t, k, e,
                                                                  tm)
    got = ag_moe.prepare_grouped_tokens(torch.from_numpy(x),
                                        torch.from_numpy(ids), e, tm)
    want = jag_moe.prepare_grouped_tokens(jnp.asarray(x), jnp.asarray(ids),
                                          e, tm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    row_src = got[2].numpy()
    last_used = np.nonzero(row_src >= 0)[0].max()
    assert (row_src[last_used + 1:] == -1).all()
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32


def test_layout_cases_cover_tm8_and_padding_tails():
    tms = {ag_moe.suggested_block_m(t, k, e, bm) for t, k, e, bm in LAYOUTS}
    assert 8 in tms
    tails = 0
    for t, k, e, bm in LAYOUTS:
        tm = ag_moe.suggested_block_m(t, k, e, bm)
        rng = np.random.RandomState(t + e)
        _, _, row_src = ag_moe.prepare_grouped_tokens(
            torch.zeros(t, 8), torch.from_numpy(_ids(rng, t, k, e)), e, tm)
        tiles = row_src.view(-1, tm)
        tails += int((tiles < 0).all(dim=1).sum())
    assert tails >= 2


@pytest.mark.parametrize("t,k,e,bm", LAYOUTS[:3])
def test_grouped_gemm_tiles_matches_jax_kernel(t, k, e, bm):
    """The port's plain version against JAX's Pallas kernel (interpret
    mode) on the same layout; the port's (gate, up) pair against JAX's
    one concatenated weight."""
    rng = np.random.RandomState(7 * t + e)
    d, f = 32, 16
    tm = ag_moe.suggested_block_m(t, k, e, bm)
    x = rng.randn(t, d).astype(np.float32)
    ids = _ids(rng, t, k, e)
    xs, te, _ = jag_moe.prepare_grouped_tokens(jnp.asarray(x),
                                               jnp.asarray(ids), e, tm)
    wg = (rng.randn(e, d, f) * d ** -0.5).astype(np.float32)
    wu = (rng.randn(e, d, f) * d ** -0.5).astype(np.float32)
    want = np.asarray(jgg.grouped_gemm_tiles(
        xs, jnp.concatenate([jnp.asarray(wg), jnp.asarray(wu)], axis=-1), te))
    # The port stores (E, out, in).
    tg = torch.from_numpy(np.ascontiguousarray(wg.transpose(0, 2, 1)))
    tu = torch.from_numpy(np.ascontiguousarray(wu.transpose(0, 2, 1)))
    txs = torch.from_numpy(np.array(xs))
    tte = torch.from_numpy(np.array(te))
    got = group_gemm.grouped_gemm_tiles(txs, (tg, tu), tte)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    one = group_gemm.grouped_gemm_tiles(txs, tg, tte)
    np.testing.assert_allclose(one.numpy(), want[:, :f], **TOL)
    np.testing.assert_allclose(
        ag_moe.ag_group_gemm(txs, (tg, tu), tte, block_m=tm).numpy(), want,
        **TOL)
    np.testing.assert_array_equal(
        ag_moe.ag_moe_ref(txs, (tg, tu), tte).numpy(), got.numpy())


def test_grouped_gemm_matches_jax_ragged_dot():
    rng = np.random.RandomState(3)
    sizes = np.array([3, 0, 5, 2], np.int32)
    x = rng.randn(12, 16).astype(np.float32)          # 2 rows past groups
    w = rng.randn(4, 16, 8).astype(np.float32)
    want = np.asarray(jgg.grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(sizes)))
    got = group_gemm.grouped_gemm(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(
            w.transpose(0, 2, 1))), torch.from_numpy(sizes))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
          num_attention_heads=4, num_key_value_heads=2, head_dim=8,
          num_experts=8, num_experts_per_tok=2, moe_intermediate_size=16)


@pytest.mark.parametrize("t,block_m,epilogue", [(5, 64, "rs"),
                                                (16, 4, "ar"),
                                                (24, 256, "rs")])
def test_fwd_fused_matches_jax(mesh, t, block_m, epilogue):
    """``fwd_fused`` at one rank (route, layout, gate/up and down grouped
    GEMMs, un-sort, combine) and the unfused ``fwd`` against JAX's on the
    same weights and tokens."""
    jcfg, cfg = JaxConfig.tiny_moe(**KW), ModelConfig.tiny_moe(**KW)
    jp = jep_moe.init(jax.random.PRNGKey(t), jcfg)
    x = np.random.RandomState(t).randn(t, 32).astype(np.float32)
    mctx = MeshContext.from_mesh(mesh)
    specs = jax.tree.map(lambda _: P(), jp)
    kw = dict(topk=2, num_experts=8)
    want = spmd(mesh, lambda p, v: jtp_moe.fwd_fused(
        p, v, mesh_ctx=mctx, block_m=block_m, epilogue=epilogue, **kw),
        (specs, P()), P())(jp, jnp.asarray(x))
    want_fwd = spmd(mesh, lambda p, v: jtp_moe.fwd(p, v, **kw),
                    (specs, P()), P())(jp, jnp.asarray(x))
    layer = {"attn": None, "moe": jax.tree.map(np.asarray, jp)}
    moe = _port_moe(layer, cfg)
    tx = torch.from_numpy(x)
    got = tp_moe.fwd_fused(moe, tx, block_m=block_m, epilogue=epilogue,
                           **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tp_moe.fwd(moe, tx, **kw).numpy(),
                               np.asarray(want_fwd), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_fwd), **TOL)
    with pytest.raises(ValueError, match="epilogue"):
        tp_moe.fwd_fused(moe, tx, epilogue="a2a", **kw)


def _port_moe(layer, cfg):
    """One JAX MoE block's weights carried to the port (through the
    converter of a one-layer model)."""
    d = cfg.hidden_size
    zeros = np.zeros
    attn = {"wq": zeros((d, 32)), "wk": zeros((d, 16)), "wv": zeros((d, 16)),
            "wo": zeros((32, d)), "q_norm": zeros(8), "k_norm": zeros(8)}
    tree = {"embed": zeros((64, d)), "lm_head": zeros((64, d)),
            "ln_f": zeros(d),
            "layers": [{"attn": attn, "moe": layer["moe"],
                        "ln_attn": zeros(d), "ln_mlp": zeros(d)}]}
    return from_jax_params(tree, cfg, "cpu", torch.float32).layers[0].moe


def test_kernel_wrapper_takes_plain_version_only_on_cpu(monkeypatch):
    calls = []
    real = group_gemm.grouped_gemm_tiles_ref
    monkeypatch.setattr(group_gemm, "grouped_gemm_tiles_ref",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.zeros(16, 8)
    w = torch.zeros(2, 4, 8)
    te = torch.zeros(2, dtype=torch.int32)
    before = group_gemm.KERNEL.launches
    assert group_gemm.grouped_gemm_tiles(x, w, te).shape == (16, 4)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        group_gemm.grouped_gemm_tiles(x.to("meta"), w.to("meta"),
                                      te.to("meta"))
    assert calls == [1] and group_gemm.KERNEL.launches == before
