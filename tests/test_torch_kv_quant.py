"""Quantized (int8/fp8) paged KV pools of the PyTorch port against the JAX
package, on the CPU.

- Pool writes: the same seeded K/V through the JAX ``PagedKVCache`` (pure)
  and the port's (in place): a chunk with bucket padding, a chunk over a
  prefix-resident page (``wfrom``), decode appends across a page edge, a
  K-token verify block with a budget, a prompt blit, and a freed page
  reused with its stale scale. int8 codes and fp8 bytes must be EQUAL on
  every page but the scratch page (its garbage depends on the scatter
  order of duplicate ids), scales within 1e-6 relative.
- The plain paged readers on quantized pools against the JAX refs, fp32
  atol 1e-5; a missing or spurious scale raises on both sides.
- The layer-lane server with ``kv_dtype`` on dense and MoE tiny models
  against the JAX server: greedy tokens identical, capacity stats equal;
  the first decode's logits within 0.05 (int8) / 0.15 (fp8) of a bf16
  pool's, the JAX battery's bounds (``tests/test_kv_quant.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import qwen_moe as jqwen_moe
from triton_dist_tpu.models.config import ModelConfig as JaxConfig
from triton_dist_tpu.ops.paged_flash_decode import (
    _require_pool_scales as jax_require_scales,
    paged_flash_decode_ref as jax_decode_ref,
)
from triton_dist_tpu.ops.paged_flash_qblock import (
    paged_flash_qblock_ref as jax_qblock_ref,
)
from triton_dist_tpu.serving import ServingEngine as JaxServingEngine
from triton_dist_tpu.serving import blocks as jb

from triton_dist_tpu_torch.models import Engine, ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.ops import paged_flash_decode as pfd
from triton_dist_tpu_torch.ops import paged_flash_qblock as pfq
from triton_dist_tpu_torch.serving import blocks as tb

L, N, KV, PAGE, HD, S, PMAX = 2, 8, 2, 4, 8, 2, 3
KVDS = ("int8", "fp8")


def _bytes(a) -> np.ndarray:
    """Storage bytes of a JAX array or a torch tensor (int8 / fp8)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _assert_same_pools(jc, tc):
    for jp, tp in ((jc.k_pages, tc.k_pages), (jc.v_pages, tc.v_pages)):
        np.testing.assert_array_equal(_bytes(tp)[:, 1:], _bytes(jp)[:, 1:])
    for js, ts in ((jc.k_scale, tc.k_scale), (jc.v_scale, tc.v_scale)):
        np.testing.assert_allclose(ts.numpy()[:, 1:], np.asarray(js)[:, 1:],
                                   rtol=1e-6, atol=0)


class _Both:
    """One JAX cache (replaced on every write) and one port cache (written
    in place), driven by the same calls on numpy inputs."""

    def __init__(self, kvd):
        self.j = jb.PagedKVCache.empty(L, N, PAGE, KV, HD, num_slots=S,
                                       p_max=PMAX, kv_dtype=kvd)
        self.t = tb.PagedKVCache.empty(L, N, PAGE, KV, HD, num_slots=S,
                                       p_max=PMAX, device="cpu",
                                       dtype=torch.float32, kv_dtype=kvd)

    def state(self, table, lens, live):
        table = np.asarray(table, np.int32)
        lens, live = np.asarray(lens, np.int32), np.asarray(live, np.int32)
        self.j = dataclasses.replace(self.j, block_table=jnp.asarray(table),
                                     lens=jnp.asarray(lens),
                                     live=jnp.asarray(live))
        self.t.block_table.copy_(torch.from_numpy(table))
        self.t.lens.copy_(torch.from_numpy(lens))
        self.t.live.copy_(torch.from_numpy(live))

    def call(self, op, *args, **kw):
        """``args`` are numpy arrays or ints for both sides."""
        ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args]
        self.j = getattr(self.j, op)(
            *ja, **{k: jnp.asarray(v) for k, v in kw.items()})
        ta = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
              for a in args]
        tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
        assert getattr(self.t, op)(*ta, **tkw) is None
        _assert_same_pools(self.j, self.t)


def _toks(rng, *shape):
    """K/V rows with a per-token magnitude spread, so later tokens of a
    page sometimes grow its scale and sometimes do not."""
    x = rng.randn(*shape, KV, HD).astype(np.float32)
    return x * rng.uniform(0.3, 3.0, size=shape + (1, 1)).astype(np.float32)


@pytest.mark.parametrize("kvd", KVDS)
def test_pool_writes_match_jax(kvd):
    rng = np.random.RandomState(0)
    c = _Both(kvd)
    assert c.t.quantized and c.t.qmax == c.j.qmax
    c.state([[1, 2, 3], [4, 5, 6]], [0, 0], [1, 1])
    for layer in range(L):
        # Slot 0: a 4-row chunk from 0 with a padding row, then one from 3
        # that ends mid-page (positions 3-5, a padding row); slot 1: a
        # chunk from 2 whose first page is prefix-resident (wfrom 4).
        for row, start, valid, wfrom in (([1, 2, 3], 0, 3, 0),
                                         ([1, 2, 3], 3, 3, 0),
                                         ([4, 5, 6], 2, 4, 4)):
            c.call("write_chunk", layer, _toks(rng, 4, 1), _toks(rng, 4, 1),
                   np.asarray(row, np.int32),
                   np.arange(start, start + 4, dtype=np.int32), valid, wfrom)
    # Decode appends across a page edge (slot 0 at 6, 7, 8; slot 1 parked
    # on the scratch row for the first two).
    for step in range(3):
        row1 = [4, 5, 6] if step == 2 else [0, 0, 0]
        c.state([[1, 2, 3], row1], [6 + step, 6], [1, int(step == 2)])
        for layer in range(L):
            c.call("append_decode", layer, _toks(rng, S, 1),
                   _toks(rng, S, 1))
    # A K = 4 verify block at lens (9, 7) with budgets (3, 2): the
    # over-budget candidates go to the scratch page, scales untouched.
    c.state([[1, 2, 3], [4, 5, 6]], [9, 7], [1, 1])
    for layer in range(L):
        c.call("append_block", layer, _toks(rng, S, 4), _toks(rng, S, 4),
               budget=np.asarray([3, 2], np.int32))
    # A prompt blit into page 7, then page 2 freed and reused by a chunk
    # from 0 (its scale resets at its first token) and a decode at 0.
    c.call("write_prompt", _toks(rng, L, PAGE).reshape(L, PAGE, KV, HD),
           _toks(rng, L, PAGE).reshape(L, PAGE, KV, HD),
           np.asarray([7], np.int32))
    c.state([[2, 0, 0], [3, 0, 0]], [0, 0], [1, 1])
    c.call("write_chunk", 0, _toks(rng, 4, 1), _toks(rng, 4, 1),
           np.asarray([2, 0, 0], np.int32), np.arange(4, dtype=np.int32),
           2, 0)
    c.call("append_decode", 1, _toks(rng, S, 1), _toks(rng, S, 1))
    # The dequantized views agree too (the readers' one gather).
    for layer in range(L):
        for got, want in zip(c.t.dense_layer(layer), c.j.dense_layer(layer)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)


def test_scatter_scale_mismatch_raises():
    q = tb.PagedKVCache.empty(1, 4, PAGE, 2, 8, num_slots=1, p_max=2,
                              device="cpu", kv_dtype="int8")
    n = tb.PagedKVCache.empty(1, 4, PAGE, 2, 8, num_slots=1, p_max=2,
                              device="cpu")
    ids = [1, 2]
    pay = q.gather_pages(ids)
    assert len(pay) == 4 and len(n.gather_pages(ids)) == 2
    with pytest.raises(ValueError, match="needs the payload's"):
        q.scatter_pages(pay[0], pay[1], ids)
    with pytest.raises(ValueError, match="unquantized"):
        n.scatter_pages(torch.zeros(1, 2, 2, PAGE, 8),
                        torch.zeros(1, 2, 2, PAGE, 8), ids, pay[2], pay[3])
    q.scatter_pages(*pay[:2], [3, 1], *pay[2:])
    assert torch.equal(q.k_scale[:, 3], pay[2][:, 0])


def _quant_pool(rng, kvd, n_pages, kvh, page, hd):
    """Random codes and scales of one layer's quantized pool, as a numpy
    pair (codes in their numpy dtype, fp32 scales)."""
    x = rng.randn(n_pages, kvh, page, hd).astype(np.float32) * 60.0
    codes = (np.clip(np.round(x), -127, 127).astype(np.int8) if kvd == "int8"
             else np.asarray(jnp.asarray(np.clip(x, -448, 448)).astype(
                 jnp.float8_e4m3fn)))
    return codes, rng.uniform(0.005, 0.05, (n_pages, kvh)).astype(np.float32)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.int8:
        return torch.from_numpy(a)
    return torch.from_numpy(a.view(np.uint8).copy()).view(
        torch.float8_e4m3fn)


@pytest.mark.parametrize("kvd", KVDS)
def test_quantized_refs_match_jax(kvd):
    rng = np.random.RandomState(1)
    b, h, n_pages, pmax = 3, 4, 14, 4
    kc, ks = _quant_pool(rng, kvd, n_pages, KV, PAGE, HD)
    vc, vs = _quant_pool(rng, kvd, n_pages, KV, PAGE, HD)
    table = rng.permutation(np.arange(1, n_pages))[:b * pmax].reshape(
        b, pmax).astype(np.int32)
    lens = np.asarray([1, 9, 16], np.int32)
    q = rng.randn(b, h, HD).astype(np.float32)
    t = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    targs = (torch.from_numpy(q), _to_torch(kc), _to_torch(vc),
             torch.from_numpy(table), torch.from_numpy(lens))
    jargs = tuple(map(jnp.asarray, (q, kc, vc, table, lens)))
    want = jax_decode_ref(*jargs, **j)
    for got in (pfd.paged_flash_decode_ref(*targs, **t),
                pfd.paged_flash_decode(*targs, **t)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    # Q-block: a chunk-like block and a verify block (per-row positions).
    pos = np.asarray([[0, 1, 2], [6, 7, 8], [13, 14, 15]], np.int32)
    qb = rng.randn(b, 3, h, HD).astype(np.float32)
    want = jax_qblock_ref(jnp.asarray(qb), *jargs[1:4],
                                       jnp.asarray(pos), **j)
    for fn in (pfq.paged_flash_qblock_ref, pfq.paged_flash_qblock):
        got = fn(torch.from_numpy(qb), *targs[1:4], torch.from_numpy(pos),
                 **t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    # A scaleless read of a quantized pool raises on both sides, and so do
    # scales beside an unquantized pool (the wrappers' reverse check).
    with pytest.raises(ValueError, match="QUANTIZED"):
        jax_decode_ref(*jargs)
    for fn in (pfd.paged_flash_decode, pfd.paged_flash_decode_ref):
        with pytest.raises(ValueError, match="QUANTIZED"):
            fn(*targs)
    plain = (targs[0], targs[1].float(), targs[2].float(), *targs[3:])
    with pytest.raises(ValueError, match="unquantized"):
        jax_require_scales(jnp.zeros((1,), jnp.float32), j["k_scale"],
                                  reject_spurious=True)
    with pytest.raises(ValueError, match="unquantized"):
        pfd.paged_flash_decode(*plain, **t)
    with pytest.raises(ValueError, match="unquantized"):
        pfq.paged_flash_qblock(torch.from_numpy(qb), *plain[1:4],
                               torch.from_numpy(pos), **t)


@pytest.mark.parametrize("kvd", KVDS)
def test_kv_cache_plan_quantized_matches_jax(kvd):
    for kw in (dict(max_len=64, page=8, num_slots=2),
               dict(max_len=4096, page=32, num_slots=4)):
        for dtype_bytes in (2, 4):
            want = JaxConfig.qwen3_8b().kv_cache_plan(
                dtype_bytes=dtype_bytes, kv_dtype=kvd, **kw)
            got = ModelConfig.qwen3_8b().kv_cache_plan(
                dtype_bytes=dtype_bytes, kv_dtype=kvd, **kw)
            assert got == want
            assert got["capacity_ratio_vs_native"] >= 1.9


def test_qwen3_32b_fields_match_jax():
    fields = [f.name for f in dataclasses.fields(ModelConfig)]
    t, j = ModelConfig.qwen3_32b(), JaxConfig.qwen3_32b()
    assert {f: getattr(t, f) for f in fields} == \
        {f: getattr(j, f) for f in fields}
    assert (t.num_hidden_layers, t.num_attention_heads,
            t.num_key_value_heads, t.hidden_size) == (64, 64, 8, 5120)


# ---- the layer-lane server, dense and MoE ---------------------------------

KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, head_dim=8)
MOE_KW = dict(KW, num_experts=4, num_experts_per_tok=2,
              moe_intermediate_size=32)
MAX_LEN, GEN = 32, 5
PROMPT_LENS = (3, 9, 6)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) pairs on the same fp32 weights, dense and
    MoE."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    out = {}
    jd = JaxEngine(JaxConfig.tiny(**KW), mesh, mode="xla", dtype=jnp.float32,
                   max_len=MAX_LEN, seed=3)
    jcfg = JaxConfig.tiny_moe(**MOE_KW)
    jm = JaxEngine(jcfg, mesh, mode="xla", dtype=jnp.float32, max_len=MAX_LEN,
                   params=jqwen_moe.init_params(jax.random.PRNGKey(5), jcfg),
                   model=jqwen_moe)
    for name, jeng, cfg in (("dense", jd, ModelConfig.tiny(**KW)),
                            ("moe", jm, ModelConfig.tiny_moe(**MOE_KW))):
        params = from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                                 "cpu", torch.float32)
        out[name] = (jeng, Engine(cfg, device="cpu", dtype=torch.float32,
                                  max_len=MAX_LEN, params=params))
    return out


def _prompts(vocab):
    rng = np.random.RandomState(4)
    return [[int(t) for t in rng.randint(1, vocab, n)] for n in PROMPT_LENS]


def _run(srv, prompts):
    hs = [srv.submit(p, max_new_tokens=GEN) for p in prompts]
    srv.run()
    return [h.tokens for h in hs]


@pytest.mark.parametrize("model,kvd,buckets", [
    ("dense", "int8", (4, 8)), ("moe", "fp8", None)])
def test_quantized_server_matches_jax(engines, model, kvd, buckets):
    jeng, teng = engines[model]
    kw = dict(num_slots=2, page=8, kv_dtype=kvd, prefill_buckets=buckets)
    prompts = _prompts(teng.cfg.vocab_size)
    jsrv = JaxServingEngine(jeng, **kw)
    srv = teng.serving(**kw)
    assert srv.cache.quantized and srv.cache.k_pages.dtype == (
        torch.int8 if kvd == "int8" else torch.float8_e4m3fn)
    assert _run(srv, prompts) == _run(jsrv, prompts)
    st, jst = srv.stats(), jsrv.stats()
    assert st["kv_dtype"] == jst["kv_dtype"] == kvd
    assert srv.plan == jsrv.plan
    assert st["kv_bytes_per_token"] == jst["kv_bytes_per_token"]
    for key in ("bytes_per_token", "capacity_ratio_vs_native",
                "pages_at_native_bytes", "num_pages"):
        assert st["pool"][key] == jst["pool"][key], key
    assert st["pool"]["capacity_ratio_vs_native"] >= 1.9


def _first_decode_logits(teng, kvd, prompt):
    """One decode dispatch after a monolithic prefill of ``prompt``: the
    same token over the same prompt, only the pool storage differs."""
    srv = teng.serving(num_slots=2, page=8, kv_dtype=kvd)
    h = srv.submit(prompt, max_new_tokens=2)
    stalled = []
    for hh in srv.sched.admit():
        srv._admit(hh, stalled)
    srv._toks[0] = h.tokens[-1]
    srv.manager.append(0, int(srv._lens[0]))
    tbl = np.zeros((srv.num_slots, srv.p_max), np.int32)
    tbl[0] = srv.manager.table_row(0)
    return srv._dispatch(tbl)[0]


@pytest.mark.parametrize("model", ["dense", "moe"])
def test_quantized_logit_gap_bounded(engines, model):
    teng = engines[model][1]
    prompt = list(range(1, 12))
    base = _first_decode_logits(teng, "bf16", prompt)
    for kvd, bound in (("int8", 0.05), ("fp8", 0.15)):
        gap = np.abs(_first_decode_logits(teng, kvd, prompt) - base).max()
        assert 0 < gap < bound, (kvd, gap)


def test_bad_kv_dtype_rejected(engines):
    with pytest.raises(ValueError, match="kv_dtype"):
        engines["dense"][1].serving(num_slots=2, page=8, kv_dtype="int4")
