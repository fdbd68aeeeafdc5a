"""The megakernel's prompt task sets (prefill chunk and batched prefill)
against the JAX package's, on the CPU in fp32.

Geometry of ``tests/test_torch_megakernel.py``: the tiny config at 2
layers (vocab 64, hidden 32, 4/2 heads, head_dim 8), ``tile_w=16``,
``t_tile=8``, ``page=8``, batch 2, ``max_len=32``; chunk buckets (4, 8)
and ``prefill_seq=4``. JAX runs on a one-device mesh with its Pallas
kernel in interpret mode, each JAX launch once per module. Host logic
must match exactly (row codes, task tables, claim lists, the shared
arena); logits and written pool rows within 1e-5 in fp32 (both sides sum
fp32 in a different order; measured differences are ~1e-7), and every
pool row a launch must not write stays bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.megakernel import ModelBuilder as JaxBuilder
from triton_dist_tpu.megakernel.engine import MegaKernelEngine as JaxEngine
from triton_dist_tpu.models.config import ModelConfig as JaxConfig
from triton_dist_tpu.ops.chunked_prefill import (
    chunk_row_codes as jax_chunk_row_codes)

from triton_dist_tpu_torch.megakernel import MegaKernelEngine, ModelBuilder
from triton_dist_tpu_torch.models import ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params
from triton_dist_tpu_torch.ops.chunked_prefill import chunk_row_codes

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=32,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=8)
CFG = ModelConfig.tiny(**KW)
B, MAXLEN, TILE_W, T_TILE, PAGE, SEQ = 2, 32, 16, 8, 8, 4
BUCKETS = (4, 8)
P_MAX = MAXLEN // PAGE
GEOM = dict(batch=B, max_len=MAXLEN, tile_w=TILE_W, t_tile=T_TILE)
PAGED = dict(GEOM, paged=True, page=PAGE, num_pages=B * P_MAX + 1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


@pytest.mark.parametrize("bucket", BUCKETS)
def test_chunk_row_codes_match_jax(bucket):
    for start in (0, 3, 8, 13):
        for valid in range(1, bucket + 1):
            for wfrom in (0, start, start + 2, start + bucket + 1):
                got = chunk_row_codes(start, bucket, valid, wfrom)
                want = jax_chunk_row_codes(start, bucket, valid, wfrom)
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)


BUILDS = {
    "chunk-static": dict(batch=8, seq=8, chunk=True, paged=True, page=PAGE),
    "chunk-dynamic": dict(batch=4, seq=4, chunk=True, paged=True, page=PAGE,
                          schedule="dynamic"),
    "prefill-paged": dict(batch=B * SEQ, seq=SEQ, paged=True, page=PAGE),
    "prefill-dense": dict(batch=B * SEQ, seq=SEQ, schedule="dynamic",
                          num_cores=2),
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_builder_tables_match_jax(mesh, name):
    kw = dict(BUILDS[name], max_len=MAXLEN, tile_w=TILE_W, t_tile=T_TILE)
    j = JaxBuilder(JaxConfig.tiny(**KW), mesh, **kw)
    t = ModelBuilder(CFG, **kw)
    assert ([(x.task_type, x.args, x.layer, x.deps) for x in t.graph.tasks]
            == [(x.task_type, x.args, x.layer, x.deps)
                for x in j.graph.tasks])
    for attr in ("task_types", "task_args"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr),
                                      err_msg=attr)
    for got, want in zip(t._pruned_edges, j._pruned_edges):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t._cost, j._cost)
    for k, want in j.sched.items():
        np.testing.assert_array_equal(t.sched[k], want, err_msg=k)
    assert t.schema.describe() == j.schema.describe()
    assert (t.qlen, t.arena_rows, t.page) == (j.qlen, j.arena_rows, j.page)
    # The claim list both step forms run: the slot list without holes.
    slots = (j.claims if kw.get("schedule") == "dynamic"
             else j.sched["queue"]).reshape(-1)
    np.testing.assert_array_equal(t.claim_list, slots[slots >= 0])


@pytest.mark.parametrize("kw,match", [
    (dict(batch=6, seq=4), "not divisible by seq"),
    (dict(batch=8, seq=4, chunk=True, paged=True), "must equal seq"),
    (dict(batch=8, seq=8, chunk=True), "paged=True"),
    (dict(batch=8, seq=8, paged=True, page=12, max_len=48, t_tile=4),
     "seq|page"),
], ids=["batch%seq", "chunk-batch!=seq", "chunk-dense",
        "seq-not-dividing-page"])
def test_builder_constraints_match_jax(mesh, kw, match):
    kw = dict(dict(max_len=MAXLEN, t_tile=T_TILE, tile_w=TILE_W), **kw)
    with pytest.raises(ValueError, match=match.replace("|", "\\|")):
        JaxBuilder(JaxConfig.tiny(**KW), mesh, **kw)
    with pytest.raises(ValueError, match=match.replace("|", "\\|")):
        ModelBuilder(CFG, **kw)


def _pair(mesh, seed, **kw):
    """A JAX engine (interpret mode) and the port's on its weights."""
    jeng = JaxEngine(JaxConfig.tiny(**KW), mesh, seed=seed, keep_params=True,
                     **kw)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), CFG,
                             "cpu", torch.float32)
    teng = MegaKernelEngine(CFG, params=params, device="cpu",
                            dtype=torch.float32, keep_params=True, **kw)
    return jeng, teng


def _set_pools(mesh, jeng, teng, seed):
    """Random history in both engines' pools; returns it."""
    rng = np.random.RandomState(seed)
    shape = tuple(teng.k_cache.shape)
    k0 = (rng.randn(*shape) * 0.5).astype(np.float32)
    v0 = (rng.randn(*shape) * 0.5).astype(np.float32)
    kv_sh = NamedSharding(mesh, P(None, None, None, "tp", None))
    jeng.k_cache = jax.device_put(jnp.asarray(k0), kv_sh)
    jeng.v_cache = jax.device_put(jnp.asarray(v0), kv_sh)
    teng.k_cache.copy_(torch.from_numpy(k0))
    teng.v_cache.copy_(torch.from_numpy(v0))
    return k0, v0


@pytest.mark.parametrize("kind", ["chunk", "prefill"])
def test_shared_arena_pack_matches_jax(mesh, kind):
    """One arena for every build: the largest footprint packs it, and it
    equals JAX's bit for bit."""
    extra = (dict(prefill_buckets=BUCKETS) if kind == "chunk"
             else dict(prefill_seq=SEQ))
    jeng, teng = _pair(mesh, 4, **PAGED, **extra)
    builds = [teng.builder, *teng.chunk_builders.values()]
    if teng.prefill_builder is not None:
        builds.append(teng.prefill_builder)
    assert len(builds) == (3 if kind == "chunk" else 2)
    assert teng.arena.shape[0] == max(b.arena_rows for b in builds) > \
        teng.builder.arena_rows
    np.testing.assert_array_equal(teng.arena.numpy(),
                                  np.asarray(jeng._arena))


# (start, bucket, valid, wfrom) of three chunks of one slot, over random
# history: one starting mid-page, one with attend-only rows (positions
# 12-15 resident, below wfrom), one with two dead padding rows.
CHUNKS = {"mid-page": (4, 8, 8, 0), "attend-only": (12, 8, 8, 16),
          "dead-rows": (20, 4, 2, 0)}
SLOT = 1


@pytest.fixture(scope="module")
def chunk_runs(mesh):
    jeng, teng = _pair(mesh, 6, **PAGED, prefill_buckets=BUCKETS)
    _set_pools(mesh, jeng, teng, 1)
    table = (np.random.RandomState(2).permutation(B * P_MAX) + 1).astype(
        np.int32).reshape(B, P_MAX)
    row = table[SLOT]
    rng = np.random.RandomState(3)
    runs = {}
    for name, (start, bucket, valid, wfrom) in CHUNKS.items():
        toks = np.zeros(bucket, np.int32)
        toks[:valid] = rng.randint(0, CFG.vocab_size, valid)
        codes = chunk_row_codes(start, bucket, valid, wfrom)
        before = teng.k_cache.numpy().copy(), teng.v_cache.numpy().copy()
        want = np.asarray(jeng.prefill_chunk(jnp.asarray(toks),
                                             jnp.asarray(codes),
                                             jnp.asarray(row)))
        got = teng.prefill_chunk(toks, codes, row).numpy()
        runs[name] = dict(
            got=got, want=want, before=before, codes=codes, row=row,
            pools=(teng.k_cache.numpy().copy(), teng.v_cache.numpy().copy()),
            jpools=(np.asarray(jeng.k_cache), np.asarray(jeng.v_cache)))
    return runs


@pytest.mark.parametrize("name", list(CHUNKS))
def test_prefill_chunk_matches_jax(chunk_runs, name):
    run = chunk_runs[name]
    start, bucket, valid, wfrom = CHUNKS[name]
    assert run["got"].shape == (bucket, CFG.vocab_size)
    np.testing.assert_allclose(run["got"], run["want"], **TOL)
    for pool, jpool, prior in zip(run["pools"], run["jpools"],
                                  run["before"]):
        np.testing.assert_allclose(pool, jpool, **TOL)
        changed = np.argwhere((pool != prior).any(axis=(-2, -1)))
        # Exactly the writing rows' (layer, page, offset) changed.
        want = {(li, int(run["row"][p // PAGE]), p % PAGE)
                for li in range(CFG.num_hidden_layers)
                for p in run["codes"] if p >= 0}
        assert {tuple(map(int, c)) for c in changed} == want
        # Attend-only and dead rows' positions are unchanged bit for bit
        # (a dead row decodes to position 0).
        for code in run["codes"][run["codes"] < 0]:
            p = max(-int(code) - 2, 0)
            np.testing.assert_array_equal(
                pool[:, run["row"][p // PAGE], p % PAGE],
                prior[:, run["row"][p // PAGE], p % PAGE])


@pytest.mark.parametrize("schedule", ["static", "dynamic"])
def test_chunk_row_equals_one_token_lane(schedule):
    """Chunks of 8 and 4 rows then give, at row valid-1, the one-token
    lane's logits at that position (slot 1 of a decode batch of 2)."""
    kw = dict(PAGED, schedule=schedule)
    lane = MegaKernelEngine(CFG, device="cpu", dtype=torch.float32, seed=8,
                            keep_params=True, **kw)
    chunked = MegaKernelEngine(CFG, device="cpu", dtype=torch.float32,
                               params=lane.params, prefill_buckets=BUCKETS,
                               **kw)
    table = (np.random.RandomState(5).permutation(B * P_MAX) + 1).astype(
        np.int32)
    lane.block_table = table
    prompt = np.random.RandomState(6).randint(0, CFG.vocab_size, 11)
    start = 0
    for bucket, valid in ((8, 8), (4, 3)):
        toks = np.zeros(bucket, np.int32)
        toks[:valid] = prompt[start:start + valid]
        got = chunked.prefill_chunk(
            toks, chunk_row_codes(start, bucket, valid, 0),
            table.reshape(B, P_MAX)[1], row=valid - 1)
        start += valid
    for pos, tok in enumerate(prompt):
        want = lane.decode_step(np.array([0, tok], np.int32),
                                np.array([0, pos], np.int32))[1]
    assert got.shape == (CFG.vocab_size,)
    torch.testing.assert_close(got, want, **TOL)
    assert chunked.steps_done == 2 and chunked.chunk_cache_size() == 2


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_prefill_matches_jax(mesh, paged):
    """Batched prefill at start_pos 0 and at the seq-aligned 4, over
    random history (a reversed block table when paged)."""
    kw = dict(PAGED) if paged else dict(GEOM)
    jeng, teng = _pair(mesh, 9, prefill_seq=SEQ, **kw)
    k0, v0 = _set_pools(mesh, jeng, teng, 4)
    if paged:
        table = np.arange(B * P_MAX, dtype=np.int32)[::-1].copy() + 1
        jeng.block_table = jnp.asarray(table)
        teng.block_table = table
    rng = np.random.RandomState(5)
    for start in (0, SEQ):
        prompt = rng.randint(0, CFG.vocab_size, (B, SEQ)).astype(np.int32)
        want = np.asarray(jeng.prefill(jnp.asarray(prompt), start_pos=start))
        got = teng.prefill(prompt, start_pos=start).numpy()
        assert got.shape == (B, CFG.vocab_size)
        np.testing.assert_allclose(got, want, **TOL)
    for pool, jpool, init in ((teng.k_cache, jeng.k_cache, k0),
                              (teng.v_cache, jeng.v_cache, v0)):
        pool, jpool = pool.numpy(), np.asarray(jpool)
        np.testing.assert_allclose(pool, jpool, **TOL)
        written = (pool != init).any(axis=(-2, -1))
        # layers x slots x 2 * SEQ positions, and nothing else.
        assert written.sum() == 2 * B * 2 * SEQ
        np.testing.assert_array_equal(pool[~written], init[~written])
    assert teng.steps_done == 2
    if paged:
        with pytest.raises(ValueError, match="start_pos % prefill_seq"):
            teng.prefill(prompt, start_pos=2)
