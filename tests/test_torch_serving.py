"""The slice as a whole: the PyTorch port's continuous-batching server
against the JAX package's, on the same weights and the same seeded
churn.

The JAX ``Engine`` (1-device mesh, mode "xla", fp32, seed 3) draws the
weights; ``from_jax_params`` carries them to the port. Both servers run
chunked prefill with buckets (4, 8), two slots and a pool of five pages
(four usable) — small enough that decode growth preempts a request —
under the same randomized arrival schedule, with EOS ids that end two
requests early so their slots recycle mid-run. Greedy tokens must be
IDENTICAL per request; the first-token logits must agree within fp32
atol 1e-4 (chunked attention sums in another order on each side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.serving import ServingEngine as JaxServingEngine

from triton_dist_tpu_torch.models import Engine, ModelConfig
from triton_dist_tpu_torch.models.convert import from_jax_params

KW = dict(num_key_value_heads=2)
MAX_LEN, PAGE, BUCKETS = 64, 8, (4, 8)
SERVE = dict(num_slots=2, page=PAGE, num_pages=5, prefill_buckets=BUCKETS)
PROMPT_LENS = (3, 9, 13, 6, 5, 2)
GEN = 6


@pytest.fixture(scope="module")
def engines():
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jeng = JaxEngine(JaxConfig.tiny(**KW), mesh, mode="xla",
                     dtype=jnp.float32, max_len=MAX_LEN, seed=3)
    cfg = ModelConfig.tiny(**KW)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                             "cpu", torch.float32)
    teng = Engine(cfg, device="cpu", dtype=torch.float32, max_len=MAX_LEN,
                  params=params)
    return jeng, teng


def _requests(vocab):
    rng = np.random.RandomState(7)
    return [[int(t) for t in rng.randint(0, vocab, n)] for n in PROMPT_LENS]


def _serve(srv, prompts, eos):
    """Drive ``srv`` through the seeded arrival schedule (0-2 submissions
    per tick); record each request's first-token logits."""
    first = {}
    pick = srv._pick

    def recording_pick(row, req, step):
        if step == 0:
            first[req.request_id] = np.array(row, np.float32)
        return pick(row, req, step)

    srv._pick = recording_pick
    arrivals = np.random.RandomState(8)
    pending = list(zip(prompts, eos))
    handles = []
    while pending or not srv.sched.idle:
        for _ in range(int(arrivals.randint(0, 3))):
            if pending:
                prompt, e = pending.pop(0)
                handles.append(srv.submit(prompt, max_new_tokens=GEN,
                                          eos_id=e))
        srv.step()
    return srv, handles, [first[h.request.request_id] for h in handles]


def test_serving_token_exact_with_jax(engines):
    jeng, teng = engines
    prompts = _requests(teng.cfg.vocab_size)
    # EOS ids from the port's own EOS-free run, mid-output, so early stop
    # (slot recycle) really triggers.
    _, plain, _ = _serve(teng.serving(**SERVE), prompts, [None] * 6)
    eos = [None] * 6
    for i in (1, 4):
        eos[i] = plain[i].tokens[GEN // 2]

    tsrv, th, tfirst = _serve(teng.serving(**SERVE), prompts, eos)
    jsrv, jh, jfirst = _serve(JaxServingEngine(jeng, **SERVE), prompts, eos)

    assert [h.tokens for h in th] == [h.tokens for h in jh]
    assert all(h.status == "done" for h in th)
    for t, j in zip(tfirst, jfirst):
        np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)
    early = [h for h, e in zip(th, eos)
             if e is not None and len(h.tokens) < GEN]
    assert early and all(h.tokens[-1] == h.request.eos_id for h in early)
    tst, jst = tsrv.stats(), jsrv.stats()
    assert tst["preemptions"] == jst["preemptions"] >= 1
    assert tst["decode_dispatches"] == jst["decode_dispatches"]
    assert tst["prefill_chunks"] == jst["prefill_chunks"]
    assert tst["prefill_cache_size"] <= len(BUCKETS)
    assert tst["pool"]["used_pages"] == 0, "all pages recycled"


def test_prefix_reuse_token_exact_with_jax(engines):
    """Prefix reuse: requests sharing full prompt pages attend the first
    sharer's pages and skip their compute (``wfrom``); tokens, prefix
    hits and chunk counts agree with the JAX server."""
    jeng, teng = engines
    rng = np.random.RandomState(9)
    shared = [int(t) for t in rng.randint(0, teng.cfg.vocab_size, 2 * PAGE)]
    prompts = [shared + [int(t) for t in rng.randint(0, 256, n)]
               for n in (3, 1, 6)]
    kw = dict(SERVE, num_pages=17, prefix_reuse=True)
    tsrv = teng.serving(**kw)
    jsrv = JaxServingEngine(jeng, **kw)
    outs = []
    for srv in (tsrv, jsrv):
        first = srv.generate(prompts[:1], max_new_tokens=3)
        outs.append(first + srv.generate(prompts[1:], max_new_tokens=3))
    assert outs[0] == outs[1]
    tst, jst = tsrv.stats(), jsrv.stats()
    assert tst["pool"]["prefix_hits"] == jst["pool"]["prefix_hits"] >= 2
    assert tst["prefill_chunks"] == jst["prefill_chunks"]


def test_server_contracts(engines):
    """Port-side serving contracts: monolithic admission (no
    ``prefill_buckets``: each prompt one ``Engine.prefill``, blitted into
    pages) gives the JAX monolithic server's tokens and counters, static
    gang admission waits for a full batch, deadlines time requests out,
    and the queue bound pushes back."""
    from triton_dist_tpu_torch.serving import QueueFullError

    jeng, teng = engines
    prompts = _requests(teng.cfg.vocab_size)
    mono = dict(num_slots=2, page=PAGE, num_pages=5)
    tsrv, jsrv = teng.serving(**mono), JaxServingEngine(jeng, **mono)
    assert (tsrv.generate(prompts, max_new_tokens=GEN)
            == jsrv.generate(prompts, max_new_tokens=GEN))
    tst, jst = tsrv.stats(), jsrv.stats()
    for key in ("prefill_calls", "prefill_tokens", "preemptions",
                "decode_dispatches"):
        assert tst[key] == jst[key], key
    assert tst["preemptions"] >= 1 and tst["prefill_chunks"] == 0
    srv = teng.serving(**SERVE)
    with pytest.raises(ValueError):
        srv.submit([1] * 60, max_new_tokens=8)      # beyond max_len
    now = [0.0]
    srv = teng.serving(**dict(SERVE, num_pages=17), policy="static",
                       max_queue=3, clock=lambda: now[0])
    hs = [srv.submit([1, 2, 3], max_new_tokens=4) for _ in range(3)]
    with pytest.raises(QueueFullError):
        srv.submit([1], max_new_tokens=1)
    srv.step()
    assert [h.status for h in hs] == ["running", "running", "queued"]
    late = srv.submit([4, 5], max_new_tokens=4, deadline=1.0)
    now[0] = 2.0
    srv.run()
    assert late.status == "timeout" and all(h.status == "done" for h in hs)
    assert hs[0].tokens == hs[2].tokens              # same prompt, greedy
