"""The port's expert-parallel Qwen3-MoE engine against the JAX package's,
on the CPU in fp32: ``Engine(tiny_moe(num_experts=8), mesh=make_mesh(tp=4,
device="cpu"), moe_impl="ep", ...)`` (two experts a rank) against JAX's
``Engine(cfg, mesh4, mode="xla", model=qwen_moe, moe_impl="ep", ...)`` on
the same weights (``from_jax_params``).

Cases, each in the port's ``"xla"``, ``"fused"`` and ``"fused_ar"``
modes: the drop-free dispatch with the ``"ar"`` and the ``"ragged"``
decode, and the ``"ll"`` decode; the capped dispatch (``ep_capacity=3``:
some assignments overflow and drop) in the token-sharded modes (``"xla"``,
``"fused"``), whose ranks hold the rows JAX's do (``"fused_ar"`` gives
every rank the whole batch, so its drops differ). Prefill logits, the KV
cache and the first decode step's logits within 1e-5 (fp32 sums in other
orders), greedy tokens identical. The capped JAX engine keeps row 18 out
of interpret mode: its ``ep_ctx`` is swapped for ``impl="xla"`` before the
first call (its jitted closures read that dict when they trace). The
``"ll"`` JAX engine runs row 23 in interpret mode (the one engine case
that does), for one decode step: its decode logits within LL_ATOL.

LL_ATOL: both sides quantize the same rows with the same recipe, but the
rows come out of fp32 sums taken in another order (XLA's einsums against
PyTorch's bmm), so a value within an ulp of a rounding boundary can take
the other int8 code. Measured on the CPU: the "ll" decode
logits are 1.5e-7 from JAX's (no code flipped at this seed); one int8 code
flipped on purpose in the first exchange moves them by 2.3e-3-2.6e-3,
and rank 0 reading rank 1's chunk one slot off by 0.080. LL_ATOL = 5e-3
admits a flipped code or two and fails a wrong exchange.

Also: the 2 x 2 expert-parallel engine (``make_mesh(dp=2, tp=2)``,
``axis=ep_axis=("dp", "tp")``) against JAX's 2 x 2 ``"xla"`` engine for
each decode transport (``"ll2d"`` included: its two hops in JAX's ``"xla"``
wire form, which an interpret-mode 2D mesh takes), what still raises (an
ep axis of its own, EP on the paged lanes) and JAX's knob errors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models import qwen_moe as jqwen_moe
from triton_dist_tpu.parallel.mesh import make_mesh as jax_make_mesh

from triton_dist_tpu_torch import Engine, ModelConfig, make_mesh
from triton_dist_tpu_torch.models import qwen_moe
from triton_dist_tpu_torch.models.convert import from_jax_params

TOL = dict(atol=1e-5, rtol=0)
LL_ATOL = 5e-3
MAX_LEN, GEN = 24, 4
CFG = ModelConfig.tiny_moe(num_experts=8)
JCFG = JaxConfig.tiny_moe(num_experts=8)
CASES = {"ar": dict(ep_transport="ar"), "ragged": dict(ep_transport="ragged"),
         "capped": dict(ep_capacity=3), "ll": dict(ep_transport="ll")}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX tp = 4 xla EP engines, one weight set: per case its prefill
    logits and cache, the first decode step's logits and the greedy
    tokens (the "ll" case: the prefill's and that step's). The drop-free
    cases share one engine and its compiled prefill: each transport
    re-jits only the decode (``_build``), as the engine's closures read
    ``model_kwargs`` when they trace."""
    mesh = jax_make_mesh(tp=4, devices=jax.devices()[:4])
    ids = np.random.RandomState(0).randint(0, 256, (2, 12)).astype(np.int32)
    dropfree = JaxEngine(JCFG, mesh, mode="xla", dtype=jnp.float32,
                         max_len=MAX_LEN, seed=5, model=jqwen_moe,
                         moe_impl="ep", ep_transport="ar")
    capped = JaxEngine(JCFG, mesh, mode="xla", dtype=jnp.float32,
                       max_len=MAX_LEN, model=jqwen_moe, moe_impl="ep",
                       params=dropfree.params, **CASES["capped"])
    ctx = capped.model_kwargs["ep_ctx"]
    capped.model_kwargs["ep_ctx"] = dataclasses.replace(ctx, impl="xla")
    runs = {}
    for case in CASES:
        jeng = capped if case == "capped" else dropfree
        if jeng is dropfree and case != "ar":
            jeng.model_kwargs["transport"] = case
            _, jeng._decode = jeng._build("xla")
        logits, cache = jeng.prefill(ids)
        run = dict(logits=np.asarray(logits), k=np.asarray(cache.k),
                   v=np.asarray(cache.v))
        step, _ = jeng.decode(jnp.argmax(logits, -1).astype(jnp.int32),
                              cache)
        run["step"] = np.asarray(step)
        run["toks"] = (np.stack([run["logits"].argmax(-1),
                                 run["step"].argmax(-1)], 1)
                       if case == "ll" else np.asarray(jeng.serve(ids, GEN)))
        runs[case] = run
    tparams = from_jax_params(jax.tree.map(np.asarray, dropfree.params), CFG,
                              "cpu", torch.float32)
    return dict(ids=ids, runs=runs, params=tparams)


def _engine(params, mode, **kw):
    return Engine(CFG, mesh=make_mesh(tp=4, device="cpu"), mode=mode,
                  dtype=torch.float32, max_len=MAX_LEN, params=params,
                  moe_impl="ep", **kw)


@pytest.mark.parametrize("case,mode", [
    (case, mode) for case in CASES for mode in ("xla", "fused", "fused_ar")
    if (case, mode) != ("capped", "fused_ar")])
def test_ep_engine_matches_jax(jax_runs, case, mode):
    want, ids = jax_runs["runs"][case], jax_runs["ids"]
    eng = _engine(jax_runs["params"], mode, **CASES[case])
    assert eng.ep_transport == CASES[case].get("ep_transport")
    assert eng.ep_ctx.capacity == CASES[case].get("ep_capacity")
    logits, cache = eng.prefill(ids)
    np.testing.assert_allclose(logits.numpy(), want["logits"], **TOL)
    np.testing.assert_allclose(cache.k.numpy(), want["k"], **TOL)
    np.testing.assert_allclose(cache.v.numpy(), want["v"], **TOL)
    step, _ = eng.decode(torch.argmax(logits, -1), cache)
    np.testing.assert_allclose(step.numpy(), want["step"],
                               atol=LL_ATOL if case == "ll" else 1e-5,
                               rtol=0)
    gen = want["toks"].shape[1]
    np.testing.assert_array_equal(eng.serve(ids, gen_len=gen).numpy(),
                                  want["toks"])


def _ep2d_engine_against_jax(ids):
    """The 2 x 2 expert-parallel engine (``make_mesh(dp=2, tp=2)``,
    ``axis=ep_axis=("dp", "tp")``: the trunk and the experts over both
    axes, JAX's ``EP2DContext``) against JAX's ``"xla"`` engine on the same
    weights: prefill logits within 1e-5 and greedy tokens equal, in every
    mode, for ``ep_transport`` None, ``"ll2d"`` and ``"ar"`` (JAX's None
    decodes as ``"ar"``: its ``moe_ffn_decode`` takes ``transport or
    "ar"``, so one JAX run serves both)."""
    ax = ("dp", "tp")
    jm = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ax)
    jeng = JaxEngine(JCFG, jm, axis=ax, mode="xla", dtype=jnp.float32,
                     max_len=MAX_LEN, seed=6, model=jqwen_moe, moe_impl="ep",
                     ep_axis=ax, ep_transport="ar")
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), CFG,
                             "cpu", torch.float32)
    logits = np.asarray(jeng.prefill(ids)[0])
    want = {"ar": np.asarray(jeng.serve(ids, GEN))}
    jeng.model_kwargs["transport"] = "ll2d"
    _, jeng._decode = jeng._build("xla")
    want["ll2d"] = np.asarray(jeng.serve(ids, GEN))
    want[None] = want["ar"]
    mesh = make_mesh(dp=2, tp=2, device="cpu")
    for transport in (None, "ll2d", "ar"):
        for mode in ("xla", "fused", "fused_ar"):
            eng = Engine(CFG, mesh=mesh, axis=ax, mode=mode,
                         dtype=torch.float32, max_len=MAX_LEN, params=params,
                         moe_impl="ep", ep_axis=ax, ep_transport=transport)
            if transport is None:
                np.testing.assert_allclose(eng.prefill(ids)[0].numpy(),
                                           logits, **TOL)
            np.testing.assert_array_equal(
                eng.serve(ids, gen_len=GEN).numpy(), want[transport])
    return params, mesh


def test_ep_engine_knobs_and_what_still_raises(jax_runs):
    """JAX's knob checks, the views, and what still raises. A hierarchical
    ``ep_axis`` is ported: the 2 x 2 engine is held to JAX's here
    (:func:`_ep2d_engine_against_jax`), and a pair that is not the engine's
    own axis, ``ep_capacity`` with it, tensor-parallel experts over it and
    an ep axis of its own raise."""
    params = jax_runs["params"]
    p2d, mesh2d = _ep2d_engine_against_jax(jax_runs["ids"])
    with pytest.raises(ValueError, match="over the engine's own"):
        _engine(params, "xla", ep_axis=("dcn", "ici"))
    with pytest.raises(ValueError, match="queue A item 5"):
        _engine(params, "xla", ep_axis="ep")
    kw2d = dict(mesh=mesh2d, axis=("dp", "tp"), dtype=torch.float32,
                params=p2d)
    with pytest.raises(ValueError, match="drop-free"):
        Engine(CFG, moe_impl="ep", ep_axis=("dp", "tp"), ep_capacity=3,
               **kw2d)
    with pytest.raises(ValueError, match="queue A item 5"):
        Engine(CFG, **kw2d)
    with pytest.raises(ValueError, match=r"ep_transport='bogus' not in"):
        _engine(params, "xla", ep_transport="bogus")
    with pytest.raises(ValueError, match="ep_transport is an EP decode knob"):
        Engine(CFG, mesh=make_mesh(tp=4, device="cpu"), dtype=torch.float32,
               params=params, ep_transport="ll")
    eng = _engine(params, "xla", ep_transport="ll2d")
    logits, cache = eng.prefill(jax_runs["ids"])
    with pytest.raises(ValueError, match="needs a hierarchical EP2DContext"):
        eng.decode(torch.argmax(logits, -1), cache)
    assert _engine(params, "xla", ep_transport="auto").ep_transport == "auto"
    # Each rank's experts are views of the one weight: no copy.
    specs = qwen_moe.param_specs(params, 4, moe_impl="ep")
    moe = params.layers[1].moe
    assert specs[1]["w_gate"].shape == (4, 2, *moe.w_gate.shape[1:])
    assert specs[1]["w_down"][3].data_ptr() == moe.w_down[6].data_ptr()
    one = Engine(CFG, device="cpu", dtype=torch.float32, max_len=MAX_LEN,
                 params=params, moe_impl="ep")
    with pytest.raises(ValueError, match="queue A item 8"):
        one.serving(num_slots=2, page=8)
