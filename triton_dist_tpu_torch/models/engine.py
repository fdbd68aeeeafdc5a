"""Inference engine (counterpart of ``triton_dist_tpu/models/engine.py``).

The engine carries the configuration, the model (dense Qwen3 or
Qwen3-MoE), its weights and, optionally, a mesh: :meth:`Engine.prefill`,
:meth:`Engine.decode` and :meth:`Engine.serve` run the dense-cache loop,
and :meth:`Engine.serving` hands the engine to the continuous-batching
server. Without a mesh (or at tp = 1) the three forward modes compute the
same function except for the MoE prefill, where ``mode="fused"`` runs the
fused expert pipeline (the row-tile grouped GEMM kernel). With
``mesh=make_mesh(tp=n)`` the model runs n simulated tensor-parallel
ranks on the one device (:mod:`~triton_dist_tpu_torch.models.dense`):
``"fused"`` prefills through the AG+GEMM and GEMM+RS kernels,
``"fused_ar"`` through GEMM+AR, and every non-``"xla"`` decode step
through GEMM+AR; a MoE model's ``"fused"`` prefill runs its experts
through the AG+grouped GEMM, the grouped GEMM and the fused combine +
reduce-scatter kernels (:mod:`~triton_dist_tpu_torch.models.qwen_moe`).
With ``mesh=make_mesh(dp=n_o, tp=n_in)`` and ``axis=("dp", "tp")`` a dense
model shards over both axes, n_o·n_in ranks (JAX's ``Engine(axis=)``):
``"fused"`` prefills through the hierarchical AG+GEMM and GEMM+RS kernels,
and every non-``"xla"`` decode step (and the ``"fused_ar"`` prefill)
through GEMM+AR on the inner axis followed by an all-reduce on the outer
one.
With ``moe_impl="ep"`` a MoE model's experts are sharded by expert over
the same ranks (JAX's engine builds its ``EPContext`` over the ``tp``
axis): every prefill layer dispatches and combines through the
all-to-all kernel (drop-free: its ragged form; ``ep_capacity``: its dense
form) and runs the experts through the grouped GEMM kernel, and decode
takes ``ep_transport`` (``"ll"``: the quantizing all-to-all kernel twice a
layer). Over ``axis=("dp", "tp")`` with ``ep_axis=("dp", "tp")`` the
experts shard over both axes (JAX's ``EP2DContext``): the prefill's
dispatch and combine take two ragged hops each, inner then outer, and
``ep_transport="ll2d"`` decodes through the two-hop quantizing exchange.
:meth:`Engine.serving` serves a dense model at tp > 1 too: the
paged steps run the same ranks on a replicated residual, GEMM+AR (or the
plain sums in ``"xla"``) for the row-parallel products, and the pools
hold every rank's KV heads. The resilience knobs (``fallback``,
``probe``, ``timeout_s``), tensor-parallel experts or a flat EP over an
``(outer, inner)`` axis and an ``ep`` axis of its own (queue A item 5),
and MoE, EP and an ``(outer, inner)`` axis on the paged serving lanes at
tp > 1 (queue A item 8) are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from triton_dist_tpu_torch.layers.ep_moe import DECODE_TRANSPORTS
from triton_dist_tpu_torch.layers.tp_attn import _head_split, check_mode
from triton_dist_tpu_torch.models import dense, qwen_moe
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.kv_cache import KVCache
from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.ops.ep_a2a import (create_ep2d_context,
                                              create_ep_context)
from triton_dist_tpu_torch.parallel.mesh import make_mesh
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.device import resolve_device


class Engine:
    """One model on one device, at one rank or at the ranks of ``mesh``'s
    ``axis``.

    ``model``: the model module, :mod:`~triton_dist_tpu_torch.models.dense`
    or :mod:`~triton_dist_tpu_torch.models.qwen_moe` (``None``: qwen_moe
    for a MoE config, dense otherwise). ``moe_impl``: a MoE model's
    regime, JAX's knob: ``None`` is ``"tp"`` (tensor-parallel experts);
    ``"ep"`` shards the experts by expert over the mesh's ``tp`` ranks
    (``self.ep_ctx``, JAX's ``EPContext``); any value for a dense model
    raises, as in JAX. The EP knobs, with JAX's checks: ``ep_capacity``
    (None: the drop-free dispatch; C: C rows per (source, destination)
    pair, overflow dropped and counted), ``ep_transport`` (the decode
    transport, one of ``DECODE_TRANSPORTS``, ``self.ep_transport``; None is
    ``"ar"``), ``ep_axis`` (None or ``"tp"``; over an ``(outer, inner)``
    ``axis`` the same pair, which builds JAX's ``EP2DContext``: drop-free,
    so ``ep_capacity`` stays None). ``params``: the model's weights
    (:class:`~triton_dist_tpu_torch.models.dense.DenseLM` or
    :class:`~triton_dist_tpu_torch.models.qwen_moe.MoELM`) on ``device``
    in ``dtype`` (for example from
    :func:`~triton_dist_tpu_torch.models.convert.from_jax_params`), or
    ``None`` to draw random weights on the device from a
    ``torch.Generator`` seeded with ``seed``. ``mode``: ``"xla"``,
    ``"fused"`` or ``"fused_ar"``; ``block_m``: the MoE row tile of the
    fused expert layout (capped per prefill by ``suggested_block_m``).

    ``mesh``: a :class:`~triton_dist_tpu_torch.parallel.mesh.MeshContext`
    (``make_mesh(tp=n)``); ``None`` is one rank. ``axis``: the mesh axis
    the model shards over, JAX's knob: ``"tp"``, or an ``(outer, inner)``
    tuple such as ``("dp", "tp")`` (a MoE model over it runs expert
    parallel over the same pair); it must span every rank of the mesh
    (data-parallel replicas are not ported). ``self.tp`` is its
    size. At tp > 1 the engine runs
    on the mesh's device (``device`` may name it again), and
    ``block_m``/``block_n``/``block_k`` are the JAX contexts' block knobs
    (:func:`~triton_dist_tpu_torch.models.dense.make_fwd_contexts`: the
    kernels keep their divisibility contract and pick their own tiles;
    ``block_m`` is also the MoE row tile, ``ctxs.ag.block_m`` as in JAX).
    The weights are not copied: each rank's shard is a view of the one
    full weight (for Qwen3-30B-A3B, 61.1 GB in bf16, a copy would not
    fit)."""

    def __init__(self, cfg: ModelConfig, *, mesh=None, axis="tp",
                 mode: str = "xla",
                 model=None, device=None, dtype: torch.dtype = torch.bfloat16,
                 max_len: int = 512, params: Optional[dense.DenseLM] = None,
                 seed: int = 0, block_m: int = 256, block_n: int = 256,
                 block_k: int = 512, moe_impl: Optional[str] = None,
                 ep_capacity: Optional[int] = None,
                 ep_transport: Optional[str] = None, ep_axis=None):
        check_mode(mode)
        self.mesh = mesh
        self.axis = tuple(axis) if isinstance(axis, (tuple, list)) else axis
        if mesh is not None:
            if mesh.size("pp") > 1:
                # As in JAX, no Engine path runs a pipeline.
                raise ValueError(
                    "an Engine does not run over a mesh with pp > 1: "
                    "pipeline parallelism is the layer layers.pp_comm "
                    "(gpipe_forward, pipeline_forward) over a stage "
                    "function of the caller's")
            if mesh.size("sp") > 1:
                # As in JAX, no Engine path shards the sequence.
                raise ValueError(
                    "an Engine does not run over a mesh with sp > 1: "
                    "sequence parallelism is the layer layers.ulysses_sp "
                    "and the op ops.sp_ag_attention; its decode form "
                    "(layers.sp_flash_decode) is ROADMAP.md queue A item 6")
            tp_gemm.check_axis("Engine", mesh, self.axis)
        self.tp = 1 if mesh is None else mesh.size(self.axis)
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device={device!r} is not the mesh's "
                                 f"device {mesh.device}")
            device = mesh.device
        if model is None:
            model = qwen_moe if cfg.is_moe else dense
        if model is qwen_moe:
            if not cfg.is_moe:
                raise ValueError("model=qwen_moe needs a MoE config "
                                 "(num_experts > 0)")
        elif model is dense:
            if cfg.is_moe:
                raise ValueError(
                    f"the dense model takes a dense config (got "
                    f"num_experts={cfg.num_experts}); use model=qwen_moe")
        else:
            raise ValueError(f"model {model!r}: the port serves "
                             "models.dense and models.qwen_moe")
        # JAX's regime knob: a MoE model defaults to tensor-parallel
        # experts, the one regime ported; a dense model takes none.
        if model is qwen_moe:
            moe_impl = moe_impl or "tp"
            if moe_impl not in ("tp", "ep"):
                raise ValueError(f"unknown moe_impl {moe_impl!r} (one of "
                                 "('tp', 'ep'))")
            if ep_transport is not None:
                if ep_transport not in DECODE_TRANSPORTS:
                    raise ValueError(f"ep_transport={ep_transport!r} not in "
                                     f"{DECODE_TRANSPORTS}")
                if moe_impl != "ep":
                    raise ValueError(
                        "ep_transport is an EP decode knob; it needs "
                        f"moe_impl='ep' (got {moe_impl!r})")
            if isinstance(ep_axis, (tuple, list)):
                ep_axis = tuple(ep_axis)
                if ep_axis != self.axis:
                    raise ValueError(
                        f"ep_axis={ep_axis}: the hierarchical EP dispatch "
                        "shards the experts over the engine's own (outer, "
                        f"inner) axis (axis={self.axis!r})")
                if ep_capacity is not None:
                    raise ValueError(
                        "ep_capacity caps the flat EP dispatch; the "
                        "hierarchical one (a tuple ep_axis) is drop-free")
            elif ep_axis not in (None, "tp"):
                raise ValueError(
                    f"ep_axis={ep_axis!r}: the port's experts shard over "
                    "the mesh's tp ranks (None or 'tp'); a mesh with an ep "
                    "axis of its own is ROADMAP.md queue A item 5")
            if isinstance(self.axis, tuple) and not (
                    moe_impl == "ep" and ep_axis == self.axis):
                raise ValueError(
                    f"axis={self.axis}: a MoE model over an (outer, inner) "
                    f"mesh runs moe_impl='ep' with ep_axis={self.axis}; "
                    "tensor-parallel experts or a flat EP over the pair are "
                    "ROADMAP.md queue A item 5")
        elif moe_impl is not None:
            raise ValueError(
                f"moe_impl={moe_impl!r} given, but model "
                f"{getattr(model, '__name__', model)!r} is not a MoE "
                "model (its param_specs takes no moe_impl)")
        if self.tp > 1:
            _head_split(cfg, self.tp)
            ffn = (("moe_intermediate_size", cfg.moe_intermediate_size)
                   if model is qwen_moe
                   else ("intermediate_size", cfg.intermediate_size))
            for name, size in (("vocab_size", cfg.vocab_size), ffn):
                if size % self.tp:
                    raise ValueError(f"{name}={size} not divisible by "
                                     f"tp={self.tp}")
        self.model = model
        self.mode = mode
        self.moe_impl = moe_impl
        self.device = resolve_device(device)
        if self.tp > 1:
            ctxs = dense.make_fwd_contexts(mesh, self.axis, block_m, block_n,
                                           block_k)
            self._prefill_kw = {"mesh": mesh, "ctxs": ctxs,
                                "axis": self.axis}
            self._decode_kw = dict(self._prefill_kw)
        else:
            # The fused expert layout's row tile: only the MoE prefill
            # reads it.
            self._prefill_kw = (
                {"ctxs": dense.FwdContexts(block_m=block_m)}
                if model is qwen_moe else {})
            self._decode_kw = {}
        # JAX's EPContext over the tp axis (one rank without a mesh), or
        # its EP2DContext over the (outer, inner) pair.
        self.ep_ctx = None
        self.ep_transport = ep_transport if moe_impl == "ep" else None
        if moe_impl == "ep":
            if isinstance(self.axis, tuple):
                self.ep_ctx = create_ep2d_context(
                    mesh, num_experts=cfg.num_experts,
                    topk=cfg.num_experts_per_tok, outer_axis=self.axis[0],
                    inner_axis=self.axis[1])
            else:
                self.ep_ctx = create_ep_context(
                    mesh if mesh is not None
                    else make_mesh(device=self.device),
                    num_experts=cfg.num_experts,
                    topk=cfg.num_experts_per_tok, capacity=ep_capacity,
                    axis="tp")
            ep_kw = {"moe_impl": "ep", "ep_ctx": self.ep_ctx}
            self._prefill_kw.update(ep_kw)
            self._decode_kw.update(ep_kw, transport=ep_transport)
        self.cfg = cfg
        self.dtype = dtype
        self.max_len = max_len
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = model.init_params(cfg, generator=gen,
                                       device=self.device, dtype=dtype)
        else:
            w = params.embed
            if w.device != self.device or w.dtype != dtype:
                raise ValueError(
                    f"params are {w.dtype} on {w.device}; the engine was "
                    f"asked for {dtype} on {self.device}")
        self.params = params.eval()

    def _ids(self, ids) -> torch.Tensor:
        if not isinstance(ids, torch.Tensor):
            ids = torch.as_tensor(np.asarray(ids))
        return ids.to(self.device).long()

    def _check_comm(self) -> None:
        """At tp > 1 on the card: wait for the device, then raise
        :class:`~triton_dist_tpu_torch.shmem.workspace.CommTimeoutError`
        if a fused op's wait timed out (the call's logits would be
        wrong)."""
        if self.tp > 1 and self.device.type == "cuda":
            shmem.check_errors(self.device, sync=True)

    @torch.no_grad()
    def prefill(self, input_ids):
        """(B, S) token ids → ``(logits (B, vocab) fp32 of the last
        position, KVCache)``, the cache ``max_len`` long. At tp > 1 on the
        card it returns once the device has finished, and raises
        ``CommTimeoutError`` if one of its fused ops' waits timed out."""
        out = self.model.prefill(self.params, self._ids(input_ids),
                                 self.cfg, mode=self.mode,
                                 max_len=self.max_len, **self._prefill_kw)
        self._check_comm()
        return out

    @torch.no_grad()
    def decode(self, tokens, cache: KVCache):
        """One decode step: tokens (B,) → ``(logits (B, vocab), cache)``,
        the cache written in place. Raises ``ValueError`` once the cache
        holds ``max_len`` tokens (its length is a host int: no sync). At
        tp > 1 on the card it checks its fused ops as :meth:`prefill`
        does."""
        if cache.length >= self.max_len:
            raise ValueError(
                f"KV cache full ({self.max_len}); cannot decode further")
        out = self.model.decode_step(self.params, self._ids(tokens), cache,
                                     self.cfg, mode=self.mode,
                                     **self._decode_kw)
        self._check_comm()
        return out

    def serve(self, input_ids, gen_len: int = 32, *,
              temperature: float = 0.0, top_k: int = 0,
              seed: int = 0) -> torch.Tensor:
        """Token generation: (B, S) ids → (B, gen_len) int32 tokens on the
        device. ``temperature`` 0 is greedy (the first maximum); above 0
        samples from the softmax at that temperature, truncated to the
        ``top_k`` most likely tokens when ``top_k > 0``, from a
        ``torch.Generator`` seeded by (seed, step) as the server's
        sampler: the samples do not reproduce JAX's ``jax.random``
        bits. At tp > 1 on the card a timed-out wait raises from the
        prefill or decode step it happened in."""
        ids = self._ids(input_ids)
        s = ids.shape[1]
        if s + gen_len > self.max_len:
            raise ValueError(
                f"sequence {s}+{gen_len} exceeds max_len={self.max_len}")
        if top_k < 0 or top_k > self.cfg.vocab_size:
            raise ValueError(f"top_k={top_k} outside [0, vocab="
                             f"{self.cfg.vocab_size}]")
        from triton_dist_tpu_torch.serving.server import sample_seed

        def pick(logits, step):
            if temperature <= 0.0:
                return torch.argmax(logits, dim=-1).to(torch.int32)
            lg = logits.float() / temperature
            if top_k > 0:
                kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
                lg = lg.masked_fill(lg < kth, float("-inf"))
            gen = torch.Generator(device=lg.device).manual_seed(
                sample_seed(seed, step))
            return torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                     generator=gen)[:, 0].to(torch.int32)

        logits, cache = self.prefill(ids)
        out = [pick(logits, 0)]
        for i in range(gen_len - 1):
            logits, cache = self.decode(out[-1], cache)
            out.append(pick(logits, i + 1))
        return torch.stack(out, dim=1)

    @property
    def paged_kw(self) -> dict:
        """What the model's paged steps take besides their operands: the
        mode, mesh, contexts and axis at tp > 1; nothing at one rank."""
        if self.tp == 1:
            return {}
        return dict(self._decode_kw, mode=self.mode)

    def serving(self, **kw):
        """Wrap this engine in a continuous-batching
        :class:`~triton_dist_tpu_torch.serving.server.ServingEngine`
        (paged KV pool, request queue, streaming). Keyword args pass
        through (num_slots, page, prefill_buckets, ...). At tp > 1 a dense
        model over one mesh axis; MoE there, the expert-parallel regime
        and an ``(outer, inner)`` axis are ROADMAP.md queue A item 8."""
        if self.moe_impl == "ep":
            raise ValueError(
                "serving() with moe_impl='ep': the paged serving lanes run "
                "the tensor-parallel experts (the server's EP knobs are "
                "ROADMAP.md queue A item 8)")
        if self.tp > 1 and (self.cfg.is_moe or isinstance(self.axis, tuple)):
            raise ValueError(
                "serving() at tp > 1 takes a dense model over one mesh axis; "
                "Qwen3-MoE and an (outer, inner) axis on the paged serving "
                "lanes are ROADMAP.md queue A item 8")
        from triton_dist_tpu_torch.serving.server import ServingEngine

        return ServingEngine(self, **kw)
