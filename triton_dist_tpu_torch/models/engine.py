"""Inference engine (counterpart of ``triton_dist_tpu/models/engine.py``).

The engine carries the configuration, the model (dense Qwen3 or
Qwen3-MoE) and its weights, and hands them to the continuous-batching
server (:meth:`Engine.serving`). The dense-cache
``prefill``/``decode``/``serve`` loop and the fused tensor-parallel modes
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from triton_dist_tpu_torch.models import dense, qwen_moe
from triton_dist_tpu_torch.models.config import ModelConfig


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when CUDA is asked for and absent:
    only an explicit ``"cpu"`` runs the plain versions on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by "
                "default; pass device='cpu' to run the plain versions on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Engine:
    """One model on one device.

    ``model``: the model module, :mod:`~triton_dist_tpu_torch.models.dense`
    or :mod:`~triton_dist_tpu_torch.models.qwen_moe` (``None``: qwen_moe
    for a MoE config, dense otherwise); a MoE model runs its experts in
    the tensor-parallel regime at one rank, the only one ported (the
    expert-parallel one is ROADMAP.md queue A item 5). ``params``: the model's weights
    (:class:`~triton_dist_tpu_torch.models.dense.DenseLM` or
    :class:`~triton_dist_tpu_torch.models.qwen_moe.MoELM`) on ``device``
    in ``dtype`` (for example from
    :func:`~triton_dist_tpu_torch.models.convert.from_jax_params`), or
    ``None`` to draw random weights on the device from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig, *, model=None, device=None,
                 dtype: torch.dtype = torch.bfloat16, max_len: int = 512,
                 params: Optional[dense.DenseLM] = None, seed: int = 0):
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
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
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

    def serving(self, **kw):
        """Wrap this engine in a continuous-batching
        :class:`~triton_dist_tpu_torch.serving.server.ServingEngine`
        (paged KV pool, request queue, streaming). Keyword args pass
        through (num_slots, page, prefill_buckets, ...)."""
        from triton_dist_tpu_torch.serving.server import ServingEngine

        return ServingEngine(self, **kw)
