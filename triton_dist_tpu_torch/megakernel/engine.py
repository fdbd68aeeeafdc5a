"""Megakernel inference engine: greedy decode where every step is ONE
launch of the persistent kernel (counterpart of
``triton_dist_tpu/megakernel/engine.py``, without a mesh: one card).

The whole step runs inside the kernel: the embedding gather, the norms,
the projections, rope, decode attention over the KV cache, SwiGLU and the
LM head — token ids in, logits out.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from triton_dist_tpu_torch.megakernel.builder import ModelBuilder
from triton_dist_tpu_torch.models import dense
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.engine import resolve_device


class MegaKernelEngine:
    """``params``: a :class:`~triton_dist_tpu_torch.models.dense.DenseLM`
    (for example from :func:`~triton_dist_tpu_torch.models.convert.
    from_jax_params`), or ``None`` for random weights drawn on the device
    from a ``torch.Generator`` seeded with ``seed``. The weights are
    packed into the arena in ``dtype`` (bf16 on the card, which is what
    the CUDA kernel takes; fp32 for the plain version on the CPU) and the
    model is dropped unless ``keep_params``.

    ``paged=True`` keeps the KV cache as page pools (layers, num_pages,
    page, kv, hd) read through :attr:`block_table` (a serving layer
    installs its allocator's table per step); ``paged=False`` keeps one
    (max_len,) row per batch slot. ``device=None`` means the card."""

    def __init__(self, cfg: ModelConfig, *, batch: int, max_len: int = 512,
                 tile_w: Optional[int] = None, t_tile: Optional[int] = None,
                 paged: bool = False, page: Optional[int] = None,
                 num_pages: Optional[int] = None, schedule: str = "static",
                 strategy: str = "round_robin",
                 params: Optional[dense.DenseLM] = None, seed: int = 0,
                 device=None, dtype: torch.dtype = torch.bfloat16,
                 keep_params: bool = False):
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.paged = paged
        self.device = resolve_device(device)
        self.dtype = dtype
        self.steps_done = 0
        t_tile = t_tile or min(128, max_len)
        self.builder = ModelBuilder(cfg, batch=batch, max_len=max_len,
                                    tile_w=tile_w, t_tile=t_tile,
                                    schedule=schedule, strategy=strategy,
                                    paged=paged, page=page)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = dense.init_params(cfg, generator=gen,
                                       device=self.device, dtype=dtype)
        self._arena = self.builder.pack_arena(params, dtype=dtype,
                                              device=self.device)
        self.params = params if keep_params else None

        kv, hd, L = cfg.num_key_value_heads, cfg.head_dim, \
            cfg.num_hidden_layers
        if paged:
            p_max = self.builder.p_max
            self.num_pages = num_pages or batch * p_max
            if self.num_pages < batch * p_max:
                raise ValueError(
                    f"num_pages {self.num_pages} < batch*p_max "
                    f"{batch * p_max} (identity table needs one page per "
                    "(batch, page index))")
            shape = (L, self.num_pages, self.builder.page, kv, hd)
            self.block_table = np.arange(batch * p_max, dtype=np.int32)
        else:
            self.num_pages = None
            shape = (L, batch, max_len, kv, hd)
            self.block_table = None
        self.k_cache = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_cache = torch.zeros(shape, dtype=dtype, device=self.device)
        sch = self.builder.schema
        sch.add_buffer("k_cache", shape, str(dtype).replace("torch.", ""),
                       kind="kv")
        sch.add_buffer("v_cache", shape, str(dtype).replace("torch.", ""),
                       kind="kv")

    @property
    def arena(self) -> torch.Tensor:
        return self._arena

    def decode_step(self, token_ids, cache_len) -> torch.Tensor:
        """token_ids (B,) -> fp32 logits (B, vocab) on the engine's device.
        ``cache_len``: a scalar (uniform batch) or a (B,) vector of
        per-slot positions: each row appends and attends at its own
        length, so a continuous-batching server drives slots of different
        ages through one launch."""
        logits = self.builder.step(self._arena, self.k_cache, self.v_cache,
                                   token_ids, cache_len, self.block_table)
        self.steps_done += 1
        return logits

    def prefill_chain(self, prompt_ids):
        """Feed a (B, S) prompt token by token; returns the last column
        to seed :meth:`generate` with ``start_pos=S-1``."""
        prompt = np.asarray(prompt_ids, np.int32)
        for pos in range(prompt.shape[1] - 1):
            self.decode_step(prompt[:, pos], pos)
        return prompt[:, -1]

    def generate(self, first_tokens, steps: int, *,
                 start_pos: int = 0) -> torch.Tensor:
        """Greedy chain from (B,) seed tokens at cache position
        ``start_pos``; returns (B, steps) int32 on the engine's device."""
        tok = torch.as_tensor(np.asarray(first_tokens, np.int32))
        out = []
        for i in range(steps):
            logits = self.decode_step(tok, start_pos + i)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
        return torch.stack(out, dim=1)
