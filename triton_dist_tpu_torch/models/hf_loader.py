"""HuggingFace checkpoint loading (counterpart of
``triton_dist_tpu/models/hf_loader.py``: ``params_from_hf_state_dict``,
``moe_params_from_hf_state_dict``, ``config_from_hf`` and
``load_hf_checkpoint``).

Nothing is downloaded: :func:`load_hf_checkpoint` reads a local snapshot
directory (``config.json`` and ``*.safetensors`` shards). The shards are
read by :func:`read_safetensors`, a small reader of the format (an 8-byte
little-endian header length, a JSON header of dtype, shape and byte
offsets per tensor, then the raw bytes), so neither ``safetensors`` nor
``transformers`` is needed.

HF stores every linear weight ``(out_features, in_features)``, the port's
layout, so weights carry over untransposed (the JAX mapper transposes to
its ``(in, out)``); each MoE layer's experts stack to ``(E, out, in)``.
Dense Qwen3 and Qwen3-MoE are ported; hybrid GDN (Qwen3-Next) configs
raise in :meth:`~triton_dist_tpu_torch.models.config.ModelConfig.
from_hf_config`.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from typing import Dict

import torch

from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.dense import DenseLM
from triton_dist_tpu_torch.models.engine import resolve_device
from triton_dist_tpu_torch.models.qwen_moe import MoELM

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors (each a
    copy, so the file is closed on return)."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) as buf:
            base = 8 + n
            for name, meta in header.items():
                if name == "__metadata__":
                    continue
                if meta["dtype"] not in _DTYPES:
                    raise ValueError(f"{path}: tensor {name!r} has dtype "
                                     f"{meta['dtype']}, not read here")
                dtype = _DTYPES[meta["dtype"]]
                start, end = meta["data_offsets"]
                count = (end - start) // dtype.itemsize
                t = torch.frombuffer(buf, dtype=dtype, count=count,
                                     offset=base + start) if count else \
                    torch.empty(0, dtype=dtype)
                out[name] = t.reshape(meta["shape"]).clone()
                del t
    return out


def _attn_from_hf(layer, state: Dict, prefix: str) -> None:
    a = layer.attn
    for name, key in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                      ("wo", "o_proj")):
        getattr(a, name).copy_(state[f"{prefix}self_attn.{key}.weight"])
    a.q_norm.copy_(state[prefix + "self_attn.q_norm.weight"])
    a.k_norm.copy_(state[prefix + "self_attn.k_norm.weight"])
    layer.ln_attn.copy_(state[prefix + "input_layernorm.weight"])
    layer.ln_mlp.copy_(state[prefix + "post_attention_layernorm.weight"])


def _head_from_hf(model, state: Dict, cfg: ModelConfig) -> None:
    model.embed.copy_(state["model.embed_tokens.weight"])
    if not cfg.tie_word_embeddings:
        model.lm_head.copy_(state["lm_head.weight"])
    model.ln_f.copy_(state["model.norm.weight"])


def params_from_hf_state_dict(state: Dict, cfg: ModelConfig,
                              dtype: torch.dtype = torch.bfloat16,
                              device=None) -> DenseLM:
    """Map a dense Qwen3 HF state dict (CPU tensors by key) to a
    :class:`DenseLM` in ``dtype`` on ``device`` (``None``: the card, as
    every entry point; ``"cpu"`` asks for the CPU)."""
    model = DenseLM.empty(cfg, device=resolve_device(device), dtype=dtype)
    with torch.no_grad():
        _head_from_hf(model, state, cfg)
        for i, layer in enumerate(model.layers):
            p = f"model.layers.{i}."
            _attn_from_hf(layer, state, p)
            for name, key in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                              ("w_down", "down_proj")):
                getattr(layer.mlp, name).copy_(state[f"{p}mlp.{key}.weight"])
    return model.eval()


def moe_params_from_hf_state_dict(state: Dict, cfg: ModelConfig,
                                  dtype: torch.dtype = torch.bfloat16,
                                  device=None) -> MoELM:
    """Map a Qwen3-MoE HF state dict to a :class:`MoELM` on ``device``
    (as :func:`params_from_hf_state_dict`): router ``mlp.gate``, every
    expert's ``mlp.experts.N.{gate,up,down}_proj`` stacked to
    (E, out, in)."""
    model = MoELM.empty(cfg, device=resolve_device(device), dtype=dtype)
    with torch.no_grad():
        _head_from_hf(model, state, cfg)
        for i, layer in enumerate(model.layers):
            p = f"model.layers.{i}."
            _attn_from_hf(layer, state, p)
            m = layer.moe
            m.router.copy_(state[p + "mlp.gate.weight"])
            for name, key in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                              ("w_down", "down_proj")):
                w = getattr(m, name)
                for e in range(cfg.num_experts):
                    w[e].copy_(state[f"{p}mlp.experts.{e}.{key}.weight"])
    return model.eval()


def config_from_hf(hf: Dict) -> ModelConfig:
    """Alias of :meth:`ModelConfig.from_hf_config`."""
    return ModelConfig.from_hf_config(hf)


def load_hf_checkpoint(path: str, dtype: torch.dtype = torch.bfloat16,
                       device=None):
    """Load a LOCAL HuggingFace checkpoint directory (``config.json`` +
    ``*.safetensors`` shards) → ``(ModelConfig, params)``, the params a
    :class:`DenseLM` (or :class:`MoELM` when ``num_experts > 0``) in
    ``dtype`` on ``device`` (``None``: the card, as every entry point)."""
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    state: Dict[str, torch.Tensor] = {}
    for shard in shards:
        state.update(read_safetensors(shard))
    mapper = (moe_params_from_hf_state_dict if cfg.is_moe
              else params_from_hf_state_dict)
    return cfg, mapper(state, cfg, dtype, device)
