"""Carry the JAX package's dense weights over to the port.

The JAX package (``triton_dist_tpu/models/dense.py:init_params``) stores
each linear weight as ``(in_features, out_features)`` and multiplies
``x @ w``: ``wq`` is ``(d, H·hd)``, ``wo`` is ``(H·hd, d)``, ``w_gate`` is
``(d, ff)``. The port stores ``(out_features, in_features)`` and calls
``F.linear(x, w)``. :func:`_linear` is the one place that transposes.
``embed`` and ``lm_head`` are ``(vocab, d)`` on both sides, and the JAX
logits are ``x @ lm_head.T``, so they carry over as they are.

The same tensors serve every tp: at ``make_mesh(tp=n)`` rank r's shard of
a column-parallel weight (``wq``/``wk``/``wv``/``w_gate``/``w_up``, and
``lm_head`` by vocabulary rows) is rows ``[r·out/n, (r+1)·out/n)`` and of a
row-parallel one (``wo``/``w_down``) columns ``[r·in/n, (r+1)·in/n)``, as
the JAX ``param_specs`` shard them; both are views of the one tensor
(:mod:`~triton_dist_tpu_torch.ops.tp_gemm`), never a second copy.

For a MoE config the tree is ``qwen_moe.init_params``': each layer holds
``moe`` (``router (d, E)``, ``w_gate``/``w_up (E, d, f)``, ``w_down (E,
f, d)``) in place of ``mlp``; each expert's matrix is transposed the same
way (:func:`_experts`). The expert-parallel regime (``Engine(...,
moe_impl="ep")``) takes the same tree, as JAX's engine does: rank r's
experts ``[r·E/n, (r+1)·E/n)`` are a view of each expert weight
(:func:`~triton_dist_tpu_torch.layers.ep_moe.param_specs`); only the views
differ from the tensor-parallel regime's. JAX's hierarchical engine
(``Engine(..., axis=("dp", "tp"))``) holds the same full arrays, sharded
outer-major over both axes, so its parameters carry over unchanged to
the port's ``axis=("dp", "tp")`` engine, whose rank r = o·n_in + i views
block r of each weight. The tensor-parallel megakernel
(``MegaKernelEngine(mesh=make_mesh(tp=n))``) takes the same tree too:
:meth:`~triton_dist_tpu_torch.megakernel.builder.ModelBuilder.pack_arena`
packs rank r's shards of it (heads, KV heads, MLP columns, vocabulary rows
of the embedding and the LM head; the norms whole) into slice r of an (n,
rows, w) arena, JAX's per-rank arena value for value.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.dense import DenseLM
from triton_dist_tpu_torch.models.qwen_moe import MoELM


def from_jax_params(np_params: dict, cfg: ModelConfig, device,
                    dtype: torch.dtype = torch.float32) -> DenseLM:
    """``np_params``: the JAX ``dense.init_params`` (or, for a MoE
    config, ``qwen_moe.init_params``) pytree with every leaf as a numpy
    array (``jax.tree.map(np.asarray, params)``). Returns the port's
    :class:`DenseLM` (:class:`MoELM`) on ``device`` in ``dtype``."""

    def _tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    def _linear(a) -> torch.Tensor:
        return _tensor(np.asarray(a).T)

    def _experts(a) -> torch.Tensor:
        return _tensor(np.swapaxes(np.asarray(a), 1, 2))

    model = (MoELM if cfg.is_moe else DenseLM).empty(cfg, device=device,
                                                     dtype=dtype)
    if len(np_params["layers"]) != cfg.num_hidden_layers:
        raise ValueError(f"{len(np_params['layers'])} layers in the pytree, "
                         f"{cfg.num_hidden_layers} in the config")
    with torch.no_grad():
        model.embed.copy_(_tensor(np_params["embed"]))
        if not cfg.tie_word_embeddings:
            model.lm_head.copy_(_tensor(np_params["lm_head"]))
        model.ln_f.copy_(_tensor(np_params["ln_f"]))
        for layer, src in zip(model.layers, np_params["layers"]):
            layer.ln_attn.copy_(_tensor(src["ln_attn"]))
            layer.ln_mlp.copy_(_tensor(src["ln_mlp"]))
            a, sa = layer.attn, src["attn"]
            for name in ("wq", "wk", "wv", "wo"):
                getattr(a, name).copy_(_linear(sa[name]))
            a.q_norm.copy_(_tensor(sa["q_norm"]))
            a.k_norm.copy_(_tensor(sa["k_norm"]))
            if cfg.is_moe:
                m, sm = layer.moe, src["moe"]
                m.router.copy_(_linear(sm["router"]))
                for name in ("w_gate", "w_up", "w_down"):
                    getattr(m, name).copy_(_experts(sm[name]))
            else:
                m, sm = layer.mlp, src["mlp"]
                for name in ("w_gate", "w_up", "w_down"):
                    getattr(m, name).copy_(_linear(sm[name]))
    return model
