"""Model configuration (counterpart of ``triton_dist_tpu/models/config.py``).

The port serves dense Qwen3 models and the Qwen3-MoE family, so the dense
and the MoE fields are carried over, and :meth:`ModelConfig.from_hf_config`
maps a HuggingFace config onto them; the hybrid-attention (Qwen3-Next)
fields arrive with their slice, and a shared expert (a Qwen3-Next field)
raises until then.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 151936
    hidden_size: int = 4096
    intermediate_size: int = 12288
    num_hidden_layers: int = 36
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 40960
    tie_word_embeddings: bool = False
    model_name: str = "qwen3"
    # MoE fields (0 experts = dense; models/qwen_moe.py).
    num_experts: int = 0
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 768
    norm_topk_prob: bool = True
    # Qwen3-Next's always-on shared expert; not ported (0 = none).
    shared_expert_intermediate_size: int = 0

    def __post_init__(self):
        if self.shared_expert_intermediate_size:
            raise NotImplementedError(
                "shared_expert_intermediate_size > 0 (the Qwen3-Next shared "
                "expert) is not ported yet (ROADMAP.md, queue A item 1.6)")

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def kv_cache_plan(self, *, max_len: int, page: int, num_slots: int,
                      dtype_bytes: int = 2, kv_dtype: str = "bf16") -> dict:
        """Serving pool sizing off the model geometry: pages per
        block-table row, pool pages for full residency (+1 reserved
        scratch page), and the bytes of the K+V pools on the one card
        (the JAX plan's ``*_per_rank`` keys at ``tp=1``).

        ``kv_dtype="int8"|"fp8"`` plans a quantized pool: one byte per
        element plus one fp32 scale per (layer, page, kv_head) per pool;
        ``native_page_bytes_per_rank`` is what the page would cost at
        ``dtype_bytes``, and ``capacity_ratio_vs_native`` the pages per
        byte the quantization buys."""
        if max_len % page:
            raise ValueError(f"page={page} must divide max_len={max_len}")
        from triton_dist_tpu_torch.serving.blocks import kv_quant_spec

        qdtype, _ = kv_quant_spec(kv_dtype)
        kv_loc = self.num_key_value_heads
        p_max = max_len // page
        num_pages = 1 + num_slots * p_max
        native_bytes = (self.num_hidden_layers * kv_loc * page
                        * self.head_dim * dtype_bytes)
        page_bytes = native_bytes if qdtype is None else (
            self.num_hidden_layers * kv_loc * (page * self.head_dim + 4))
        return {
            "page": page, "p_max": p_max, "num_pages": num_pages,
            "kv_heads_loc": kv_loc,
            "kv_dtype": "bf16" if qdtype is None else kv_dtype,
            "page_bytes_per_rank": 2 * page_bytes,      # K and V
            "native_page_bytes_per_rank": 2 * native_bytes,
            "pool_bytes_per_rank": 2 * page_bytes * num_pages,
            "bytes_per_token": 2 * page_bytes / page,
            "capacity_ratio_vs_native": round(native_bytes / page_bytes, 4),
            "tokens_per_page": page,
        }

    @classmethod
    def qwen3_8b(cls) -> "ModelConfig":
        return cls(hidden_size=4096, intermediate_size=12288,
                   num_hidden_layers=36, num_attention_heads=32,
                   num_key_value_heads=8, head_dim=128,
                   model_name="qwen3-8b")

    @classmethod
    def qwen3_32b(cls) -> "ModelConfig":
        return cls(hidden_size=5120, intermediate_size=25600,
                   num_hidden_layers=64, num_attention_heads=64,
                   num_key_value_heads=8, head_dim=128,
                   model_name="qwen3-32b")

    @classmethod
    def qwen3_moe_30b_a3b(cls) -> "ModelConfig":
        """Qwen3-30B-A3B (the JAX package's MoE demo, models/qwen_moe.py)."""
        return cls(hidden_size=2048, intermediate_size=6144,
                   num_hidden_layers=48, num_attention_heads=32,
                   num_key_value_heads=4, head_dim=128,
                   num_experts=128, num_experts_per_tok=8,
                   moe_intermediate_size=768,
                   model_name="qwen3-moe-30b-a3b")

    @classmethod
    def tiny_moe(cls, **kw) -> "ModelConfig":
        """The JAX package's tiny MoE geometry; ``kw`` overrides fields."""
        base = dict(vocab_size=256, hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=8,
                    num_key_value_heads=8, head_dim=8, num_experts=16,
                    num_experts_per_tok=2, moe_intermediate_size=32,
                    model_name="qwen3-moe-tiny")
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_hf_config(cls, hf_cfg) -> "ModelConfig":
        """Build from a transformers config object or a raw
        ``config.json`` dict: the dense and the MoE (Qwen3-MoE) field
        sets, with the JAX mapper's required fields (a missing one raises
        ``KeyError``) and its every-layer MoE schedule check. Projection
        biases (``attention_bias``, the Qwen2 family), models without the
        per-head q/k norm (Qwen2, Seed-OSS, Llama, Mistral) and hybrid
        GDN configs (``linear_num_value_heads``) raise
        ``NotImplementedError``: not ported (ROADMAP.md)."""
        if isinstance(hf_cfg, dict):
            get = lambda k, d=None: hf_cfg.get(k, d)        # noqa: E731
        else:
            get = lambda k, d=None: getattr(hf_cfg, k, d)   # noqa: E731

        def req(k):
            v = get(k)
            if v is None:
                raise KeyError(
                    f"HF config missing required field {k!r} — is this "
                    "a supported config.json?")
            return v

        d = req("hidden_size")
        heads = req("num_attention_heads")
        if get("num_experts", 0):
            if get("decoder_sparse_step", 1) not in (None, 1) or \
                    get("mlp_only_layers"):
                raise NotImplementedError(
                    "only the every-layer MoE schedule is supported "
                    f"(decoder_sparse_step={get('decoder_sparse_step')}"
                    f", mlp_only_layers={get('mlp_only_layers')})")
        model_type = str(get("model_type", "qwen3"))
        if get("linear_num_value_heads", 0):
            raise NotImplementedError(
                "hybrid GDN configs (Qwen3-Next) are not ported yet "
                "(ROADMAP.md, queue A item 6)")
        if get("attention_bias", model_type.startswith("qwen2")):
            raise NotImplementedError(
                "attention_bias=True (q/k/v/o projection biases) is not "
                "ported yet (ROADMAP.md)")
        if model_type.startswith("qwen2") or model_type in (
                "seed_oss", "llama", "mistral"):
            raise NotImplementedError(
                f"model_type {model_type!r} has no per-head q/k norm "
                "(qk_norm=False), which is not ported yet (ROADMAP.md)")
        return cls(
            vocab_size=req("vocab_size"),
            hidden_size=d,
            intermediate_size=get("intermediate_size", 4 * d),
            num_hidden_layers=req("num_hidden_layers"),
            num_attention_heads=heads,
            num_key_value_heads=get("num_key_value_heads", heads),
            head_dim=get("head_dim") or d // heads,
            rms_norm_eps=get("rms_norm_eps", 1e-6),
            rope_theta=get("rope_theta", 1_000_000.0),
            max_position_embeddings=get("max_position_embeddings", 40960),
            tie_word_embeddings=get("tie_word_embeddings", False),
            model_name=get("model_type", "qwen3"),
            num_experts=get("num_experts", 0) or 0,
            num_experts_per_tok=get("num_experts_per_tok", 8) or 8,
            moe_intermediate_size=get("moe_intermediate_size", 768) or 768,
            norm_topk_prob=get("norm_topk_prob", True),
            shared_expert_intermediate_size=get(
                "shared_expert_intermediate_size", 0) or 0,
        )

    @classmethod
    def tiny(cls, *, vocab_size: int = 256, hidden_size: int = 32,
             intermediate_size: int = 64, num_hidden_layers: int = 2,
             num_attention_heads: int = 8, num_key_value_heads: int = 8,
             head_dim: int = 8) -> "ModelConfig":
        """The JAX package's CPU test geometry."""
        return cls(vocab_size=vocab_size, hidden_size=hidden_size,
                   intermediate_size=intermediate_size,
                   num_hidden_layers=num_hidden_layers,
                   num_attention_heads=num_attention_heads,
                   num_key_value_heads=num_key_value_heads,
                   head_dim=head_dim, model_name="qwen3-tiny")
