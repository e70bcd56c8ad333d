"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

MoE decoder: 48 layers, d_model 2048, 32 heads GQA kv=4 (head_dim 128),
per-expert FFN 768, 128 experts, 8 active per token, vocab 151936.
The same full and reduced entries as ``repro.configs.qwen3_moe_30b_a3b``.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen3-moe-30b-a3b",
        arch_type="moe",
        num_layers=48,
        d_model=2048,
        vocab_size=151_936,
        block_pattern=(("attn", "moe"),),
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=0,
        activation="silu",
        gated=True,
        num_experts=128,
        experts_per_token=8,
        moe_d_ff=768,
        norm="rmsnorm",
        source="hf:Qwen/Qwen3-30B-A3B",
    ),
    ArchConfig(
        name="qwen3-moe-30b-a3b",
        arch_type="moe",
        num_layers=2,
        d_model=128,
        vocab_size=512,
        block_pattern=(("attn", "moe"),),
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=0,
        activation="silu",
        gated=True,
        num_experts=4,
        experts_per_token=2,
        moe_d_ff=64,
        norm="rmsnorm",
        source="reduced",
    ),
)
