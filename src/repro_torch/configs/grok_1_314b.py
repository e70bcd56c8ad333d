"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1].

64 layers, d_model 6144, 48 heads GQA kv=8 (head_dim 128), per-expert
FFN 32768, 8 experts top-2, vocab 131072.
The same full and reduced entries as ``repro.configs.grok_1_314b``.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="grok-1-314b",
        arch_type="moe",
        num_layers=64,
        d_model=6144,
        vocab_size=131_072,
        block_pattern=(("attn", "moe"),),
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=0,
        activation="gelu",
        gated=True,
        num_experts=8,
        experts_per_token=2,
        moe_d_ff=32768,
        norm="rmsnorm",
        source="hf:xai-org/grok-1",
    ),
    ArchConfig(
        name="grok-1-314b",
        arch_type="moe",
        num_layers=2,
        d_model=128,
        vocab_size=512,
        block_pattern=(("attn", "moe"),),
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=0,
        activation="gelu",
        gated=True,
        num_experts=4,
        experts_per_token=2,
        moe_d_ff=256,
        norm="rmsnorm",
        source="reduced",
    ),
)
