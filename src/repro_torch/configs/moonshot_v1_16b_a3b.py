"""moonshot-v1-16b-a3b — Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

DeepSeek-V3-style fine-grained MoE: 48 layers (as assigned), d_model 2048,
16 heads GQA kv=16 (MHA-width KV), per-expert FFN 1408, 64 experts top-6,
vocab 163840. The assignment tags it "[dense] ... MoE?" — the model card is
a MoE; we implement it as MoE (64e/top-6) and note the ambiguity here.
The same full and reduced entries as ``repro.configs.moonshot_v1_16b_a3b``.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="moonshot-v1-16b-a3b",
        arch_type="moe",
        num_layers=48,
        d_model=2048,
        vocab_size=163_840,
        block_pattern=(("attn", "moe"),),
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=0,
        activation="silu",
        gated=True,
        num_experts=64,
        experts_per_token=6,
        moe_d_ff=1408,
        norm="rmsnorm",
        source="hf:moonshotai/Moonlight-16B-A3B",
    ),
    ArchConfig(
        name="moonshot-v1-16b-a3b",
        arch_type="moe",
        num_layers=2,
        d_model=128,
        vocab_size=512,
        block_pattern=(("attn", "moe"),),
        num_heads=4,
        num_kv_heads=4,
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
