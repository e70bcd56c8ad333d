"""internvl2-1b — InternViT + Qwen2-0.5B language decoder [arXiv:2404.16821].

VLM: the vision tower (InternViT-300M) + MLP projector are STUBBED:
``data.pipeline.make_batch`` provides projected patch embeddings of shape
(batch, num_patches, d_model). We implement the language decoder backbone:
24 layers, d_model 896, 14 heads GQA kv=2, d_ff 4864, vocab 151655.
The same full and reduced entries as ``repro.configs.internvl2_1b``.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="internvl2-1b",
        arch_type="vlm",
        num_layers=24,
        d_model=896,
        vocab_size=151_655,
        block_pattern=(("attn", "mlp"),),
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        activation="silu",
        gated=True,
        norm="rmsnorm",
        frontend="vision",
        num_patches=256,
        source="arXiv:2404.16821 (InternVL2-1B: InternViT + InternLM2/Qwen2)",
    ),
    ArchConfig(
        name="internvl2-1b",
        arch_type="vlm",
        num_layers=2,
        d_model=128,
        vocab_size=512,
        block_pattern=(("attn", "mlp"),),
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        activation="silu",
        gated=True,
        norm="rmsnorm",
        frontend="vision",
        num_patches=16,
        source="reduced",
    ),
)
