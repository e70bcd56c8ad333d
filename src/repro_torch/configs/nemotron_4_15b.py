"""nemotron-4-15b — GQA + squared-ReLU MLP [arXiv:2402.16819].

32 layers, d_model 6144, 48 heads GQA kv=8 (head_dim 128), non-gated
squared-ReLU d_ff 24576, vocab 256000, layernorm.
The same full and reduced entries as ``repro.configs.nemotron_4_15b``.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="nemotron-4-15b",
        arch_type="dense",
        num_layers=32,
        d_model=6144,
        vocab_size=256_000,
        block_pattern=(("attn", "mlp"),),
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        activation="relu2",
        gated=False,
        norm="layernorm",
        source="arXiv:2402.16819 (Nemotron-4 15B)",
    ),
    ArchConfig(
        name="nemotron-4-15b",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        vocab_size=512,
        block_pattern=(("attn", "mlp"),),
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        activation="relu2",
        gated=False,
        norm="layernorm",
        source="reduced",
    ),
)
