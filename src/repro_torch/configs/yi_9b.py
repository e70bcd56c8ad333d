"""yi-9b — llama-architecture dense GQA [arXiv:2403.04652].

48 layers, d_model 4096, 32 heads GQA kv=4 (head_dim 128), SwiGLU d_ff 11008,
vocab 64000.
The same full and reduced entries as ``repro.configs.yi_9b``.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="yi-9b",
        arch_type="dense",
        num_layers=48,
        d_model=4096,
        vocab_size=64_000,
        block_pattern=(("attn", "mlp"),),
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        activation="silu",
        gated=True,
        norm="rmsnorm",
        source="arXiv:2403.04652 (Yi-9B)",
    ),
    ArchConfig(
        name="yi-9b",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        vocab_size=512,
        block_pattern=(("attn", "mlp"),),
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        activation="silu",
        gated=True,
        norm="rmsnorm",
        source="reduced",
    ),
)
