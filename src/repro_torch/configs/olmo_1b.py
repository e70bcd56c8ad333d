"""olmo-1b — non-parametric LayerNorm [arXiv:2402.00838].

16 layers, d_model 2048, 16 heads MHA (kv=16), SwiGLU d_ff 8192,
vocab 50304, non-parametric LayerNorm (no scale/bias), tied embeddings.
The same full and reduced entries as ``repro.configs.olmo_1b``.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="olmo-1b",
        arch_type="dense",
        num_layers=16,
        d_model=2048,
        vocab_size=50_304,
        block_pattern=(("attn", "mlp"),),
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        activation="silu",
        gated=True,
        norm="nonparam_ln",
        tie_embeddings=True,
        source="arXiv:2402.00838 (OLMo-1B)",
    ),
    ArchConfig(
        name="olmo-1b",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        vocab_size=512,
        block_pattern=(("attn", "mlp"),),
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        activation="silu",
        gated=True,
        norm="nonparam_ln",
        tie_embeddings=True,
        source="reduced",
    ),
)
