"""recurrentgemma-9b — RG-LRU + local attention, 2:1 [arXiv:2402.19427].

Griffin-style hybrid: repeating (recurrent, recurrent, local-attention)
blocks, 38 layers, d_model 4096, 16 heads MQA (kv=1) of head_dim 256, GeGLU
d_ff 12288, local attention window 2048, rnn width 4096, vocab 256,000 with
an untied ``lm_head``. The same full and reduced entries as
``repro.configs.recurrentgemma_9b``.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="recurrentgemma-9b",
        arch_type="hybrid",
        num_layers=38,
        d_model=4096,
        vocab_size=256_000,
        block_pattern=(("rglru", "mlp"), ("rglru", "mlp"), ("attn_window", "mlp")),
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        window=2048,
        d_ff=12288,
        activation="gelu",
        gated=True,
        rnn_width=4096,
        rnn_conv=4,
        norm="rmsnorm",
        source="arXiv:2402.19427 (RecurrentGemma / Griffin)",
    ),
    ArchConfig(
        name="recurrentgemma-9b",
        arch_type="hybrid",
        num_layers=3,
        d_model=256,
        vocab_size=512,
        block_pattern=(("rglru", "mlp"), ("rglru", "mlp"), ("attn_window", "mlp")),
        num_heads=4,
        num_kv_heads=1,
        head_dim=64,
        window=64,
        d_ff=512,
        activation="gelu",
        gated=True,
        rnn_width=256,
        rnn_conv=4,
        norm="rmsnorm",
        source="reduced",
    ),
)
