"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447].

The conv waveform feature extractor is STUBBED: ``data.pipeline.make_batch``
provides frame embeddings (batch, frames, d_model). We implement the transformer
encoder: 48 layers, d_model 1280, 16 heads (MHA, kv=16), d_ff 5120 (GELU,
non-gated), bidirectional attention. "vocab" 504 = masked-prediction
codebook targets. Encoder-only: ``model.forward_hidden`` runs it, and
the serving launcher refuses it.
The same full and reduced entries as ``repro.configs.hubert_xlarge``.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="hubert-xlarge",
        arch_type="audio",
        num_layers=48,
        d_model=1280,
        vocab_size=504,
        block_pattern=(("attn", "mlp"),),
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        activation="gelu",
        gated=False,
        causal=False,
        norm="layernorm",
        frontend="audio",
        source="arXiv:2106.07447 (HuBERT X-Large)",
    ),
    ArchConfig(
        name="hubert-xlarge",
        arch_type="audio",
        num_layers=2,
        d_model=256,
        vocab_size=64,
        block_pattern=(("attn", "mlp"),),
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        activation="gelu",
        gated=False,
        causal=False,
        norm="layernorm",
        frontend="audio",
        source="reduced",
    ),
)
