"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].

Attention-free: 64 pure-SSD blocks, d_model 2560, d_state 128, no FFN
(Mamba-2 folds the MLP into the expanded SSD block, d_inner = 2*d_model).
The same full and reduced entries as ``repro.configs.mamba2_2_7b``.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="mamba2-2.7b",
        arch_type="ssm",
        num_layers=64,
        d_model=2560,
        vocab_size=50280,
        block_pattern=(("ssd", None),),
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=128,
        norm="rmsnorm",
        source="arXiv:2405.21060 (Mamba-2, SSD)",
    ),
    ArchConfig(
        name="mamba2-2.7b",
        arch_type="ssm",
        num_layers=2,
        d_model=256,
        vocab_size=512,
        block_pattern=(("ssd", None),),
        ssm_state=32,
        ssm_head_dim=32,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=32,
        norm="rmsnorm",
        source="reduced",
    ),
)
