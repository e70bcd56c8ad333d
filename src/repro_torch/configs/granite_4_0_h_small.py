"""granite-4.0-h-small — hybrid Mamba-2 / NoPE attention with a dropless
MoE after every mixer [hf:ibm-granite/granite-4.0-h-small, config.json,
``model_type: granitemoehybrid``; 32B total, 9B active].

40 layers, d_model 4096, vocab 100,352, tied embeddings, RMSNorm eps 1e-5.
``layer_types`` has a period of 10: five Mamba-2 layers, one attention
layer, four Mamba-2 layers (attention at layers 5, 15, 25, 35). Every layer
then runs an MoE FFN: 72 SwiGLU experts of width 768, top-10, softmax over
the 10 selected router logits, dropless, plus one shared SwiGLU expert of
width 1,536. Mamba-2: 128 heads of 64 (d_inner 8192), state 128, one B/C
group, conv 4 with a bias, chunk 256, a gated RMSNorm over the whole
d_inner. Attention: GQA 32/8 heads of 128 with no positional encoding and
softmax scale ``attention_multiplier`` 1/128. The μP multipliers:
x₀ = 12·embed(tokens); x ← x + 0.22·mixer(norm(x)); x ← x + 0.22·(MoE +
shared)(norm(x)); logits = norm(x)·Eᵀ / 16.

The full entry is the share of one device of four under expert
parallelism 4: it holds experts 0-17 of each MoE layer (``experts_held``)
and routes over all 72; everything else is whole. No JAX counterpart: the
reference package has no such block.
"""
from repro_torch.models.config import ArchConfig, register

_PERIOD = (("ssd", "moe"),) * 5 + (("attn", "moe"),) + (("ssd", "moe"),) * 4

CONFIG = register(
    ArchConfig(
        name="granite-4.0-h-small",
        arch_type="hybrid",
        num_layers=40,
        d_model=4096,
        vocab_size=100_352,
        block_pattern=_PERIOD,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope=False,
        activation="silu",
        gated=True,
        num_experts=72,
        experts_per_token=10,
        moe_d_ff=768,
        capacity_factor=0.0,
        experts_held=18,
        moe_shared_d_ff=1536,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=256,
        norm="rmsnorm",
        rms_norm_eps=1e-5,
        ssm_norm_eps=1e-5,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        attention_multiplier=0.0078125,
        logits_scaling=16.0,
        tie_embeddings=True,
        source="hf:ibm-granite/granite-4.0-h-small (experts 0-17 of 72: "
               "one device's share under expert parallelism 4)",
    ),
    ArchConfig(
        name="granite-4.0-h-small",
        arch_type="hybrid",
        num_layers=4,
        d_model=64,
        vocab_size=256,
        block_pattern=(("ssd", "moe"), ("attn", "moe"), ("ssd", "moe"),
                       ("ssd", "moe")),
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        rope=False,
        activation="silu",
        gated=True,
        num_experts=8,
        experts_per_token=3,
        moe_d_ff=32,
        capacity_factor=0.0,
        moe_shared_d_ff=48,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=16,
        norm="rmsnorm",
        rms_norm_eps=1e-5,
        ssm_norm_eps=1e-5,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        attention_multiplier=1 / 16,
        logits_scaling=16.0,
        tie_embeddings=True,
        source="reduced",
    ),
)
