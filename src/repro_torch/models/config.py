"""Architecture configuration: one dataclass drives the model.

A copy of ``repro.models.config`` (the port imports nothing from ``repro``).
A model is a stack of blocks; each block is (mixer, ffn). The port runs
``("attn", "mlp")`` (decoders and the bidirectional encoder, ``causal=False``),
``("attn", "moe")``, ``("attn_window", "mlp")``, ``("rglru", "mlp")`` and
``("ssd", None)`` blocks; the other kinds stay in the schema so configs keep
their reference shape. ``param_count`` is the reference's formula as it
stands (2L + 1 norms whatever the block kinds, no SSD ``conv_b``/
``norm_scale`` and no RG-LRU ``conv_b``), so the planner's figures match the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

MIXERS = ("attn", "attn_window", "ssd", "rglru")
FFNS = ("mlp", "moe", None)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    block_pattern: tuple[tuple[str, Optional[str]], ...]

    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    window: int = 0                      # sliding/local attention window
    rope_theta: float = 10_000.0
    causal: bool = True                  # False => encoder

    # ffn
    d_ff: int = 0
    activation: str = "silu"             # silu | gelu | relu2 (squared ReLU)
    gated: bool = True                   # SwiGLU/GeGLU-style gating

    # norms
    norm: str = "rmsnorm"                # rmsnorm | layernorm | nonparam_ln

    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # ssm (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # rg-lru (RecurrentGemma)
    rnn_width: int = 0
    rnn_conv: int = 4

    # modality frontend
    frontend: str = "none"               # none | vision | audio
    num_patches: int = 256

    tie_embeddings: bool = False

    source: str = ""                     # paper / model-card citation

    def __post_init__(self):
        for mixer, ffn in self.block_pattern:
            if mixer not in MIXERS or ffn not in FFNS:
                raise ValueError(f"unknown block kind {(mixer, ffn)}")
        if self.num_heads and self.head_dim <= 0:
            raise ValueError("attention needs head_dim > 0")
        if any(f == "moe" for _, f in self.block_pattern) and not (
                self.num_experts > 0 and self.experts_per_token > 0):
            raise ValueError("moe blocks need num_experts and experts_per_token")

    @property
    def layer_kinds(self) -> tuple[tuple[str, Optional[str]], ...]:
        """block kind per layer, pattern cycled to num_layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def has_attention(self) -> bool:
        return any(m.startswith("attn") for m, _ in self.block_pattern)

    @property
    def attention_is_quadratic(self) -> bool:
        """True if any attention mixer has an unbounded (full) window."""
        return any(m == "attn" for m, _ in self.block_pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        n = self.vocab_size * self.d_model           # embed
        if not self.tie_embeddings and self.vocab_size:
            n += self.vocab_size * self.d_model      # lm head
        D = self.d_model
        for mixer, ffn in self.layer_kinds:
            if mixer in ("attn", "attn_window"):
                n += D * self.num_heads * self.head_dim          # q
                n += 2 * D * self.num_kv_heads * self.head_dim   # k, v
                n += self.num_heads * self.head_dim * D          # o
            elif mixer == "ssd":
                di, hs = self.d_inner, self.ssm_heads
                n += D * (2 * di + 2 * self.ssm_state + hs)      # in_proj
                n += self.ssm_conv * (di + 2 * self.ssm_state)   # conv
                n += 3 * hs                                      # A, D, dt_bias
                n += di * D                                      # out_proj
            elif mixer == "rglru":
                W = self.rnn_width
                n += D * 2 * W + self.rnn_conv * W + 2 * W * W + W + W * D
            if ffn == "mlp":
                mult = 3 if self.gated else 2
                n += mult * D * self.d_ff
            elif ffn == "moe":
                mult = 3 if self.gated else 2
                n += self.num_experts * mult * D * self.moe_d_ff
                n += D * self.num_experts                        # router
        if self.norm != "nonparam_ln":
            n += (2 * self.num_layers + 1) * D
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.num_experts == 0:
            return self.param_count()
        n = self.param_count()
        mult = 3 if self.gated else 2
        n_moe_layers = sum(1 for _, f in self.layer_kinds if f == "moe")
        full = n_moe_layers * self.num_experts * mult * self.d_model * self.moe_d_ff
        act = n_moe_layers * self.experts_per_token * mult * self.d_model * self.moe_d_ff
        return n - full + act


_REGISTRY: dict[str, ArchConfig] = {}
_REDUCED: dict[str, ArchConfig] = {}


def register(config: ArchConfig, reduced: ArchConfig) -> ArchConfig:
    _REGISTRY[config.name] = config
    _REDUCED[config.name] = reduced
    return config


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    _ensure_loaded()
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    import importlib
    for mod in ("olmo_1b", "mamba2_2_7b", "recurrentgemma_9b", "yi_9b",
                "nemotron_4_15b", "internvl2_1b", "hubert_xlarge",
                "qwen3_moe_30b_a3b", "moonshot_v1_16b_a3b", "grok_1_314b"):
        importlib.import_module(f"repro_torch.configs.{mod}")
