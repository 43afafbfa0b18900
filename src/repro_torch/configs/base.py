"""Architecture configuration schema and registry (the port's own copy).

The same frozen `ArchConfig` as the reference's `repro.configs.base`, field
for field, with the same `reduced()` smoke-test variant, so a config built
here describes the same model as the reference's of the same name. Every
architecture the reference registers is registered here (`REFERENCE_ARCHS`);
`get` of any other name raises `KeyError`.

`expert_share(cfg, shard, shards)` is a MoE config of which one card holds
a share of the experts: experts [shard * E / shards, (shard + 1) * E /
shards) of every MoE layer, the one-card form of the reference's
expert-parallel layout (its buffers' experts axis sharded over the mesh's
'model' axis). It is a subclass, so `ArchConfig`'s fields stay the
reference's; `dataclasses.replace` (a depth cut) keeps the share.
"""

from __future__ import annotations

import dataclasses

# Every arch the reference registers (each registered here too).
REFERENCE_ARCHS = (
    "arctic-480b", "gemma-7b", "gemma2-9b", "gemma2-9b-sw",
    "llama-3.2-vision-90b", "llama4-maverick-400b-a17b", "phi3-medium-14b",
    "qwen2-7b", "rwkv6-1.6b", "whisper-base", "zamba2-2.7b",
)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MLP / attention variants -------------------------------------------
    mlp_variant: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    embed_scale: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0  # 0 = full attention
    attn_pattern: str = "full"
    post_norms: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    # --- MoE -------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_ff: int = 0
    moe_every: int = 1
    moe_dense_layer_ff: int = 0
    router_zloss: float = 1e-3
    load_balance_loss: float = 1e-2
    capacity_factor: float = 1.25

    # --- SSM / hybrid -----------------------------------------------------------
    ssm_variant: str = ""  # rwkv6 | mamba2
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    conv_width: int = 4
    hybrid_attn_every: int = 0

    # --- enc-dec / cross-attention ----------------------------------------------
    encoder_layers: int = 0
    encoder_tokens: int = 0
    cross_attn_every: int = 0
    num_frontend_tokens: int = 0
    max_position: int = 0

    # --- training -----------------------------------------------------------------
    optimizer: str = "adamw"
    grad_accum_dtype: str = "float32"
    microbatch: int = 1
    remat: bool = True

    citation: str = ""

    @property
    def qkv_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_decoder_only(self) -> bool:
        return self.encoder_layers == 0

    @property
    def expert_slice(self) -> tuple[int, int]:
        """The experts [lo, hi) this card holds of each MoE layer: all of
        them (`ExpertShare` holds one shard)."""
        return 0, self.num_experts

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant of the same family (the reference's cut)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=min(self.head_dim, 32),
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token
            else 0,
            moe_dense_ff=min(self.moe_dense_ff, 128) if self.moe_dense_ff else 0,
            moe_dense_layer_ff=min(self.moe_dense_layer_ff, 256)
            if self.moe_dense_layer_ff
            else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32) if self.ssm_head_dim else 0,
            hybrid_attn_every=min(self.hybrid_attn_every, 2)
            if self.hybrid_attn_every
            else 0,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            encoder_tokens=min(self.encoder_tokens, 16) if self.encoder_tokens else 0,
            cross_attn_every=min(self.cross_attn_every, 2)
            if self.cross_attn_every
            else 0,
            num_frontend_tokens=min(self.num_frontend_tokens, 16)
            if self.num_frontend_tokens
            else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            microbatch=1,
        )


@dataclasses.dataclass(frozen=True)
class ExpertShare(ArchConfig):
    """A MoE config of which this card holds shard `expert_shard` of
    `expert_shards` of every MoE layer's experts. The router keeps all
    `num_experts` outputs and `experts_per_token`, and the capacity counts
    all of them; the card computes its own experts' buffers only."""

    expert_shard: int = 0
    expert_shards: int = 1

    def __post_init__(self):
        if (self.expert_shards < 1 or self.num_experts % self.expert_shards
                or not 0 <= self.expert_shard < self.expert_shards):
            raise ValueError(f"{self.name}: expert shard {self.expert_shard} of "
                             f"{self.expert_shards} over {self.num_experts} experts")

    @property
    def expert_slice(self) -> tuple[int, int]:
        per = self.num_experts // self.expert_shards
        return self.expert_shard * per, (self.expert_shard + 1) * per


def expert_share(cfg: ArchConfig, shard: int, shards: int) -> ExpertShare:
    """`cfg` with this card holding shard `shard` of `shards` of the experts
    (`shards` must divide `num_experts`)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ArchConfig)}
    return ExpertShare(**fields, expert_shard=shard, expert_shards=shards)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers every ported arch)
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


def names() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
