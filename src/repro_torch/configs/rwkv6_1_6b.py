"""RWKV6 "Finch" 1.6B — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] Finch: 24 layers, d_model 2048, d_ff 7168 (ReLU² channel
mix in RWKV; we use the configured d_ff with the rwkv channel-mix), vocab
65536, head_dim 64 (32 WKV heads), per-channel data-dependent decay w_t via
a low-rank projection (the defining Finch feature vs. RWKV5's static decay).
The same fields as the reference's config.
"""

from repro_torch.configs.base import ArchConfig, register

RWKV6_1_6B = register(
    ArchConfig(
        name="rwkv6-1.6b",
        arch_type="ssm",
        num_layers=24,
        d_model=2048,
        num_heads=32,  # WKV heads (d_model / 64)
        num_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        ssm_variant="rwkv6",
        ssm_heads=32,
        ssm_head_dim=64,
        mlp_variant="rwkv_channel_mix",
        tie_embeddings=False,
        citation="arXiv:2404.05892 (Finch — data-dependent decay)",
    )
)
