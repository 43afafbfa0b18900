"""Zamba2 2.7B — Mamba2 backbone with a single shared attention block.

[arXiv:2411.15242] 54 Mamba2 layers, d_model 2560 (inner 5120, 80 ssm heads
of head_dim 64, state 64), plus one shared transformer block (32 heads,
kv=32 i.e. MHA, head_dim 80, d_ff 10240) whose weights are reused every 6
layers, vocab 32000. The same dimensions as the reference's config.
"""

from repro_torch.configs.base import ArchConfig, register

ZAMBA2_2_7B = register(
    ArchConfig(
        name="zamba2-2.7b",
        arch_type="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm_variant="mamba2",
        ssm_state=64,
        ssm_heads=80,  # inner dim 5120 / head_dim 64
        ssm_head_dim=64,
        hybrid_attn_every=6,
        # The shared attention block decodes over a ring cache of the window.
        sliding_window=4096,
        tie_embeddings=True,
        citation="arXiv:2411.15242 (Mamba2 + shared attn blocks)",
    )
)
