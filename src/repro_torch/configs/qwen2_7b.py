"""Qwen2 7B — dense GQA decoder with QKV bias.

[arXiv:2407.10671] 28 layers, d_model 3584, 28 heads (GQA kv=4, head_dim
128), d_ff 18944 (SwiGLU), vocab 152064, QKV projection bias (the Qwen2
signature), rope theta 1e6.
The same fields as the reference's config.
"""

from repro_torch.configs.base import ArchConfig, register

QWEN2_7B = register(
    ArchConfig(
        name="qwen2-7b",
        arch_type="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        citation="arXiv:2407.10671 (GQA, QKV bias)",
    )
)
