"""Phi-3 Medium 14B — dense GQA decoder (RoPE, SwiGLU).

[arXiv:2404.14219] 40 layers, d_model 5120, 40 heads (GQA kv=10, head_dim
128), d_ff 17920 (SwiGLU), vocab 100352.
The same fields as the reference's config.
"""

from repro_torch.configs.base import ArchConfig, register

PHI3_MEDIUM_14B = register(
    ArchConfig(
        name="phi3-medium-14b",
        arch_type="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab_size=100352,
        tie_embeddings=False,
        citation="arXiv:2404.14219 (RoPE SwiGLU GQA)",
    )
)
