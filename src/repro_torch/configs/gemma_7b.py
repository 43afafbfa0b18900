"""Gemma 7B — dense MHA decoder with GeGLU and head_dim 256.

[arXiv:2403.08295] 28 layers, d_model 3072, 16 heads with head_dim 256
(q/k/v dim 4096 > d_model), MHA (kv=16; the 2B sibling uses MQA), d_ff
24576 (GeGLU), vocab 256000, embeddings scaled by sqrt(d_model), tied
embeddings.
The same fields as the reference's config.
"""

from repro_torch.configs.base import ArchConfig, register

GEMMA_7B = register(
    ArchConfig(
        name="gemma-7b",
        arch_type="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        mlp_variant="geglu",
        embed_scale=True,
        tie_embeddings=True,
        citation="arXiv:2403.08295 (GeGLU, head_dim=256, MQA on 2b)",
    )
)
