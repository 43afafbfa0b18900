"""Llama 3.2 Vision 90B backbone — dense decoder with a gated cross-attention
image layer every 5th layer; the vision encoder and projector stubbed.

[hf:meta-llama/Llama-3.2-11B-Vision, scaled as the reference's] 100 layers
(20 groups of 4 self-attention layers + 1 gated cross-attention layer),
d_model 8192, 64 heads (GQA kv=8, head_dim 128), d_ff 28672 (SwiGLU),
vocab 128256, rope theta 5e5, untied head. The cross-attention layers
attend to projected image patch embeddings (B, 1024, 8192) that the caller
supplies. The same fields as the reference's config.
"""

from repro_torch.configs.base import ArchConfig, register

LLAMA_3_2_VISION_90B = register(
    ArchConfig(
        name="llama-3.2-vision-90b",
        arch_type="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        cross_attn_every=5,
        num_frontend_tokens=1024,
        rope_theta=500000.0,
        tie_embeddings=False,
        microbatch=16,
        citation="hf:meta-llama/Llama-3.2-11B-Vision (cross-attn image layers)",
    )
)
