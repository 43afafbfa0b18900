"""Whisper base — encoder-decoder audio backbone, conv frontend stubbed.

[arXiv:2212.04356] base: 6 encoder + 6 decoder layers, d_model 512, 8 heads
(MHA: kv heads = heads), head_dim 64, d_ff 2048 (GELU), vocab 51865, 1500
audio frames after the conv frontend (stubbed: the caller supplies frame
embeddings (B, 1500, 512)); no rope, sinusoidal positions on both sides.
The same fields as the reference's config.
"""

from repro_torch.configs.base import ArchConfig, register

WHISPER_BASE = register(
    ArchConfig(
        name="whisper-base",
        arch_type="audio",
        num_layers=6,  # decoder layers
        encoder_layers=6,
        encoder_tokens=1500,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51865,
        mlp_variant="gelu",
        rope_theta=0.0,  # sinusoidal positions, no rope
        tie_embeddings=True,
        citation="arXiv:2212.04356 (enc-dec, conv frontend stubbed)",
    )
)
