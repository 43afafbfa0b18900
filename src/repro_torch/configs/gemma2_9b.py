"""Gemma 2 9B — alternating local(4096-window)/global attention + softcaps.

[arXiv:2408.00118] 42 layers, d_model 3584, 16 heads (GQA kv=8, head_dim
256), d_ff 14336 (GeGLU), vocab 256000, attention logit softcap 50, final
logit softcap 30, alternating sliding-window(4096)/full layers, embeddings
scaled and tied.

`gemma2-9b-sw` is the every-layer-sliding-window variant: every layer
decodes over a ring cache of the window.
The same fields as the reference's config.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig, register

GEMMA2_9B = register(
    ArchConfig(
        name="gemma2-9b",
        arch_type="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        mlp_variant="geglu",
        embed_scale=True,
        attn_softcap=50.0,
        final_softcap=30.0,
        sliding_window=4096,
        attn_pattern="local_global",
        post_norms=True,
        tie_embeddings=True,
        citation="arXiv:2408.00118 (local+global alternating, logit softcap)",
    )
)

# Beyond-paper variant: all layers sliding-window -> O(window) decode cache,
# registered as its own selectable arch.
GEMMA2_9B_SW = register(
    dataclasses.replace(
        GEMMA2_9B,
        name="gemma2-9b-sw",
        attn_pattern="local",
        citation="arXiv:2408.00118 + sliding-window-everywhere long-context variant",
    )
)
