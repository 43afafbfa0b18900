"""Llama 4 Maverick 400B-A17B — top-1 routed MoE with a shared expert,
dense and MoE layers interleaved; the text backbone of an early-fusion
multimodal model.

[hf:meta-llama/Llama-4-Scout-17B-16E family, as the reference's] 48 layers
(24 pairs of a dense layer with d_ff 16384 and a MoE layer), d_model 5120,
40 heads (GQA kv=8, head_dim 128), 128 experts top-1 with per-expert d_ff
8192 plus a shared (always-on) expert of the same width, vocab 202048,
rope theta 5e5. The same fields as the reference's config, and its
departures from the published model: a softmax top-1 router renormalized
to 1 (the published model routes by a sigmoid), and no chunked-attention or
NoPE layers (every layer full causal attention with rope).

One card holds a share of the experts, not all 128: `base.expert_share(cfg,
i, n)` keeps the router's 128 outputs and top-1 and gives the card experts
[i*128/n, (i+1)*128/n) of every MoE layer (expert parallelism over n cards).
"""

from repro_torch.configs.base import ArchConfig, register

LLAMA4_MAVERICK_400B = register(
    ArchConfig(
        name="llama4-maverick-400b-a17b",
        arch_type="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,  # per-expert ff
        vocab_size=202048,
        num_experts=128,
        experts_per_token=1,
        moe_dense_ff=8192,  # shared expert (always active)
        moe_every=2,  # dense and MoE layers in pairs
        moe_dense_layer_ff=16384,  # the dense layers' d_ff
        rope_theta=500000.0,
        tie_embeddings=False,
        optimizer="adafactor",
        grad_accum_dtype="bfloat16",
        microbatch=8,
        citation="hf:meta-llama/Llama-4-Scout-17B-16E (MoE top-1 + shared expert)",
    )
)
