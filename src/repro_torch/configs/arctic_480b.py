"""Snowflake Arctic 480B — dense-MoE hybrid: 128-expert top-2 MoE in
parallel with a dense residual MLP.

[hf:Snowflake/snowflake-arctic-base] 35 layers, d_model 7168, 56 heads
(GQA kv=8, head_dim 128), expert d_ff 4864, 128 experts top-2, vocab 32000,
plus the dense residual branch (Arctic's defining dense+MoE composition).
The same fields as the reference's config, and its departures from the
published model: a softmax top-2 router renormalized to 1, and every
layer full causal attention.

One card holds a share of the experts, not all 128: `base.expert_share(cfg,
i, n)` keeps the router's 128 outputs and top-2 and gives the card experts
[i*128/n, (i+1)*128/n) of every layer (expert parallelism over n cards).
"""

from repro_torch.configs.base import ArchConfig, register

ARCTIC_480B = register(
    ArchConfig(
        name="arctic-480b",
        arch_type="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,  # per-expert ff
        vocab_size=32000,
        num_experts=128,
        experts_per_token=2,
        moe_dense_ff=4864,  # dense residual MLP in parallel with the MoE
        tie_embeddings=False,
        optimizer="adafactor",
        grad_accum_dtype="bfloat16",
        microbatch=8,
        citation="hf:Snowflake/snowflake-arctic-base (128e top-2 + dense residual)",
    )
)
