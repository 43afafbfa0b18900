"""Mixture-of-Experts layer: top-k routing with capacity, one card's experts.

The reference's `repro.models.moe` in PyTorch, step for step: a float32
router over all E experts, top-k (descending, as `jax.lax.top_k`) with the
gates renormalized to 1, each (token, choice) pair's slot in its expert's
buffer in token-major order (earlier tokens win slots), `cap = max(1, int(n
* k * cf / E))`, pairs at or past `cap` dropped; tokens scattered into
(experts, cap, D) buffers in x's type, the experts' SwiGLU as batched
products (`torch.bmm`), gathered back, the dropped pairs zeroed and the k
gated outputs summed in x's type. Arctic's dense residual / Llama 4's
shared expert (`cfg.moe_dense_ff`) is added to the routed output.

One card holds the experts `cfg.expert_slice` of E (all of them unless the
config is a `configs.base.ExpertShare`): routing and `cap` count all E, and
the card computes its own experts' buffers only, the one-card form of the
reference's expert-parallel layout (its buffers' experts axis sharded over
the mesh's 'model' axis, the all-to-alls XLA adds). Nothing stands in for
the absent experts: their pairs add nothing here. Every index stays on the
device (pairs that are dropped or not held go to a spare row), so a layer
makes no host sync.

The reference computes the layer in XLA, with no Pallas kernel; it is plain
PyTorch here too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mlp


def router_probs(x: torch.Tensor, w_router: torch.Tensor):
    """Float32 router logits over all experts and their softmax. x: (..., D)
    in any type, w_router (D, E) float32."""
    logits = x.float() @ w_router.float()
    return torch.softmax(logits, dim=-1), logits


def route(probs_t: torch.Tensor, k: int):
    """Top-k of each token's probabilities (n, E): (gates (n, k) renormalized
    to 1, expert ids (n, k)), descending."""
    gate_vals, topk_idx = torch.topk(probs_t, k, dim=-1)
    return gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9), topk_idx


def slots(flat_expert: torch.Tensor, e: int, cap: int):
    """Each (token, choice) pair's position in its expert's buffer, in the
    flat token-major order (the reference's one-hot cumsum), and whether it
    fits under `cap`: (pos (n*k,), keep (n*k,) bool)."""
    onehot = F.one_hot(flat_expert.long(), e)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    return pos, pos < cap


def capacity(n: int, k: int, cf: float, e: int) -> int:
    """Buffer rows an expert: the reference's `max(1, int(n * k * cf / E))`."""
    return max(1, int(n * k * cf / e))


def moe_layer(p, x: torch.Tensor, cfg, *, capacity_factor: float | None = None):
    """x (B, S, D) -> (out (B, S, D) in x's type, aux). p: `router` (D, E)
    float32, `w_gate` / `w_up` (E_held, D, F), `w_down` (E_held, F, D), and
    `dense` {gate, up, down} when `cfg.moe_dense_ff`. aux: the reference's
    `load_balance` and `router_z` (float32 0-d; serving discards them, as the
    reference's does) and `dropped`, the pairs past capacity over all E (0-d
    int64), all on x's device."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    lo, hi = cfg.expert_slice
    held = hi - lo
    if p["w_gate"].shape[0] != held:
        raise ValueError(f"{cfg.name}: {p['w_gate'].shape[0]} experts given, the config "
                         f"holds [{lo}, {hi})")
    n = b * s
    cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
    cap = capacity(n, k, cf, e)

    xt = x.reshape(n, d)
    probs, logits = router_probs(xt, p["router"])  # (n, E)
    gate_vals, topk_idx = route(probs, k)
    flat_expert = topk_idx.reshape(-1)  # (n*k,)
    pos, keep = slots(flat_expert, e, cap)

    # Held pairs to their buffer row (expert - lo) * cap + pos; the rest to
    # the spare row held * cap, which is scattered into and never read.
    mine = keep & (flat_expert >= lo) & (flat_expert < hi)
    row = torch.where(mine, (flat_expert - lo) * cap + pos, held * cap)
    src = torch.where(mine[:, None], xt.repeat_interleave(k, dim=0), 0)
    buf = torch.zeros(held * cap + 1, d, dtype=x.dtype, device=x.device)
    buf.index_add_(0, row, src)  # each held row gets one pair: exact
    buf = buf[:-1].reshape(held, cap, d)

    act = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(act, p["w_down"]).reshape(held * cap, d)

    gathered = torch.where(mine[:, None], out_buf[row.clamp_max(held * cap - 1)], 0)
    combined = (gathered.reshape(n, k, d) * gate_vals[..., None].to(x.dtype)).sum(dim=1)
    out = combined.reshape(b, s, d).to(x.dtype)

    if cfg.moe_dense_ff:  # Arctic's dense residual / Llama 4's shared expert
        out = out + mlp(x, p["dense"], "swiglu")

    # The reference's aux losses (Switch-style load balance + router z-loss).
    me = probs.mean(dim=0)
    ce = torch.zeros(e, device=x.device).index_add_(
        0, flat_expert, torch.ones(n * k, device=x.device)) / max(n * k, 1)
    return out, {"load_balance": e * torch.sum(me * ce),
                 "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
                 "dropped": (~keep).sum()}
