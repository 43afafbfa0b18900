"""Shared helpers of the port's model tests (dense, moe, ssm, audio, vlm):
one reduced arch on both packages with the reference's weights carried
across, and the runs the tests compare.

Tolerances are `tests/test_torch_hybrid.py`'s: logits within 4% of the
reference's largest logit, caches within 2% of their scale, the port's own
prefill/decode consistency within 2% (the reference's own test holds it
there, `tests/test_archs_smoke.py`).

The audio and VLM families take the frontend stub's output beside the
tokens: `extras` draws it with numpy from a seed, random normal x 0.02 as
the reference's `real_batch` does, and both sides get it in bf16. A VLM's
cross blocks are gated by tanh(gate) with the gates zero at init, which
would hide the cross-attention from every comparison; `model` sets both
gates of every cross block to `GATE` on the reference's weights before
either side uses them. That changes the weights, not the model.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import model as ref_model
from repro_torch import configs
from repro_torch.models import convert, layers, params
from repro_torch.models import model as M

LOGITS_TOL, CACHE_TOL, CONSISTENCY_TOL = 0.04, 0.02, 0.02
GATE = 0.5  # the VLM cross blocks' gate_attn and gate_mlp in these tests


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def schema_rows(schema) -> dict:
    return {"/".join(path): (tuple(d.shape), tuple(d.axes), d.init, d.dtype)
            for path, d in params.leaves(schema)}


@functools.lru_cache(maxsize=None)
def model(name: str, seed: int = 0):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced `name`, the reference's weights from `seed` on both sides."""
    cfg_r = ref_configs.get(name).reduced()
    cfg = configs.get(name).reduced()
    p_np = jax.tree.map(np.asarray, ref_model.init_model(cfg_r, jax.random.PRNGKey(seed)))
    if "xblk" in p_np:  # nonzero gates, so that the cross blocks count
        for gate in ("gate_attn", "gate_mlp"):
            p_np["xblk"][gate] = np.full_like(p_np["xblk"][gate], GATE)
    p_r = jax.tree.map(jnp.asarray, p_np)
    p = convert.params_from_reference(p_np, device="cpu")
    return cfg_r, cfg, p_r, p


def moe_params(tree, layer: int = 0):
    """The `moe` subtree of a MoE model's `layer`-th MoE layer (a tree of
    numpy arrays, jax arrays or tensors): `blk` for Arctic's stack of MoE
    layers, `moe_blk` for llama4's dense/MoE pairs."""
    stack = tree["moe_blk"] if "moe_blk" in tree else tree["blk"]
    return {k: ({kk: vv[layer] for kk, vv in v.items()} if isinstance(v, dict) else v[layer])
            for k, v in stack["moe"].items()}


def tokens(cfg, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, n)).astype(np.int32)


def extras(cfg, b: int = 2, seed: int = 1) -> dict:
    """The frontend stub's output of the audio (`frames`) and VLM
    (`patches`) families, float32 numpy (empty for the others)."""
    name, n = {"audio": ("frames", cfg.encoder_tokens),
               "vlm": ("patches", cfg.num_frontend_tokens)}.get(cfg.arch_type, (None, 0))
    if name is None:
        return {}
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal((b, n, cfg.d_model)) * 0.02).astype(np.float32)}


def ref_batch(cfg, toks: np.ndarray) -> dict:
    """The reference's batch: the tokens and `extras` in bf16."""
    return {"tokens": jnp.asarray(toks),
            **{k: jnp.asarray(a, jnp.bfloat16) for k, a in extras(cfg, len(toks)).items()}}


def port_batch(cfg, toks) -> dict:
    """The port's batch: the same tokens and `extras` in bf16."""
    return {"tokens": torch.as_tensor(np.asarray(toks)),
            **{k: torch.tensor(a).to(torch.bfloat16)
               for k, a in extras(cfg, len(toks)).items()}}


@functools.lru_cache(maxsize=None)
def teacher_forced(name: str, prompt: int, cache_len: int, steps: int):
    """Prefill `prompt` tokens then `steps` teacher-forced decode steps on
    both sides, each from its own cache: [((reference cache, logits), (port
    cache, logits))] a step, numpy copies."""
    cfg_r, cfg, p_r, p = model(name)
    toks = tokens(cfg, prompt + steps)
    c_r, l_r = ref_model.prefill(p_r, cfg_r, ref_batch(cfg, toks[:, :prompt]),
                                 cache_len=cache_len)
    c, lg = M.prefill(p, cfg, port_batch(cfg, toks[:, :prompt]), cache_len)
    out = [((jax.tree.map(np.asarray, c_r), np.asarray(l_r)),
            (convert.cache_to_numpy(c), lg.numpy()))]
    for i in range(steps):
        pos = prompt + i
        c_r, l_r = ref_model.decode_step(p_r, cfg_r, c_r, jnp.asarray(toks[:, pos]),
                                         jnp.int32(pos))
        c, lg = M.decode_step(p, cfg, c, torch.tensor(toks[:, pos]), pos)
        out.append(((jax.tree.map(np.asarray, c_r), np.asarray(l_r)),
                    (convert.cache_to_numpy(c), lg.numpy())))
    return out


def decode_from_reference_cache(name: str, prompt: int, cache_len: int):
    """The port's decode step from the reference's own prefill cache (carried
    across with `cache_from_reference`, checked exact) beside the
    reference's step: (reference cache, logits, port cache, logits)."""
    cfg_r, cfg, p_r, p = model(name)
    toks = tokens(cfg, prompt + 1)
    c_r, _ = ref_model.prefill(p_r, cfg_r, ref_batch(cfg, toks[:, :prompt]),
                               cache_len=cache_len)
    c = convert.cache_from_reference(jax.tree.map(np.asarray, c_r), device="cpu")
    for key, a in c_r.items():
        assert c[key].dtype == (torch.float32 if a.dtype == jnp.float32 else torch.bfloat16)
        np.testing.assert_array_equal(convert.cache_to_numpy(c)[key], np.asarray(a, np.float32))
    tok = toks[:, prompt]
    c_r, l_r = ref_model.decode_step(p_r, cfg_r, c_r, jnp.asarray(tok), jnp.int32(prompt))
    c, lg = M.decode_step(p, cfg, c, torch.tensor(tok), prompt)
    return jax.tree.map(np.asarray, c_r), np.asarray(l_r), convert.cache_to_numpy(c), lg.numpy()


def full_logits(p, cfg, toks: torch.Tensor, capacity_factor=M.PREFILL_CAPACITY) -> np.ndarray:
    """The port's last-token logits of one causal forward over `toks`."""
    h, _, _ = M.forward_hidden(p, cfg, port_batch(cfg, toks), capacity_factor=capacity_factor)
    return layers.logits_last(h[:, -1], M.unembed_table(p, cfg), cfg.final_softcap).numpy()


@functools.lru_cache(maxsize=None)
def prefill_decode_rels(name: str, prompt: int, cache_len: int, steps: int, seed: int = 4,
                        capacity_factor: float = M.PREFILL_CAPACITY):
    """Prefill `prompt` tokens, then `steps` decode steps: each step's logits
    against the full forward over the tokens up to it (rel a step). A MoE
    model's prefill and full forward run at `capacity_factor` (a decode step
    never drops)."""
    _, cfg, _, p = model(name)
    toks = torch.tensor(tokens(cfg, prompt + steps, seed))
    cache, _ = M.prefill(p, cfg, port_batch(cfg, toks[:, :prompt]), cache_len,
                         capacity_factor=capacity_factor)
    rels = []
    for i in range(steps):
        cache, dec = M.decode_step(p, cfg, cache, toks[:, prompt + i], prompt + i)
        rels.append(rel(dec.numpy(), full_logits(p, cfg, toks[:, :prompt + i + 1],
                                                 capacity_factor)))
    return rels
