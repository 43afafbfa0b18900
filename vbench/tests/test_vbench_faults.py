"""The whole of a run on the CPU with the timed path broken underneath:
`correct` comes out false for each fault a cell can have, and true for
the sound program."""

import pytest
import torch
from _tiny import run_tiny, tiny_cell

from vbench import harness

from repro_torch.kernels.alias_mh import ops as alias_ops
from repro_torch.kernels.lda_gibbs import ops as gibbs_ops
from repro_torch.models import model as lm_model
from repro_torch.models import ssm
from repro_torch.serving import engine as lm_engine

# The resample each sweep cell's timed sweeps run through: the benchmark's
# RLDA cells, and the tiny zoo that only new files define (the batched
# route: stacks, buckets, unstacked states).
ENTRY = {"prod.refine.cuda": (gibbs_ops, "resample"),
         "zoo.fit.batched": (gibbs_ops, "resample_many"),
         "prod.refine.alias": (alias_ops, "mh_resample")}
SWEEP_CELLS = sorted(ENTRY)
SERVE_CELL = "zamba2.serve.docqa"


def _unchanged(args, z_new):  # noqa: ARG001
    return args[2].clone()  # the state's z, as it went in


def _half_left_out(args, z_new):
    """The second half of the first axis is not swept: of the models in a
    stack, of the tokens of one model."""
    z_old, out = args[2], z_new.clone()
    half = out.shape[0] // 2
    out[half:] = z_old[half:]
    return out


def _token_altered(args, z_new):
    out = z_new.clone()
    k = args[6].shape[-1]
    flat = out.view(-1)
    flat[0] = (flat[0] + 1) % k
    return out


FAULTS = {"state_unchanged": _unchanged, "half_left_out": _half_left_out,
          "token_altered": _token_altered}


@pytest.fixture
def root(cell, zoo_root):
    return zoo_root if cell == "zoo.fit.batched" else harness.REPO


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("cell", SWEEP_CELLS + [SERVE_CELL])
def test_sound_run_is_correct(cell, root):
    res = run_tiny(cell, root)
    assert res["correct"], res["checks"]
    assert res["metrics"] == {}  # nothing measured on the CPU
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", SWEEP_CELLS)
def test_fault_is_not_correct(cell, root, fault, monkeypatch):
    mod, name = ENTRY[cell]
    orig = getattr(mod, name)

    def broken(*args, **kwargs):
        return FAULTS[fault](args, orig(*args, **kwargs))

    monkeypatch.setattr(mod, name, broken)
    res = run_tiny(cell, root)
    assert not res["correct"], res["checks"]
    assert res["checks"]["z_mismatch"]["value"] > res["checks"]["z_mismatch"]["limit"]


@pytest.mark.parametrize("cell", ["prod.refine.cuda", "zoo.fit.batched"])
def test_rebuild_fault_is_not_correct(cell, root, monkeypatch):
    """Counts rebuilt from half the tokens: the count check fails."""
    from repro_torch.core import codec

    orig = codec.rebuild_state

    def broken(cfg, corpus, z):
        half = type(corpus)(corpus.docs, corpus.words, corpus.weights.clone())
        half.weights[..., : half.weights.shape[-1] // 2] = 0.0
        return orig(cfg, half, z)

    monkeypatch.setattr(codec, "rebuild_state", broken)
    res = run_tiny(cell, root)
    assert not res["correct"]
    assert res["checks"]["count_dev"]["value"] > res["checks"]["count_dev"]["limit"]


# Faults of the served model's timed path (`Engine` -> `models.model`),
# each planted under the tap, so the check reads what the broken program
# served.


def _conv_stale(orig):
    def mamba2_mix_step(p, x, state, conv_state, cfg):
        y, (s, _) = orig(p, x, state, conv_state, cfg)
        return y, (s, conv_state)
    return ssm, "mamba2_mix_step", mamba2_mix_step


def _cache_unchanged(orig):
    """A decode step that computes on a copy and returns the cache as it
    came in: no state, conv or ring slot moves."""
    def decode_step(params, cfg, cache, tokens, pos):
        _, logits = orig(params, cfg, {k: v.clone() for k, v in cache.items()}, tokens, pos)
        return cache, logits
    return lm_model, "decode_step", decode_step


def _shared_block_skipped(orig):  # noqa: ARG001
    def block_decode(p, x, cfg, ck, cv, pos, **kwargs):  # noqa: ARG001
        return x, ck, cv
    return lm_model, "_block_decode", block_decode


def _half_batch_left_out(orig):
    """The second half of the wave's rows is not decoded: it takes the
    first half's logits."""
    def decode_step(params, cfg, cache, tokens, pos):
        cache, logits = orig(params, cfg, cache, tokens, pos)
        logits = logits.clone()
        half = logits.shape[0] // 2
        logits[half:] = logits[:half]
        return cache, logits
    return lm_model, "decode_step", decode_step


def _token_not_argmax(orig):
    def sample(self, logits, temperature):
        tok = orig(self, logits, temperature).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    return lm_engine.Engine, "_sample", sample


SERVE_FAULTS = {"conv_state_stale": (ssm, "mamba2_mix_step", _conv_stale),
                "cache_unchanged": (lm_model, "decode_step", _cache_unchanged),
                "shared_block_skipped": (lm_model, "_block_decode", _shared_block_skipped),
                "half_batch_left_out": (lm_model, "decode_step", _half_batch_left_out),
                "token_not_argmax": (lm_engine.Engine, "_sample", _token_not_argmax)}


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_serving_fault_is_not_correct(fault, monkeypatch):
    owner, name, make = SERVE_FAULTS[fault]
    monkeypatch.setattr(*make(getattr(owner, name)))
    res = run_tiny(SERVE_CELL)
    assert not res["correct"], res["checks"]
    assert any(row["value"] > row["limit"] for row in res["checks"].values())


def _scan_state_bf16(a, k, q, v, *, chunk=32, s0=None):  # noqa: ARG001
    """The Mamba2 scan with its state rounded to bfloat16 after every
    token, where the configuration keeps it in float32."""
    b, t, h, p = v.shape
    s = torch.zeros(b, h, k.shape[-1], p, dtype=torch.bfloat16, device=v.device)
    ys = []
    for i in range(t):
        s = (a[:, i, :, None, None].float() * s.float()
             + k[:, i, None, :, None].float() * v[:, i, :, None, :].float()).to(torch.bfloat16)
        ys.append(torch.einsum("bn,bhnp->bhp", q[:, i].float(), s.float()))
    return torch.stack(ys, 1).to(v.dtype), s.float()


def test_scan_state_in_bfloat16_is_not_correct(monkeypatch):
    """Prefill's scans hold their states in bfloat16: the logits pass (the
    drift of the bfloat16 layers hides it), the kept layers' last states
    do not. Prompts of the cell's shortest length, at which the rounding
    has built up."""
    from repro_torch.kernels.chunk_scan import ops as scan_ops

    monkeypatch.setattr(scan_ops, "chunk_scan_mamba2", _scan_state_bf16)
    cell = tiny_cell(SERVE_CELL)
    cell.mix["serve"]["cache_len"] = 2048
    cell.mix["request"].update(batch=2, lengths=[min(harness.load_cell(SERVE_CELL).mix[
        "request"]["lengths"])])
    res = harness.run_cell(cell, 2147483999, 0.3, False, device="cpu", log=lambda m: None)
    assert not res["correct"], res["checks"]
    assert res["checks"]["state_dev"]["value"] > res["checks"]["state_dev"]["limit"]
