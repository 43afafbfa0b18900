"""The whole of a run on the CPU with the timed path broken underneath:
`correct` comes out false for each fault a cell can have, and true for
the sound program."""

import pytest
import torch
from _tiny import TINY, run_tiny

from vbench import harness

from repro_torch.kernels.alias_mh import ops as alias_ops
from repro_torch.kernels.lda_gibbs import ops as gibbs_ops

# The benchmark's cells, and the tiny zoo that only new files define (the
# batched route: stacks, buckets, unstacked states).
CELLS = sorted(TINY) + ["zoo.fit.batched"]
# The resample each cell's timed sweeps run through.
ENTRY = {"prod.refine.cuda": (gibbs_ops, "resample"),
         "zoo.fit.batched": (gibbs_ops, "resample_many"),
         "prod.refine.alias": (alias_ops, "mh_resample")}


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


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, root):
    res = run_tiny(cell, root)
    assert res["correct"], res["checks"]
    assert res["metrics"] == {}  # nothing measured on the CPU
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
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
