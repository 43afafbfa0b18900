"""The port's training half on its own, on the CPU: the reference's claims
(`tests/test_train.py`, `tests/test_launchers.py::test_train_cli_*`,
`tests/test_archs_smoke.py::test_train_step`) held by `repro_torch`, and
the new keywords of the model (`train`, `use_kernel`, remat,
`unembed_chunked`, `real_batch`). The comparisons with the JAX reference
are in `tests/test_torch_train_parity.py`.

Tolerances: the reference's own where a claim is ported (microbatch 4
against the full batch: loss within 5e-3, fewer than 1% of entries past
5e-3 + 5% of the value; the loss drops by 0.05 in 40 steps and by 1.0 on
bigram data in 120); remat on against off within 1e-6 of the scale (the
same float32 sums in another grouping); the chunked loss against whole
float32 logits within 1e-6, its gradients within 4e-6 of their scale (its
backward's softmax - onehot against autograd's form of the same).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import REFERENCE_ARCHS  # noqa: E402
from repro_torch.kernels.chunk_scan import ops as cs_ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers, moe, params  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import train  # noqa: E402
from repro_torch.train.optim import OptConfig, make_optimizer, schedule  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _leaves(tree):
    return [x for _, x in params.leaves(tree)]


def test_schedule_shape():
    cfg = OptConfig(lr=1e-3, warmup_steps=10, decay_steps=100, min_lr_frac=0.1)
    lrs = [float(schedule(cfg, s)) for s in (0, 5, 10, 50, 100, 200)]
    assert abs(lrs[0] - 1e-4) < 1e-9  # (0+1)/10 of peak: first step is real
    assert abs(lrs[2] - 1e-3) < 1e-9  # peak at end of warmup
    assert lrs[3] < lrs[2]
    assert abs(lrs[4] - 1e-4) < 1e-9  # floor
    assert lrs[5] == lrs[4]


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizer_reduces_loss(opt_name):
    cfg = dataclasses.replace(configs.get("qwen2-7b").reduced(), optimizer=opt_name)
    _, hist = train(cfg, num_steps=40, seq_len=64, global_batch=8, device="cpu",
                    opt_cfg=OptConfig(name=opt_name, lr=1e-3, warmup_steps=5, decay_steps=40),
                    log_every=39)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.05


def test_microbatch_equals_full_batch_grads():
    """Gradient accumulation (float32 buffers) matches the single-shot step."""
    cfg = configs.get("phi3-medium-14b").reduced()
    cfg1 = dataclasses.replace(cfg, microbatch=1)
    cfg4 = dataclasses.replace(cfg, microbatch=4, grad_accum_dtype="float32")
    p0 = M.init_model(cfg1, seed=0, device="cpu")
    opt = make_optimizer(OptConfig(lr=1e-2, warmup_steps=0, decay_steps=10))
    batch = M.real_batch(cfg1, "train", 8, 32, generator=_gen(1))
    p1, p4 = _clone(p0), _clone(p0)
    p1, _, m1 = make_train_step(cfg1, opt)(p1, opt.init(p1), batch, 0)
    p4, _, m4 = make_train_step(cfg4, opt)(p4, opt.init(p4), batch, 0)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 5e-3
    # Adam's elementwise normalization amplifies accumulation-order rounding
    # where v ~ 0, so compare by fraction-of-elements rather than allclose.
    for a, b in zip(_leaves(p1), _leaves(p4)):
        af, bf = a.float().numpy(), b.float().numpy()
        bad = np.abs(af - bf) > (5e-3 + 5e-2 * np.abs(bf))
        assert bad.mean() < 0.01, bad.mean()


def test_microbatch_accumulates_in_the_configured_type(monkeypatch):
    """The accumulation buffers take `cfg.grad_accum_dtype`, not the
    gradients' own bf16: float32 buffers for "float32"."""
    cfg = dataclasses.replace(configs.get("qwen2-7b").reduced(), microbatch=2)
    p = M.init_model(cfg, seed=0, device="cpu")
    opt = make_optimizer(OptConfig(warmup_steps=1))
    seen = {}
    orig = opt.update

    def spy(grads, state, params_, step):
        seen.update({k: g.dtype for k, g in params.leaves(grads)})
        return orig(grads, state, params_, step)

    object.__setattr__(opt, "update", spy)
    make_train_step(cfg, opt)(p, opt.init(p), M.real_batch(cfg, "train", 4, 16,
                                                               generator=_gen(2)), 0)
    assert set(seen.values()) == {torch.float32}
    with pytest.raises(ValueError, match="does not split"):
        make_train_step(cfg, opt)(p, opt.init(p), M.real_batch(cfg, "train", 3, 16,
                                                                   generator=_gen(2)), 0)


def test_adafactor_state_is_factored():
    cfg = configs.get("arctic-480b").reduced()
    p = M.init_model(cfg, seed=0, device="cpu")
    st = make_optimizer(OptConfig(name="adafactor")).init(p)
    s_bytes = sum(x.numel() * 4 for x in _leaves(st))
    p_bytes = sum(x.numel() * x.element_size() for x in _leaves(p))
    assert s_bytes < 0.6 * p_bytes  # factored: far below AdamW's 4x
    assert {tuple(st["embed"][k].shape) for k in ("vr", "vc")} == {(cfg.vocab_size,),
                                                                   (cfg.d_model,)}


def test_checkpoint_roundtrip(tmp_path):
    cfg = configs.get("gemma2-9b").reduced()
    p = M.init_model(cfg, seed=0, device="cpu")
    opt_state = make_optimizer(OptConfig()).init(p)
    path = os.path.join(tmp_path, "ckpt.npz")
    ckpt.save(path, p, opt_state, step=17)
    assert os.listdir(tmp_path) == ["ckpt.npz"]  # no temporary left behind
    p2, o2, step = ckpt.restore(path, p, opt_state)
    assert step == 17
    for a, b in zip(_leaves(p) + _leaves(opt_state), _leaves(p2) + _leaves(o2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # structure mismatch is caught
    other = M.init_model(configs.get("qwen2-7b").reduced(), seed=1, device="cpu")
    with pytest.raises((KeyError, ValueError)):
        ckpt.restore(path, other)


def test_loss_drops_on_learnable_bigram_data():
    """End-to-end: a small dense model learns the planted bigram process
    (entropy log(4) ≈ 1.39 << random ≈ 6.2)."""
    cfg = configs.get("phi3-medium-14b").reduced()
    _, hist = train(cfg, num_steps=120, seq_len=64, global_batch=16, device="cpu",
                    opt_cfg=OptConfig(lr=3e-3, warmup_steps=10, decay_steps=120),
                    log_every=20)
    assert hist[-1]["loss"] < hist[0]["loss"] - 1.0, hist
    assert [h["step"] for h in hist] == [0, 20, 40, 60, 80, 100, 119]
    assert all(b["wall_s"] >= a["wall_s"] for a, b in zip(hist, hist[1:]))


def test_train_cli_runs_and_logs(tmp_path):
    metrics = os.path.join(tmp_path, "metrics.json")
    path = os.path.join(tmp_path, "ckpt.npz")
    history = train_cli.main([
        "--arch", "qwen2-7b", "--steps", "8", "--seq-len", "32", "--global-batch", "4",
        "--ckpt", path, "--metrics-out", metrics, "--device", "cpu",
    ])
    assert len(history) >= 2
    assert all(np.isfinite(h["loss"]) for h in history)
    assert os.path.exists(path)
    with open(metrics) as f:
        logged = json.load(f)
    assert logged[-1]["step"] == 7


def test_train_cli_ssm_arch():
    history = train_cli.main([
        "--arch", "rwkv6-1.6b", "--steps", "4", "--seq-len", "32", "--global-batch", "2",
        "--device", "cpu",
    ])
    assert np.isfinite(history[-1]["loss"])


def test_train_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device resolves, nothing to raise")
    cfg = configs.get("qwen2-7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "qwen2-7b", "--steps", "1", "--seq-len", "8",
                        "--global-batch", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, num_steps=1, seq_len=8, global_batch=2)


@pytest.fixture(scope="module")
def arch_state():
    cache = {}

    def get(name):
        if name not in cache:
            cfg = configs.get(name).reduced()
            cache[name] = (cfg, M.init_model(cfg, seed=0, device="cpu"))
        return cache[name]

    return get


@pytest.mark.parametrize("name", REFERENCE_ARCHS)
def test_train_step(arch_state, name):
    cfg, p0 = arch_state(name)
    assert cfg.num_layers <= 2 and cfg.d_model <= 512
    opt = make_optimizer(OptConfig(name=cfg.optimizer, warmup_steps=1))
    p = _clone(p0)
    batch = M.real_batch(cfg, "train", 2, 64, generator=_gen(1))
    p, _, metrics = make_train_step(cfg, opt)(p, opt.init(p), batch, 0)
    assert set(metrics) == {"loss", "nll", "load_balance", "router_z", "grad_norm"}
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"])) and float(metrics["grad_norm"]) > 0
    assert (float(metrics["load_balance"]) > 0) == bool(cfg.num_experts)
    # params actually moved, in place, keeping their types
    moved = [float((a.float() - b.float()).abs().max()) for a, b in zip(_leaves(p0), _leaves(p))]
    assert max(moved) > 0
    assert [a.dtype for a in _leaves(p0)] == [b.dtype for b in _leaves(p)]
    assert not any(b.requires_grad for b in _leaves(p))


def _loss_and_grads(p, cfg, batch):
    free = [t.detach().requires_grad_() for t in _leaves(p)]
    loss, aux = M.forward_loss(_rebuild(p, iter(free)), cfg, batch)
    return loss.detach(), aux, torch.autograd.grad(loss, free)


def _rebuild(tree, it):
    return {k: _rebuild(tree[k], it) if isinstance(tree[k], dict) else next(it)
            for k in sorted(tree)}


@pytest.mark.parametrize("name", ["qwen2-7b", "gemma2-9b", "rwkv6-1.6b", "zamba2-2.7b",
                                  "whisper-base", "llama-3.2-vision-90b", "arctic-480b",
                                  "llama4-maverick-400b-a17b"])
def test_remat_leaves_the_loss_and_gradients_as_they_are(arch_state, name):
    """`cfg.remat` (each layer, pair or group under `torch.utils.checkpoint`)
    recomputes the same float32 activations: loss equal, gradients within
    1e-6 of their scale."""
    cfg, p = arch_state(name)
    assert cfg.remat
    batch = M.real_batch(cfg, "train", 2, 32, generator=_gen(3))
    loss, aux, g = _loss_and_grads(p, cfg, batch)
    loss0, aux0, g0 = _loss_and_grads(p, dataclasses.replace(cfg, remat=False), batch)
    assert torch.equal(loss, loss0)
    for key in aux:
        assert torch.equal(aux[key].detach(), aux0[key].detach()), key
    for a, b in zip(g, g0):
        assert float((a.float() - b.float()).abs().max()) <= 1e-6 * float(b.float().abs().max())


@pytest.mark.parametrize("name", ["arctic-480b", "llama4-maverick-400b-a17b"])
def test_train_takes_the_training_capacity_and_sums_the_aux(arch_state, name, monkeypatch):
    """train=True: every MoE layer at `capacity_factor=None` (the config's
    1.25, the reference's train branch), its aux summed over layers into
    the loss; serving at the prefill factor (2.0)."""
    cfg, p = arch_state(name)
    calls = []
    orig = moe.moe_layer

    def spy(pp, x, c, *, capacity_factor=None):
        out, a = orig(pp, x, c, capacity_factor=capacity_factor)
        calls.append((capacity_factor, {k: float(v) for k, v in a.items()}))
        return out, a

    monkeypatch.setattr(moe, "moe_layer", spy)
    batch = M.real_batch(cfg, "train", 2, 32, generator=_gen(4))
    with torch.no_grad():
        loss, aux = M.forward_loss(p, cfg, batch)
        n_moe = cfg.num_layers // cfg.moe_every
        assert [cf for cf, _ in calls] == [None] * n_moe
        for key in ("load_balance", "router_z"):
            assert float(aux[key]) == pytest.approx(sum(a[key] for _, a in calls), rel=1e-6)
        want = (float(aux["nll"]) + cfg.load_balance_loss * float(aux["load_balance"])
                / cfg.num_layers + cfg.router_zloss * float(aux["router_z"]) / cfg.num_layers)
        assert float(loss) == pytest.approx(want, rel=1e-6)
        calls.clear()
        _, served, _ = M.forward_hidden(p, cfg, batch)
        assert [cf for cf, _ in calls] == [M.PREFILL_CAPACITY] * n_moe
        assert float(served["load_balance"]) > 0


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_use_kernel_picks_the_scan_entry(arch_state, name, monkeypatch):
    """`use_kernel=True` (the serving default) takes the chunk_scan
    wrappers (the kernels on the card); False (the training default) the
    plain versions, never the wrappers."""
    cfg, p = arch_state(name)
    entry = "chunk_scan" if cfg.arch_type == "ssm" else "chunk_scan_mamba2"
    called = []
    orig = getattr(cs_ops, entry)
    monkeypatch.setattr(cs_ops, entry, lambda *a, **kw: called.append(1) or orig(*a, **kw))
    batch = M.real_batch(cfg, "train", 2, 32, generator=_gen(5))
    with torch.no_grad():
        h_kernel = M.forward_hidden(p, cfg, batch)[0]
        assert len(called) == cfg.num_layers
        called.clear()
        h_plain = M.forward_hidden(p, cfg, batch, use_kernel=False)[0]
        M.forward_loss(p, cfg, batch)
    assert not called
    assert torch.equal(h_kernel, h_plain)  # on the CPU both are the plain version


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_unembed_chunked_equals_whole_logits(cap):
    """The summed NLL and its gradients against one float32 product of the
    whole sequence's logits, autograd through it."""
    rng = np.random.default_rng(6)
    h = torch.tensor(rng.standard_normal((2, 96, 16)), dtype=torch.float32)
    table = torch.tensor(rng.standard_normal((300, 16)) * 3, dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 300, (2, 96)), dtype=torch.int32)
    hc, tc = h.clone().requires_grad_(), table.clone().requires_grad_()
    nll = layers.unembed_chunked(hc, tc, labels, chunk=M.loss_chunk(96), final_cap=cap)
    gh, gt = torch.autograd.grad(nll, (hc, tc))
    hw, tw = h.clone().requires_grad_(), table.clone().requires_grad_()
    logits = layers.softcap(hw @ tw.T, cap)
    want = torch.sum(torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None].long())[..., 0])
    wh, wt = torch.autograd.grad(want, (hw, tw))
    assert nll.dtype == torch.float32 and nll.dim() == 0
    assert float(abs(nll.detach() - want.detach())) <= 1e-6 * float(want.detach())
    for got, w in ((gh, wh), (gt, wt)):  # softmax - onehot against autograd's own form
        assert float((got - w).abs().max()) <= 4e-6 * float(w.abs().max())
    assert M.loss_chunk(96) == 96 and M.loss_chunk(4096) == 512 and M.loss_chunk(1536) == 512
    assert M.loss_chunk(1000) == 8  # 512 halved until it divides
    with pytest.raises(ValueError, match="does not divide"):
        layers.unembed_chunked(h, table, labels, chunk=64)


@pytest.mark.parametrize("name", ["qwen2-7b", "whisper-base", "llama-3.2-vision-90b"])
def test_real_batch(name):
    cfg = configs.get(name).reduced()
    a = M.real_batch(cfg, "train", 3, 16, generator=_gen(7))
    b = M.real_batch(cfg, "train", 3, 16, generator=_gen(7))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert a["tokens"].shape == a["labels"].shape == (3, 16)
    assert a["tokens"].dtype == torch.int32 and int(a["tokens"].max()) < cfg.vocab_size
    stub = {"vlm": ("patches", cfg.num_frontend_tokens),
            "audio": ("frames", cfg.encoder_tokens)}.get(cfg.arch_type)
    if stub:
        assert a[stub[0]].shape == (3, stub[1], cfg.d_model)
        assert a[stub[0]].dtype == torch.bfloat16
    assert set(M.real_batch(cfg, "prefill", 3, 16, generator=_gen(7))) == (
        {"tokens"} | ({stub[0]} if stub else set()))
    assert M.real_batch(cfg, "decode", 3, 16, generator=_gen(7))["tokens"].shape == (3,)
    with pytest.raises(ValueError):
        M.real_batch(cfg, "score", 3, 16, generator=_gen(7))
