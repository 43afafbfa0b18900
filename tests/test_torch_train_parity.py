"""The port's training half against the JAX reference, on the CPU.

Every arch the reference registers, reduced on both sides with the
reference's bf16 weights carried across (`tests/_torch_models.model`, the
VLM's cross gates opened to 0.5), one (2, 64) batch of
`data.lm.batches_for` (seed 0, the frontend stub's patches or frames
beside it): `repro_torch.models.model.forward_loss` and its gradients
against `jax.value_and_grad(repro.models.model.forward_loss)`. The
reference's loss runs in bf16 only (its embedding is cast to bf16, and
`lax.scan` refuses a float32 carry then), so both sides run bf16 weights.

Tolerances:
- the loss and each aux term (`nll`, `load_balance`, `router_z`) within
  2e-3;
- each gradient leaf within 0.1 of the reference leaf's largest entry, with
  cosine >= 0.998; or, where the reference's own bf16 gradient is farther
  than that from the float32 gradient (the port run on float32 copies of
  the same weights), no farther from it than the reference's is, by either
  measure (rwkv6's bf16 backward: the reference's `u` gradient is 1.6 of
  its scale from the float32 one).
- MoE archs: the comparison holds where both sides pick the same experts.
  Each MoE layer's router probabilities are recorded on both sides (the
  reference's through `jax.debug.callback`, with its remat off, which
  changes no value); a token whose top-k picks differ must be a near-tie
  (its k-th and (k+1)-th probabilities on the port within `TIE` = 1e-2,
  the bf16 noise between the packages' probabilities, up to 5e-3 here).
  Then the port runs again with the reference's picks at those tokens and
  the tolerances above hold.

Optimizers (AdamW, Adafactor), leaf for leaf against the reference's given
the same numpy gradients over three steps: float32 state within 1e-6 of
its scale, plus, with the global-norm clip acting, twice the two packages'
norms' relative gap (the reference's float32 sum is ~1e-6 from the float64
norm, the port's ~4e-8); bf16 parameters equal but for one-ulp
differences on at most 0.1% of entries. `schedule` and
`clip_by_global_norm` within one float32 ulp. `BigramStream` /
`batches_for` equal array for array; checkpoints written by either package
restore in the other bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_models import model  # noqa: E402
from repro.data import lm as ref_lm  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import REFERENCE_ARCHS  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.models import convert, moe, params  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402

SEQ, BATCH = 64, 2
LOSS_TOL, GRAD_REL, GRAD_COS = 2e-3, 0.1, 0.998
TIE = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(paths, values):
    out = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _ref_run(cfg_r, p_r, batch):
    """The reference's loss, aux, gradients (numpy, by path) and each MoE
    layer's router probabilities (n, E) in forward order."""
    probs = []
    orig = ref_model.moe_layer

    def spy(p, x, cfg, capacity_factor=None):
        pr, _ = ref_moe.router_probs(x, p["router"])
        jax.debug.callback(lambda a: probs.append(np.asarray(a)),
                           pr.reshape(-1, pr.shape[-1]), ordered=True)
        return orig(p, x, cfg, capacity_factor=capacity_factor)

    if cfg_r.num_experts:
        cfg_r = dataclasses.replace(cfg_r, remat=False)
        ref_model.moe_layer = spy
    try:
        (loss, aux), g = jax.jit(jax.value_and_grad(
            lambda p, b: ref_model.forward_loss(p, cfg_r, b), has_aux=True))(
                p_r, {k: jnp.asarray(v) for k, v in batch.items()})
        jax.effects_barrier()
    finally:
        ref_model.moe_layer = orig
    grads = {path: np.asarray(a, np.float32)
             for path, a in params.leaves(jax.tree.map(np.asarray, g))}
    return float(loss), {k: float(v) for k, v in aux.items()}, grads, probs


def _port_run(p, cfg, batch, picks=None, dtype=None):
    """The port's loss, aux, gradients (numpy, by path) and each MoE layer's
    router probabilities in forward order. `picks`: {layer: {token: expert
    ids}} taken in place of the port's own at those tokens (its gates
    renormalized over them, as `moe.route` does). `dtype`: the bf16 leaves
    widened to it first."""
    paths, ps = zip(*params.leaves(p))
    free = [(t.to(dtype) if dtype and t.dtype == torch.bfloat16 else t).detach()
            .requires_grad_() for t in ps]
    probs = []
    orig = moe.route

    def route(pr, k):
        gates, idx = orig(pr, k)
        layer = len(probs)
        probs.append(pr.detach().float().numpy())
        forced = (picks or {}).get(layer, {})
        if forced:
            idx = idx.clone()
            for tok, ids in forced.items():
                idx[tok] = torch.as_tensor(ids)
            g = pr.gather(-1, idx)
            gates = g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9)
        return gates, idx

    moe.route = route
    try:
        loss, aux = M.forward_loss(_tree(paths, free), cfg,
                                   {k: torch.as_tensor(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, free)
    finally:
        moe.route = orig
    return (loss.item(), {k: v.item() for k, v in aux.items()},
            {path: g.float().numpy() for path, g in zip(paths, grads)}, probs)


def _top(probs, k):
    """Each token's top-k expert ids (descending, ties to the lower id, as
    `jax.lax.top_k`) and its k-th minus (k+1)-th probability."""
    order = np.argsort(-probs, axis=-1, kind="stable")
    srt = np.take_along_axis(probs, order, -1)
    margin = srt[:, k - 1] - srt[:, k] if probs.shape[-1] > k else np.full(len(probs), 1.0)
    return order[:, :k], margin


def _rel_cos(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    cos = float((got * want).sum() / np.sqrt((got * got).sum() * (want * want).sum() + 1e-60))
    return float(np.abs(got - want).max()) / scale, cos


@pytest.fixture(scope="module")
def batches():
    return {name: next(iter(lm.batches_for(configs.get(name).reduced(), SEQ, BATCH)))
            for name in REFERENCE_ARCHS}


@pytest.mark.parametrize("name", REFERENCE_ARCHS)
def test_loss_and_gradients_match_the_reference(name, batches):
    cfg_r, cfg, p_r, p = model(name)
    batch = batches[name]
    loss_r, aux_r, g_r, probs_r = _ref_run(cfg_r, p_r, batch)
    port_cfg = dataclasses.replace(cfg, remat=False) if cfg.num_experts else cfg
    loss, aux, g, probs = _port_run(p, port_cfg, batch)
    if cfg.num_experts:
        assert len(probs) == len(probs_r) == (cfg.num_layers // cfg.moe_every)
        k = cfg.experts_per_token
        forced = {}
        for layer, (a, b) in enumerate(zip(probs_r, probs)):
            ids_r, _ = _top(a, k)
            ids, margin = _top(b, k)
            differ = np.flatnonzero((np.sort(ids_r, -1) != np.sort(ids, -1)).any(-1))
            assert (margin[differ] < TIE).all(), (layer, differ, margin[differ])
            if len(differ):
                forced[layer] = {int(t): ids_r[t].tolist() for t in differ}
        if forced:
            loss, aux, g, _ = _port_run(p, port_cfg, batch, picks=forced)
    assert abs(loss - loss_r) < LOSS_TOL, (loss, loss_r)
    for key in ("nll", "load_balance", "router_z"):
        assert abs(aux[key] - aux_r[key]) < LOSS_TOL, (key, aux[key], aux_r[key])
    assert g.keys() == g_r.keys()
    g32 = None
    for path, want in g_r.items():
        r, c = _rel_cos(g[path], want)
        if r <= GRAD_REL and c >= GRAD_COS:
            continue
        if g32 is None:  # the same weights in float32 on the port: the yardstick
            g32 = _port_run(p, port_cfg, batch, dtype=torch.float32)[2]
        r_ref, c_ref = _rel_cos(want, g32[path])
        r_port, c_port = _rel_cos(g[path], g32[path])
        assert r_ref > GRAD_REL or c_ref < GRAD_COS, (path, r, c)
        assert r_port <= r_ref and c_port >= c_ref, (path, (r_port, c_port), (r_ref, c_ref))


def _opt_case(seed):
    """Parameters (bf16 and float32 leaves, 1-3 dims) and three steps'
    gradients, numpy (bf16 values held in float32), large enough that the
    global-norm clip acts."""
    rng = np.random.default_rng(seed)
    shapes = {"w": ((64, 96), "bf16"), "stack": ((3, 32, 48), "bf16"), "b": ((96,), "bf16"),
              "router": ((64, 8), "f32"), "u": ((5, 16), "f32"), "w0": ((40,), "f32")}
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    p = {k: (bf(rng.standard_normal(s)) if t == "bf16" else rng.standard_normal(s)
             .astype(np.float32)) for k, (s, t) in shapes.items()}
    gs = [{k: (bf(rng.standard_normal(s) * 3) if t == "bf16" else
               (rng.standard_normal(s) * 3).astype(np.float32)) for k, (s, t) in shapes.items()}
          for _ in range(3)]
    kinds = {k: t for k, (_, t) in shapes.items()}
    return p, gs, kinds


def _to_ref(tree, kinds):
    return {k: jnp.asarray(v, jnp.bfloat16 if kinds[k] == "bf16" else jnp.float32)
            for k, v in tree.items()}


def _to_port(tree, kinds):
    return {k: torch.tensor(v).to(torch.bfloat16 if kinds[k] == "bf16" else torch.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_the_reference(name, clip):
    cfg = optim.OptConfig(name=name, lr=1e-2, warmup_steps=2, decay_steps=10, grad_clip=clip)
    p_np, gs, kinds = _opt_case(3)
    opt_r = ref_optim.make_optimizer(ref_optim.OptConfig(**dataclasses.asdict(cfg)))
    opt = optim.make_optimizer(cfg)
    p_r, p = _to_ref(p_np, kinds), _to_port(p_np, kinds)
    s_r, s = opt_r.init(p_r), opt.init(p)
    for step, g in enumerate(gs):
        p_r, s_r = opt_r.update(_to_ref(g, kinds), s_r, p_r, jnp.int32(step))
        p, s = opt.update(_to_port(g, kinds), s, p, step)
        # The clip scales by 1 / the global norm, which the reference sums in
        # float32 to ~1e-6 of the float64 norm (the port to ~4e-8): the
        # gradients then differ by the two norms' ratio before the update.
        ratio = 1.0
        if clip:
            ratio = float(optim.global_norm(_to_port(g, kinds))) / float(
                ref_optim.global_norm(_to_ref(g, kinds)))
        tol = 1e-6 + 2 * abs(ratio - 1)
        n_bf16 = n_off = 0
        for key in p_np:
            for moment, want in s_r[key].items():
                got = s[key][moment].numpy()
                want = np.asarray(want)
                assert np.abs(got - want).max() <= tol * np.abs(want).max(), (step, key, moment)
            want = np.asarray(p_r[key], np.float32)
            got = p[key].float().numpy()
            if kinds[key] == "f32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
                continue
            off = got != want
            # one bf16 ulp is at most 2^-7 of the value
            assert (np.abs(got - want)[off] <= np.abs(want)[off] * 2.0 ** -7).all(), (step, key)
            n_bf16, n_off = n_bf16 + want.size, n_off + int(off.sum())
        assert n_off <= 1e-3 * n_bf16, (step, n_off, n_bf16)


def test_schedule_and_clipping_match_the_reference():
    cfg = optim.OptConfig(lr=1e-3, warmup_steps=10, decay_steps=100, min_lr_frac=0.1)
    cfg_r = ref_optim.OptConfig(**dataclasses.asdict(cfg))
    for s in (0, 5, 10, 50, 100, 200):
        got = optim.schedule(cfg, s)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(ref_optim.schedule(cfg_r, jnp.int32(s))),
                                   rtol=1.2e-7)
    p_np, gs, kinds = _opt_case(5)
    exact = float(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in gs[0].values())))
    for max_norm in (1.0, 1e3):  # clipping, then not
        clipped_r, n_r = ref_optim.clip_by_global_norm(_to_ref(gs[0], kinds), max_norm)
        clipped, n = optim.clip_by_global_norm(_to_port(gs[0], kinds), max_norm)
        # The port's float32 norm is within an ulp of the float64 one; the
        # reference's sum drifts to ~1e-6 of it, and each clipped leaf with it.
        assert abs(float(n) - exact) <= 1.2e-7 * exact
        assert abs(float(n_r) - exact) <= 4e-6 * exact
        gap = 2 * abs(float(n) / float(n_r) - 1) if max_norm < exact else 0.0
        for key, want in clipped_r.items():
            assert clipped[key].dtype == _to_port(gs[0], kinds)[key].dtype
            want = np.asarray(want, np.float32)
            got = clipped[key].float().numpy()
            # within an ulp of the leaf's type and the norms' gap
            np.testing.assert_allclose(got, want, atol=0, rtol=gap + (
                2.0 ** -7 if kinds[key] == "bf16" else 1.2e-7))


@pytest.mark.parametrize("name", ["qwen2-7b", "llama-3.2-vision-90b", "whisper-base"])
def test_bigram_batches_equal_the_reference(name):
    cfg = configs.get(name).reduced()
    spec = lm.LMSpec(vocab_size=cfg.vocab_size, seq_len=16, global_batch=3, seed=4)
    spec_r = ref_lm.LMSpec(**dataclasses.asdict(spec))
    np.testing.assert_array_equal(lm.BigramStream(spec).successors,
                                  ref_lm.BigramStream(spec_r).successors)
    ours = lm.batches_for(cfg, 32, 2, seed=1)
    theirs = ref_lm.batches_for(cfg, 32, 2, seed=1)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        assert {"tokens", "labels"} <= a.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def _np_leaves(tree):
    """path -> (float32 values, whether the leaf is bf16) of a tree of
    tensors or of jax arrays."""
    out = {}
    for path, x in params.leaves(tree):
        if isinstance(x, torch.Tensor):
            out[path] = (x.float().numpy(), x.dtype == torch.bfloat16)
        else:
            a = np.asarray(x)
            out[path] = (a.astype(np.float32), a.dtype.name == "bfloat16")
    return out


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_restore_across_packages(writer, tmp_path):
    _, _, p_r, p = model("gemma2-9b")
    s_r = jax.tree.map(lambda a: a + 0.25,  # nonzero moments
                       ref_optim.make_optimizer(ref_optim.OptConfig()).init(p_r))
    s = convert.params_from_reference(jax.tree.map(np.asarray, s_r), device="cpu")
    path = str(tmp_path / "ckpt.npz")
    if writer == "reference":
        ref_ckpt.save(path, p_r, s_r, step=11)
        got_p, got_s, step = ckpt.restore(path, p, optim.make_optimizer(
            optim.OptConfig()).init(p))
    else:
        ckpt.save(path, p, s, step=11)
        got_p, got_s, step = ref_ckpt.restore(path, p_r, s_r)
    assert step == 11
    for got, want in ((got_p, p_r), (got_s, s_r)):
        got, want = _np_leaves(got), _np_leaves(want)
        assert got.keys() == want.keys()
        for key, (values, is_bf16) in want.items():
            assert got[key][1] == is_bf16, key
            np.testing.assert_array_equal(got[key][0], values)
