"""The port's transformer serving engine and launcher (hybrid family, CPU).

Follows the reference's `tests/test_serving.py` on the port's reduced
Zamba2: the engine's greedy output equals a manual prefill + argmax
decode, lockstep batching changes no request's tokens, waves bucket by
(prompt length, temperature), and `launch.serve` runs end to end with
`--device cpu`. Greedy decoding is deterministic, so these hold exactly;
sampled tokens are held to the vocabulary and to their seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import Engine, Request, Result  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    cfg = configs.get("zamba2-2.7b").reduced()
    return cfg, M.init_model(cfg, seed=0, device="cpu")


def _engine(model, **kw):
    cfg, params = model
    return Engine(cfg, params, device="cpu", **{"cache_len": 64, "max_batch": 2, **kw})


def test_engine_matches_manual_greedy_decode(model):
    cfg, params = model
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 24).astype(np.int32)
    eng = _engine(model)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=6))
    res = eng.run()[0]
    assert isinstance(res, Result) and res.prefill_s > 0 and res.decode_s > 0

    cache, logits = M.prefill(params, cfg, {"tokens": torch.tensor(prompt)[None]}, 64)
    toks = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(6):
        toks.append(int(tok[0]))
        if i < 5:
            cache, logits = M.decode_step(params, cfg, cache, tok, 24 + i)
            tok = torch.argmax(logits, -1).to(torch.int32)
    np.testing.assert_array_equal(res.tokens, np.asarray(toks, np.int32))


def test_batched_equals_single_request(model):
    """Lockstep batching must not change any request's greedy output."""
    cfg, _ = model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32) for _ in range(3)]
    single = []
    for i, p in enumerate(prompts):
        eng = _engine(model, max_batch=1)
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
        single.append(eng.run()[0].tokens)
    eng = _engine(model, max_batch=3)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
    res = eng.run()
    assert len({r.wave_id for r in res}) == 1
    batched = {r.uid: r.tokens for r in res}
    for i in range(3):
        np.testing.assert_array_equal(batched[i], single[i])


def test_length_bucketing(model):
    cfg, _ = model
    rng = np.random.default_rng(2)
    eng = _engine(model, max_batch=8)
    for i, ln in enumerate([8, 16, 8, 16, 8]):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, ln)
                           .astype(np.int32), max_new_tokens=3))
    res = eng.run()
    assert {r.uid for r in res} == set(range(5))
    assert len({r.wave_id for r in res}) == 2  # one wave per prompt length
    for r in res:
        assert r.tokens.shape == (3,)
        assert np.all(r.tokens >= 0) and np.all(r.tokens < cfg.vocab_size)


def test_temperature_bucketing_preserves_greedy(model):
    """A temperature > 0 request never shares a wave (or its sampling step)
    with greedy ones; sampled tokens repeat under the same seed."""
    cfg, _ = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 12).astype(np.int32) for _ in range(3)]

    def mixed(seed):
        eng = _engine(model, max_batch=8, seed=seed)
        eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=4))
        eng.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=4, temperature=0.9))
        eng.submit(Request(uid=2, prompt=prompts[2], max_new_tokens=4))
        return {r.uid: r.tokens for r in eng.run()}

    first = mixed(0)
    for uid in (0, 2):
        solo = _engine(model, max_batch=1)
        solo.submit(Request(uid=uid, prompt=prompts[uid], max_new_tokens=4))
        np.testing.assert_array_equal(first[uid], solo.run()[0].tokens)
    assert first[1].shape == (4,) and np.all((first[1] >= 0) & (first[1] < cfg.vocab_size))
    np.testing.assert_array_equal(mixed(0)[1], first[1])


def test_admission_rejects_a_request_past_the_cache(model):
    eng = _engine(model)
    with pytest.raises(ValueError, match="exceeds the cache"):
        eng.submit(Request(uid=0, prompt=np.zeros(60, np.int32), max_new_tokens=5))
    assert eng.pending() == 0


def test_launch_serve_runs_end_to_end_on_the_cpu(capsys):
    from repro_torch.launch import serve

    results = serve.main(["--arch", "zamba2-2.7b", "--requests", "3", "--prompt-len", "16",
                          "--max-new", "4", "--cache-len", "64", "--max-batch", "2",
                          "--device", "cpu"])
    assert len(results) == 3 and all(r.tokens.shape == (4,) for r in results)
    out = capsys.readouterr().out
    assert "zamba2-2.7b-smoke on cpu" in out and "aggregate decode throughput" in out


@pytest.fixture(scope="module", params=["qwen2-7b", "gemma2-9b", "rwkv6-1.6b"])
def family_model(request):
    """A reduced dense (qwen2, gemma2's local/global pairs) or ssm (rwkv6)
    model: the engine serves every ported family unchanged."""
    cfg = configs.get(request.param).reduced()
    return cfg, M.init_model(cfg, seed=0, device="cpu")


def test_engine_serves_each_family(family_model):
    """Greedy output equals a manual prefill + argmax decode, and a batched
    wave equals each request served alone; the 70-token prompt plus its
    decode steps wraps gemma2's reduced 64-slot ring."""
    cfg, params = family_model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 70).astype(np.int32) for _ in range(2)]
    eng = Engine(cfg, params, device="cpu", cache_len=96, max_batch=2)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
    res = {r.uid: r for r in eng.run()}
    assert len({r.wave_id for r in res.values()}) == 1
    for i, p in enumerate(prompts):
        cache, logits = M.prefill(params, cfg, {"tokens": torch.tensor(p)[None]}, 96)
        toks = []
        tok = torch.argmax(logits, -1).to(torch.int32)
        for j in range(4):
            toks.append(int(tok[0]))
            if j < 3:
                cache, logits = M.decode_step(params, cfg, cache, tok, 70 + j)
                tok = torch.argmax(logits, -1).to(torch.int32)
        np.testing.assert_array_equal(res[i].tokens, np.asarray(toks, np.int32))


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-1.6b"])
def test_launch_serve_runs_each_family_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    results = serve.main(["--arch", arch, "--requests", "3", "--prompt-len", "16",
                          "--max-new", "4", "--cache-len", "64", "--max-batch", "2",
                          "--temperature", "0.7", "--device", "cpu"])
    assert len(results) == 3 and all(r.tokens.shape == (4,) for r in results)
    out = capsys.readouterr().out
    assert f"{arch}-smoke on cpu" in out and "aggregate decode throughput" in out
