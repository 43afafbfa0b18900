"""The port's main path end to end, on the CPU, at a reduced size.

RLDA fit → refine → view over the wire (client → server), as
`examples/quickstart.py` drives it, cut to about 150 reviews, K = 6 and
10 + 10 sweeps. Held against the JAX package:

  * a JAX-fitted state carried across with `from_reference` gives the
    same core topic ids, top words, signatures (within 1e-6) and top
    reviews, and perplexity within rtol 1e-5;
  * the port's final perplexity, averaged over seeds, lands within 10% of
    the JAX client's average at the same config. The two packages draw
    from different random streams, and at this size the reference's own
    seed-to-seed spread is about 10% of its mean, so a band on a few
    chains cannot be tighter; that the chains are the same chain given
    the same noise is `test_torch_gibbs`'s replay test;
  * a reference client drives a port server over the string transport,
    and a port client drives a reference server, on the exact sweep, on
    `backend="alias"` and on `backend="sparse"` (the phone's sampler),
    including the multi-model `fit_batch` / `refine_batch` verbs (`auto`
    resolves them to `batched`);
  * a reference client is served by the mesh tiers — `backend="pserver"`,
    `backend="distributed"`, and `device_kind="pod"` (which `auto` resolves
    to `pserver`, as the reference's router does);
  * `backend="auto"` routes a fit of >= 100k tokens to `alias`, as the
    reference's router does, and AliasLDA at 100 sweeps lands within 0.3
    in log perplexity of the exact sweep at 30 (the reference's
    mixing-matched budgets and band).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
from repro.core import coreset as ref_coreset  # noqa: E402
from repro.core import views as ref_views  # noqa: E402
from repro.data import reviews as ref_reviews  # noqa: E402
from repro_torch.api import VedaliaClient, VedaliaServer, backends, protocol  # noqa: E402
from repro_torch.core import codec, types  # noqa: E402
from repro_torch.data import reviews  # noqa: E402

SPEC = dict(num_reviews=150, vocab_size=300, num_topics=6, seed=12)
FIT = dict(num_topics=6, base_vocab=300, w_bits=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus():
    return reviews.generate(reviews.SyntheticSpec(**SPEC))


def _invariants(server, handle_id):
    h = server.service.handles[handle_id]
    cfg, corp, state = h.cfg, h.model.corpus, h.model.state
    n_t = codec.decode_array(cfg, state.n_t)
    # Fixed point rounds each of the K totals by at most half a unit.
    assert abs(float(n_t.sum()) - float(corp.weights.double().sum())) <= \
        cfg.num_topics / (1 << (cfg.w_bits + 1)) + 1e-3
    rebuilt = codec.rebuild_state(cfg, corp, state.z)
    for f in ("n_dt", "n_wt", "n_t"):
        assert torch.equal(getattr(rebuilt, f), getattr(state, f)), f
    assert state.z.device.type == "cpu"


def test_port_client_server_main_path(corpus):
    client = VedaliaClient(device="cpu", backend="jnp")  # the reference's name, an alias
    info = client.hello()
    assert info.backends == ["alias", "batched", "cuda", "distributed", "pserver", "sparse",
                             "torch"]
    fit = client.fit(corpus.reviews[:130], num_sweeps=10, seed=0, **FIT)
    assert fit.backend == "torch" and fit.sweeps_run == 10
    fit = client.refine(fit.handle_id, num_sweeps=10, seed=1)
    assert fit.sweeps_run == 20 and np.isfinite(fit.perplexity)
    _invariants(client.server, fit.handle_id)

    sync = client.sync_view(fit.handle_id, top_n=8, mass_coverage=0.9, max_topics=4)
    assert sync.valid and not sync.delta and 1 <= len(sync.topics) <= 4
    assert [t.topic_id for t in sync.topics] == sync.topic_ids
    again = client.sync_view(fit.handle_id, top_n=8, mass_coverage=0.9, max_topics=4)
    assert again.delta and len(again.topics) == 0  # unchanged model: 0 topics re-sent
    assert again.payload_bytes < sync.payload_bytes

    top = client.top_reviews(fit.handle_id, sync.topic_ids[0], n=3)
    assert len(top.review_ids) == 3
    assert client.perplexity(fit.handle_id) == pytest.approx(fit.perplexity)

    upd = client.update(fit.handle_id, corpus.reviews[130:], seed=2)
    assert upd.num_new_reviews == 20 and upd.kind == "incremental"
    assert np.isfinite(upd.perplexity)
    _invariants(client.server, fit.handle_id)
    assert client.server.service.handles[fit.handle_id].num_reviews == 150

    # A fresh fit on the single-launch backend (plain version on the CPU).
    fit2 = client.fit(corpus.reviews, num_sweeps=3, seed=3, backend="pallas", **FIT)
    assert fit2.backend == "cuda"
    _invariants(client.server, fit2.handle_id)


def test_port_perplexity_within_band_of_reference(corpus):
    ref_client = ref_api.VedaliaClient()
    port_client = VedaliaClient(device="cpu")
    seeds = range(6)
    ref_ppx, port_ppx = [], []
    for seed in seeds:
        f = ref_client.fit(corpus.reviews, num_sweeps=10, seed=seed, **FIT)
        ref_ppx.append(ref_client.refine(f.handle_id, 10, seed=seed + 100).perplexity)
        g = port_client.fit(corpus.reviews, num_sweeps=10, seed=seed, **FIT)
        port_ppx.append(port_client.refine(g.handle_id, 10, seed=seed + 100).perplexity)
    ref_mean, port_mean = np.mean(ref_ppx), np.mean(port_ppx)
    assert abs(port_mean - ref_mean) / ref_mean < 0.10, (ref_ppx, port_ppx)


def test_carried_state_serves_the_same_views(corpus):
    ref_server = ref_api.VedaliaServer()
    ref_client = ref_api.VedaliaClient(server=ref_server)
    ref_revs = ref_reviews.generate(ref_reviews.SyntheticSpec(**SPEC)).reviews
    fit = ref_client.fit(ref_revs, num_sweeps=20, seed=4, **FIT)
    ref_handle = ref_server.service.handles[fit.handle_id]
    ref_prep, ref_state = ref_handle.prep, ref_handle.state

    server = VedaliaServer(device="cpu")
    prep = server.service.prepare(corpus.reviews, base_vocab=300, num_topics=6, w_bits=8)
    fields = {f: getattr(ref_prep.cfg, f) for f in
              ("num_topics", "vocab_size", "num_docs", "alpha", "beta", "w_bits")}
    cfg, carried_corpus, state = types.from_reference(
        fields, {f: np.asarray(getattr(ref_prep.corpus, f)) for f in ("docs", "words", "weights")},
        {f: np.asarray(getattr(ref_state, f)) for f in ("z", "n_dt", "n_wt", "n_t")},
        device="cpu")
    assert cfg == prep.cfg
    assert torch.equal(carried_corpus.words, prep.corpus.words)
    handle = server.service.adopt(prep, state)

    view = server.service.view(handle, top_n=8)
    ref_core, _ = ref_coreset.select_core_set(ref_prep.cfg, ref_state)
    ref_view = ref_views.build_view(ref_prep, ref_state, ref_core, top_n=8)
    assert view.topic_ids == ref_core
    for t, r in zip(view.view.topics, ref_view.topics):
        assert t.top_words == r.top_words
        sig, ref_sig = ref_views.topic_signature(r), ref_views.topic_signature(t)
        np.testing.assert_allclose(sig["top_word_weights"], ref_sig["top_word_weights"],
                                   rtol=0, atol=1e-6)
        assert t.probability == pytest.approx(r.probability, abs=1e-6)
        assert t.expected_rating == pytest.approx(r.expected_rating, abs=1e-6)
        assert t.expected_helpful == pytest.approx(r.expected_helpful, abs=1e-6)
    for t in ref_core:
        assert server.service.top_reviews(handle, t, n=5).review_ids == \
            ref_views.top_reviews_for_topic(ref_prep, ref_state, t, n=5)
    np.testing.assert_allclose(server.service.perplexity(handle),
                               ref_server.service.perplexity(ref_handle), rtol=1e-5)


def test_reference_client_drives_port_server(corpus):
    server = VedaliaServer(device="cpu")
    client = ref_api.VedaliaClient(transport=server.handle_raw)
    ref_revs = ref_reviews.generate(ref_reviews.SyntheticSpec(**SPEC)).reviews
    info = client.hello()
    assert "torch" in info.backends
    fit = client.fit(ref_revs, num_sweeps=5, seed=0, backend="jnp", **FIT)
    assert fit.backend == "torch" and np.isfinite(fit.perplexity)
    sync = client.sync_view(fit.handle_id, top_n=5)
    assert sync.valid and sync.topics
    assert len(client.sync_view(fit.handle_id, top_n=5).topics) == 0
    assert client.top_reviews(fit.handle_id, sync.topic_ids[0], n=2).review_ids
    # State crosses the wire in the reference client's types.
    exported = client.export_model(fit.handle_id)
    assert np.asarray(exported.state.n_wt).dtype == np.int32
    assert client.spot_check(fit.handle_id, exported.state).valid
    # The multi-model verbs: one fit per set, in order, on `auto` (which
    # resolves to `batched`) and on `alias`; then a coalesced refit.
    sets = [ref_revs[:20], ref_revs[20:45], ref_revs[45:60]]
    for backend, resolved in (("auto", "batched"), ("alias", "alias")):
        fits = client.fit_batch(sets, num_sweeps=2, seed=3, backend=backend, **FIT)
        assert [f.backend for f in fits] == [resolved] * 3
        assert [f.num_reviews for f in fits] == [len(rs) for rs in sets]
        assert all(f.sweeps_run == 2 and np.isfinite(f.perplexity) for f in fits)
        refined = client.refine_batch([f.handle_id for f in fits], 3, backend=backend)
        assert [r.handle_id for r in refined] == [f.handle_id for f in fits]
        assert all(r.sweeps_run == 5 and r.backend == resolved for r in refined)
        for f in fits:
            _invariants(server, f.handle_id)
        assert client.sync_view(fits[1].handle_id, top_n=5).valid


def test_port_client_drives_reference_server(corpus):
    ref_server = ref_api.VedaliaServer()
    client = VedaliaClient(transport=ref_server.handle_raw)
    fit = client.fit(corpus.reviews, num_sweeps=5, seed=0, **FIT)
    assert fit.backend == "jnp" and np.isfinite(fit.perplexity)
    sync = client.sync_view(fit.handle_id, top_n=5)
    assert sync.valid and sync.topics
    assert len(client.sync_view(fit.handle_id, top_n=5).topics) == 0
    exported = client.export_model(fit.handle_id)
    assert exported.state.z.dtype == torch.int32 and exported.corpus.docs.device.type == "cpu"
    res = client.adopt_state(fit.handle_id, exported.state)
    assert res.handle_id == fit.handle_id
    sets = [corpus.reviews[:20], corpus.reviews[20:50]]
    fits = client.fit_batch(sets, num_sweeps=2, seed=1, backend="auto", **FIT)
    assert [f.backend for f in fits] == ["batched", "batched"]
    assert [f.num_reviews for f in fits] == [20, 30]
    refined = client.refine_batch([f.handle_id for f in fits], 2)
    assert [r.sweeps_run for r in refined] == [4, 4]


def test_server_answers_every_verb():
    server = VedaliaServer(device="cpu")
    for kind in protocol.KINDS:
        assert callable(getattr(server, f"_handle_{kind}", None)), kind
    import repro.api.protocol as ref_protocol

    assert protocol.KINDS == ref_protocol.KINDS
    assert protocol.PROTOCOL_VERSION == ref_protocol.PROTOCOL_VERSION
    for verb in ("fit_batch", "refine_batch"):
        out = protocol.parse_request(protocol.make_request(verb, {}))
        assert out[0] == verb
    # The multi-model verbs answer: malformed requests are typed errors.
    for verb, payload, code in (("fit_batch", {}, "bad_request"),
                                ("fit_batch", {"review_sets": []}, "invalid_argument"),
                                ("refine_batch", {"handle_ids": [], "num_sweeps": 1},
                                 "invalid_argument"),
                                ("refine_batch", {"handle_ids": [7], "num_sweeps": 1},
                                 "not_found")):
        raw = server.handle_raw(protocol.make_request(verb, payload))
        with pytest.raises(protocol.RemoteError) as e:
            protocol.parse_response(raw, expect_kind=verb)
        assert e.value.code == code, (verb, payload, str(e.value))


def test_backend_registry_aliases_and_routing():
    assert backends.available_backends() == ["alias", "batched", "cuda", "distributed",
                                             "pserver", "sparse", "torch"]
    assert "sparse" in ref_api.available_backends()
    assert backends.canonical("jnp") == "torch" and backends.canonical("pallas") == "cuda"
    assert type(backends.get_backend("pallas")).__name__ == "CudaSampler"
    assert type(backends.get_backend("alias")).__name__ == "AliasSampler"
    assert type(backends.get_backend("sparse")).__name__ \
        == type(ref_api.get_backend("sparse")).__name__ == "SparseSampler"
    caps = backends.backend_capabilities("alias")
    assert caps.proposal_based and caps.device_kind == "gpu"
    # The packed-table sweeps honor every mode, as the reference's do.
    assert caps.quant_modes == ref_api.backend_capabilities("alias").quant_modes \
        == ("f32", "fixed", "int8", "int4_packed")
    assert backends.backend_capabilities("pallas").quant_modes \
        == ref_api.backend_capabilities("pallas").quant_modes
    # The reference's routing order; names the port lacks fall to the oracle.
    assert backends.select_backend(num_tokens=10) == "torch"
    assert backends.select_backend(num_tokens=200_000) == "alias"
    assert backends.select_backend(num_tokens=600_193) == "alias"
    assert ref_api.select_backend(num_tokens=600_193) == "alias"
    assert backends.select_backend(num_tokens=200_000, task="update") == "torch"
    assert backends.select_backend(num_models=3) == "batched"
    assert backends.select_backend(num_models=2) == ref_api.select_backend(num_models=2) \
        == "batched"
    assert backends.select_backend(num_models=2, task="update") == "batched"
    assert backends.select_backend(num_models=2, device_kind="gpu") == "batched"
    assert backends.select_backend(num_models=2, available=["torch"]) == "torch"
    assert type(backends.get_backend("batched")).__name__ == "BatchedSampler"
    assert backends.backend_capabilities("batched").device_kind == "gpu"
    assert backends.select_backend(device_kind="phone") \
        == ref_api.select_backend(device_kind="phone") == "sparse"
    assert backends.select_backend(device_kind="tpu") == "torch"
    # The mesh tiers: the pod route is the parameter server in both packages.
    assert backends.select_backend(device_kind="pod") \
        == ref_api.select_backend(device_kind="pod") == "pserver"
    for name in ("pserver", "distributed"):
        assert backends.backend_capabilities(name).device_kind == "pod"
        assert type(backends.get_backend(name)).__name__ \
            == type(ref_api.get_backend(name)).__name__
    assert backends.select_backend(num_tokens=200_000, available=["alias", "torch"]) == "alias"
    assert backends.select_backend(num_tokens=200_000, available=["cuda", "torch"]) == "torch"
    assert backends.select_backend(task="update", available=["alias", "torch"]) == "torch"
    server = VedaliaServer(device="cpu")
    with pytest.raises(ValueError):
        server._backend_arg({"backend": "nope"})
    assert server._backend_arg({"backend": "pallas"}) == "pallas"
    assert server._backend_arg({"backend": "alias"}) == "alias"
    assert server._backend_arg({"backend": "pserver"}) == "pserver"


def test_alias_quality_matches_the_exact_sweep():
    """The reference's mixing-matched budgets and band
    (`tests/test_api.py::test_fast_sampler_perplexity_parity_with_oracle`):
    AliasLDA's MH chain at 100 sweeps lands within 0.3 in log perplexity of
    the exact sweep at 30 on a small RLDA corpus. Log perplexity is averaged
    over six seeds on each side: at this size the exact sweep's 30-sweep
    chains alone spread from 87 to 119 across seeds."""
    from repro_torch.api.backends import get_backend
    from repro_torch.core import perplexity, rlda

    revs = reviews.generate(reviews.SyntheticSpec(
        num_reviews=60, vocab_size=120, num_topics=4, mean_tokens=30, seed=0)).reviews
    prep = rlda.prepare(revs, base_vocab=120, num_topics=8, w_bits=8, device="cpu")
    log_ppx = {}
    for name, sweeps in {"torch": 30, "alias": 100}.items():
        log_ppx[name] = np.mean([np.log(perplexity.perplexity(
            prep.cfg, get_backend(name).run(prep.cfg, prep.corpus,
                                            torch.Generator().manual_seed(seed), sweeps),
            prep.corpus)) for seed in range(6)])
    assert abs(log_ppx["alias"] - log_ppx["torch"]) < 0.3, log_ppx


def test_alias_round_trips_across_frameworks(corpus):
    """A reference client fits on a port server with `backend="alias"`, and
    a port client on a reference server; either handle refines on alias."""
    server = VedaliaServer(device="cpu")
    ref_client = ref_api.VedaliaClient(transport=server.handle_raw)
    ref_revs = ref_reviews.generate(ref_reviews.SyntheticSpec(**SPEC)).reviews
    fit = ref_client.fit(ref_revs, num_sweeps=5, seed=0, backend="alias", **FIT)
    assert fit.backend == "alias" and np.isfinite(fit.perplexity)
    fit = ref_client.refine(fit.handle_id, num_sweeps=3, seed=1)
    assert fit.backend == "alias" and fit.sweeps_run == 8
    _invariants(server, fit.handle_id)
    sync = ref_client.sync_view(fit.handle_id, top_n=5)
    assert sync.valid and sync.topics
    exported = ref_client.export_model(fit.handle_id)
    assert np.asarray(exported.state.n_wt).dtype == np.int32
    assert ref_client.spot_check(fit.handle_id, exported.state).valid

    ref_server = ref_api.VedaliaServer()
    client = VedaliaClient(transport=ref_server.handle_raw)
    fit = client.fit(corpus.reviews, num_sweeps=5, seed=0, backend="alias", **FIT)
    assert fit.backend == "alias" and np.isfinite(fit.perplexity)
    fit = client.refine(fit.handle_id, num_sweeps=3, seed=1)
    assert fit.backend == "alias" and fit.sweeps_run == 8
    sync = client.sync_view(fit.handle_id, top_n=5)
    assert sync.valid and sync.topics


def test_sparse_round_trips_across_frameworks():
    """A reference client asks a port server for `backend="sparse"` (the
    phone's sampler): the fit, an update and a refine run there, the view
    syncs, and the exported state passes the reference client's spot check;
    a port client does the same on a reference server."""
    spec = dict(num_reviews=40, vocab_size=120, num_topics=4, seed=5)
    fit_kw = dict(num_topics=4, base_vocab=120, w_bits=8)
    server = VedaliaServer(device="cpu")
    ref_client = ref_api.VedaliaClient(transport=server.handle_raw)
    ref_revs = ref_reviews.generate(ref_reviews.SyntheticSpec(**spec)).reviews
    fit = ref_client.fit(ref_revs[:30], num_sweeps=4, seed=0, backend="sparse", **fit_kw)
    assert fit.backend == "sparse" and np.isfinite(fit.perplexity)
    upd = ref_client.update(fit.handle_id, ref_revs[30:], backend="sparse")
    assert upd.backend == "sparse" and np.isfinite(upd.perplexity)
    fit = ref_client.refine(fit.handle_id, num_sweeps=2, seed=1, backend="sparse")
    assert fit.backend == "sparse"
    _invariants(server, fit.handle_id)
    assert ref_client.sync_view(fit.handle_id, top_n=5).valid
    exported = ref_client.export_model(fit.handle_id)
    assert ref_client.spot_check(fit.handle_id, exported.state).valid

    revs = reviews.generate(reviews.SyntheticSpec(**spec)).reviews
    client = VedaliaClient(transport=ref_api.VedaliaServer().handle_raw)
    fit = client.fit(revs, num_sweeps=4, seed=0, backend="sparse", **fit_kw)
    assert fit.backend == "sparse" and np.isfinite(fit.perplexity)
    assert client.sync_view(fit.handle_id, top_n=5).valid


def test_auto_routes_a_large_fit_to_alias_and_refines_there():
    """`backend="auto"` on a fit of >= 100k tokens resolves to `alias`, as
    the reference's router does; the handle keeps refining on alias."""
    from repro_torch.api.service import VedaliaService

    big = reviews.generate(reviews.SyntheticSpec(
        num_reviews=1700, vocab_size=300, num_topics=6, mean_tokens=60, seed=3)).reviews
    service = VedaliaService(device="cpu", backend="auto")
    prep = service.prepare(big, base_vocab=300, num_topics=6, w_bits=8)
    assert prep.corpus.num_tokens >= 100_000
    handle = service.fit_prepared(prep, num_sweeps=1, seed=0)
    assert handle.backend == "alias"
    service.refine(handle, 1, seed=1)
    assert handle.backend == "alias" and handle.sweeps_run == 2
    small = service.fit(big[:50], base_vocab=300, num_topics=6, num_sweeps=1, seed=2)
    assert small.backend == "torch"


def test_reference_client_drives_the_mesh_tiers_on_a_port_server():
    """A reference client asks a port server for `backend="pserver"` (four
    stacked workers on a (2, 2) grid, staleness 2), for
    `backend="distributed"`, and for `device_kind="pod"` under `auto`: each
    fit and refine runs there, the counts rebuild exactly from z, the view
    syncs and the exported state passes the reference client's spot check."""
    server = VedaliaServer(device="cpu", backend_opts={
        "pserver": {"workers": (2, 2), "staleness": 2}})
    client = ref_api.VedaliaClient(transport=server.handle_raw)
    revs = ref_reviews.generate(ref_reviews.SyntheticSpec(**SPEC)).reviews
    fit_kw = dict(FIT, w_bits=None)  # float32 counts: whole windows, one program a call
    for kw, resolved in ((dict(backend="pserver", **fit_kw), "pserver"),
                         (dict(backend="distributed", **FIT), "distributed"),
                         (dict(backend="auto", device_kind="pod", **FIT), "pserver")):
        fit = client.fit(revs, num_sweeps=4, seed=0, **kw)
        assert fit.backend == resolved and np.isfinite(fit.perplexity)
        fit = client.refine(fit.handle_id, num_sweeps=3, seed=1)
        assert fit.backend == resolved and fit.sweeps_run == 7
        h = server.service.handles[fit.handle_id]
        rebuilt = codec.rebuild_state(h.cfg, h.model.corpus, h.model.state.z)
        for f in ("n_dt", "n_wt", "n_t"):
            np.testing.assert_allclose(getattr(rebuilt, f).numpy(),
                                       getattr(h.model.state, f).numpy(), rtol=1e-5, atol=1e-4)
        assert client.sync_view(fit.handle_id, top_n=5).valid
        exported = client.export_model(fit.handle_id)
        assert client.spot_check(fit.handle_id, exported.state).valid
    assert type(server.service.sampler("pserver")._fit.comm).__name__ == "Stacked"
    assert server.service.sampler("pserver")._fit.comm.n_workers == 4
