"""The port's streaming tier (`repro_torch.stream`) vs the JAX reference.

Both sides take the same events (the reference's and the port's
`synthetic_events` are held equal event for event first), at small sizes on
the CPU with one torch thread.

What is held, and how:
  * sources and router: equal to the reference's exactly (events, ring
    placement, remapping on membership change, both backpressure policies);
  * the scheduler on port servers: every acked review is applied, the
    staleness budget holds, and under the `always` and `never` policies its
    fit / update / refit counts equal the reference's on the same events
    (they depend on the event times alone). Under `drift` only these
    invariants hold: the refit decisions read the models, and the port's
    and the reference's chains differ (torch's and JAX's random streams);
  * snapshots: a round trip is codec-exact (plain dict equality), and the
    format is shared, so a reference snapshot restores into a port server
    and the reverse, each re-snapshot equal to the original with backend
    names compared after `canonical()` (`jnp` is `torch`, `pallas` is
    `cuda`);
  * a restored handle whose config carries a packed `QuantSpec` refines on
    `cuda` through the packed-table branch.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
import repro.stream as ref_stream  # noqa: E402
from repro.data import reviews as ref_reviews  # noqa: E402
from repro_torch.api import VedaliaClient, VedaliaServer, backends  # noqa: E402
from repro_torch.core.quant import QuantSpec  # noqa: E402
from repro_torch.data import reviews  # noqa: E402
from repro_torch.kernels.lda_gibbs import ops as lda_ops  # noqa: E402
from repro_torch.obs import config as obs_config  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402
from repro_torch.stream import (  # noqa: E402
    IncrementalScheduler,
    ReviewEvent,
    StreamRouter,
    StreamSpec,
    load_events,
    pump,
    replay,
    restore_from_json,
    restore_server,
    save_events,
    snapshot_server,
    snapshot_to_json,
    synthetic_events,
)

QUICK = dict(num_products=3, duration=30.0, rate=2.0, shape="burst", shift_at=15.0, seed=0)
FIT = dict(num_topics=4, num_sweeps=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reviews(n=20, vocab=120, seed=0):
    return reviews.generate(reviews.SyntheticSpec(
        num_reviews=n, vocab_size=vocab, num_topics=4, mean_tokens=25, seed=seed)).reviews


def _server(**kw):
    return VedaliaServer(device="cpu", backend="torch", num_sweeps=4, update_sweeps=1, **kw)


def _ref_server(**kw):
    return ref_api.VedaliaServer(backend="jnp", num_sweeps=4, update_sweeps=1, **kw)


def _same_review(a, b):
    np.testing.assert_array_equal(np.asarray(a.tokens), np.asarray(b.tokens))
    assert (a.rating, a.user, a.helpful, a.unhelpful) == \
        (b.rating, b.user, b.helpful, b.unhelpful)


# -- sources -----------------------------------------------------------------


@pytest.mark.parametrize("shape,shift_at", [("burst", 15.0), ("diurnal", None),
                                            ("uniform", 10.0)])
def test_synthetic_events_equal_the_reference(shape, shift_at):
    spec = dict(QUICK, shape=shape, shift_at=shift_at)
    got = synthetic_events(StreamSpec(**spec))
    want = ref_stream.synthetic_events(ref_stream.StreamSpec(**spec))
    assert len(got) == len(want) > 20
    for a, b in zip(got, want):
        assert (a.seq, a.t, a.product_id) == (b.seq, b.t, b.product_id)
        _same_review(a.review, b.review)


def test_event_files_replay_across_packages(tmp_path):
    events = synthetic_events(StreamSpec(**QUICK))[:12]
    path = str(tmp_path / "stream.jsonl")
    assert save_events(events, path) == 12
    for loaded in (load_events(path), ref_stream.load_events(path)):
        assert [(e.seq, e.t, e.product_id) for e in loaded] == \
            [(e.seq, e.t, e.product_id) for e in events]
        for a, b in zip(loaded, events):
            _same_review(a.review, b.review)
    ref_path = str(tmp_path / "ref.jsonl")
    ref_stream.save_events(ref_stream.load_events(path), ref_path)
    assert open(ref_path).read() == open(path).read()
    assert [e.seq for e in replay(ref_path, limit=3)] == [0, 1, 2]


# -- router ------------------------------------------------------------------


def test_routing_and_remapping_equal_the_reference():
    got, want = StreamRouter([0, 1, 2, 3]), ref_stream.StreamRouter([0, 1, 2, 3])
    pids = range(300)
    assert [got.route(p) for p in pids] == [want.route(p) for p in pids]
    got.add_shard(4)
    want.add_shard(4)
    assert [got.route(p) for p in pids] == [want.route(p) for p in pids]
    got.remove_shard(1)
    want.remove_shard(1)
    assert [got.route(p) for p in pids] == [want.route(p) for p in pids]
    assert got.shard_ids == want.shard_ids == [0, 2, 3, 4]


@pytest.mark.parametrize("policy", ["drop_oldest", "block"])
def test_backpressure_policies_behave_as_the_reference(policy):
    events = synthetic_events(StreamSpec(**QUICK))[:40]
    ref_events = ref_stream.synthetic_events(ref_stream.StreamSpec(**QUICK))[:40]
    got = StreamRouter([0, 1], capacity=3, policy=policy)
    want = ref_stream.StreamRouter([0, 1], capacity=3, policy=policy)
    for i, (e, r) in enumerate(zip(events, ref_events)):
        assert got.offer(e) == want.offer(r)
        if i % 7 == 6:  # a scheduler step drains one shard, part of the other
            assert [x.seq for x in got.drain(0)] == [x.seq for x in want.drain(0)]
            assert [x.seq for x in got.drain(1, max_events=1)] == \
                [x.seq for x in want.drain(1, max_events=1)]
        assert got.oldest_event_time(0) == want.oldest_event_time(0)
    g, w = got.stats(), want.stats()
    assert (g.routed, g.dropped, g.refused, g.depths) == (w.routed, w.dropped, w.refused,
                                                          w.depths)
    assert (g.dropped if policy == "drop_oldest" else g.refused) > 0
    orphans = got.remove_shard(0)
    assert [e.seq for e in orphans] == [e.seq for e in want.remove_shard(0)]


# -- scheduler ---------------------------------------------------------------


def _scheduler(clients, router, policy="drift", cls=IncrementalScheduler, **kw):
    args = dict(microbatch=6, min_fit_reviews=8, staleness_budget=8.0, refit_sweeps=3,
                refit_policy=policy,
                fit_kwargs=dict(FIT, base_vocab=StreamSpec().vocab_size))
    return cls(clients, router, **{**args, **kw})


@pytest.fixture(scope="module")
def drift_run():
    """One drift-policy pipeline over a concept-shifted stream, on two
    port servers (CPU)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    events = synthetic_events(StreamSpec(**QUICK))
    router = StreamRouter([0, 1], capacity=32)
    servers = {s: _server() for s in (0, 1)}
    clients = {s: VedaliaClient(server=servers[s]) for s in (0, 1)}
    scheduler = _scheduler(clients, router)
    pump(events, router, scheduler, step_interval=2.0)
    yield events, router, servers, clients, scheduler
    torch.set_num_threads(prev)


def test_scheduler_on_port_servers_applies_every_acked_review(drift_run):
    events, router, servers, clients, scheduler = drift_run
    st = scheduler.stats
    assert st.fits >= 2 and st.updates >= 3
    assert st.refits <= st.updates
    assert st.events_applied + st.events_held_out == len(events)
    assert router.stats().total_queued == 0
    for status in scheduler.products.values():
        assert status.handle_id is not None and status.signatures
        assert not status.unapplied_ts and not status.pending_fit
        # Every review the server acked was folded into the model.
        stats = clients[status.shard_id].stats()
        assert stats.ingest_queued.get(status.handle_id, 0) == 0
        assert stats.ingest_acked.get(status.handle_id, 0) == status.acked
        assert clients[status.shard_id].sync_view(status.handle_id).valid
        ppx = clients[status.shard_id].perplexity(status.handle_id, reviews=status.heldout)
        assert np.isfinite(ppx)
    # The served models live on the servers' device.
    for server in servers.values():
        for handle in server.service.handles.values():
            assert handle.state.n_wt.device.type == "cpu"


def test_scheduler_meets_the_staleness_budget(drift_run):
    _, _, _, _, scheduler = drift_run
    st = scheduler.stats
    assert len(st.staleness) == st.events_applied
    assert st.staleness_p(50) <= st.staleness_p(99)
    assert st.staleness_p(99) <= scheduler.staleness_budget + 2.0 + 1e-6


_COUNTS = ("fits", "updates", "refits", "refit_launches", "coalesced_refits",
           "forced_by_staleness", "events_applied", "events_held_out", "overloaded_retries",
           "drift_triggers", "ppx_triggers")


@pytest.mark.parametrize("policy", ["always", "never"])
def test_policy_counts_equal_the_reference(policy):
    spec = dict(QUICK, num_products=2, duration=16.0, shift_at=None)
    events = synthetic_events(StreamSpec(**spec))
    ref_events = ref_stream.synthetic_events(ref_stream.StreamSpec(**spec))
    kw = dict(microbatch=5, min_fit_reviews=6, staleness_budget=6.0, refit_sweeps=2)

    router = StreamRouter([0], capacity=32)
    sched = _scheduler({0: VedaliaClient(server=_server())}, router, policy, **kw)
    pump(events, router, sched, step_interval=2.0)
    ref_router = ref_stream.StreamRouter([0], capacity=32)
    ref_sched = _scheduler({0: ref_api.VedaliaClient(server=_ref_server())}, ref_router,
                           policy, cls=ref_stream.IncrementalScheduler, **kw)
    ref_stream.pump(ref_events, ref_router, ref_sched, step_interval=2.0)

    got = {f: getattr(sched.stats, f) for f in _COUNTS}
    assert got == {f: getattr(ref_sched.stats, f) for f in _COUNTS}
    assert list(sched.stats.staleness) == list(ref_sched.stats.staleness)
    if policy == "always":
        assert got["refits"] == got["updates"] > 0
    else:
        assert got["refits"] == 0 and got["updates"] > 0


def test_scheduler_publishes_the_reference_metrics_and_spans():
    events = synthetic_events(StreamSpec(**dict(QUICK, num_products=1, duration=12.0)))
    router = StreamRouter([0], capacity=32)
    sched = _scheduler({0: VedaliaClient(server=_server())}, router, "always",
                       microbatch=4, min_fit_reviews=5)
    with obs_config.scope(True):
        metrics.reset()
        trace.reset()
        pump(events, router, sched, step_interval=2.0)
        snap = metrics.snapshot()
        names = {s.name for s in trace.spans()}
    for name in ("vedalia_scheduler_stat", "vedalia_scheduler_staleness_seconds",
                 "vedalia_router_queue_depth"):
        assert name in snap, name
    assert {"scheduler.step", "scheduler.refit"} <= names
    assert metrics.REGISTRY.get("vedalia_scheduler_stat").value(stat="fits") == sched.stats.fits


def test_scheduler_knobs_are_checked():
    client = VedaliaClient(server=_server())
    with pytest.raises(ValueError, match="refit policy"):
        IncrementalScheduler({0: client}, StreamRouter([0]), refit_policy="sometimes")
    with pytest.raises(ValueError, match="no client"):
        IncrementalScheduler({}, StreamRouter([0]))
    with pytest.raises(ValueError, match="base_vocab"):
        IncrementalScheduler({0: client}, StreamRouter([0]), fit_kwargs=dict(num_topics=4))


# -- snapshot / restore --------------------------------------------------------


def _canonical(snap):
    """A snapshot with every backend name replaced by its canonical name."""
    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if key in ("backend", "default_backend") and isinstance(x, str):
            return backends.canonical(x)
        return x
    return walk(snap)


def test_snapshot_roundtrip_is_codec_exact(drift_run):
    _, _, servers, _, _ = drift_run
    for sid, server in servers.items():
        snap = snapshot_server(server)
        restored = restore_server(json.loads(json.dumps(snap)), device="cpu")
        assert snapshot_server(restored) == snap, f"shard {sid}"
        assert restored.ingest_acked == server.ingest_acked
        assert (restored._next_session, restored._next_cursor) == \
            (server._next_session, server._next_cursor)
        for hid, h in server.service.handles.items():
            r = restored.service.handles[hid]
            assert r.state.n_wt.device.type == "cpu"
            for f in ("z", "n_dt", "n_wt", "n_t"):
                assert torch.equal(getattr(r.state, f), getattr(h.state, f)), f
    with pytest.raises(ValueError, match="snapshot format"):
        restore_server({"format": 999}, device="cpu")


def test_snapshot_preserves_pending_ingest_and_clients_resync():
    server = _server()
    client = VedaliaClient(server=server)
    fit = client.fit(_reviews(n=15, seed=0), num_topics=4, base_vocab=120)
    assert not client.sync_view(fit.handle_id).resync
    assert not client.sync_view(fit.handle_id).resync  # warm deltas
    client.ingest(fit.handle_id, _reviews(n=3, seed=1))
    restored = restore_from_json(snapshot_to_json(server), device="cpu")
    client.rebind(server=restored)
    assert client.stats().ingest_queued[fit.handle_id] == 3
    recovered = client.sync_view(fit.handle_id)  # old session and cursor
    assert recovered.resync and len(recovered.topics) >= 1
    assert not client.sync_view(fit.handle_id).resync  # deltas resume
    upd = client.update(fit.handle_id, drain=True)
    assert upd.drained == 3 and upd.num_new_reviews == 3


def _ref_reviews(n, seed):
    return ref_reviews.generate(ref_reviews.SyntheticSpec(
        num_reviews=n, vocab_size=120, num_topics=4, mean_tokens=25, seed=seed)).reviews


def test_reference_snapshot_restores_into_a_port_server():
    ref_server = _ref_server(backend_opts={"alias": {"mh_steps": 2}})
    ref_client = ref_api.VedaliaClient(server=ref_server)
    fit = ref_client.fit(_ref_reviews(20, 0), num_topics=4, base_vocab=120)
    ref_client.fit(_ref_reviews(15, 2), num_topics=4, base_vocab=120, backend="pallas")
    ref_client.ingest(fit.handle_id, _ref_reviews(3, 1))
    snap = json.loads(json.dumps(ref_stream.snapshot_server(ref_server)))

    restored = restore_server(snap, device="cpu")
    assert _canonical(snapshot_server(restored)) == _canonical(snap)
    assert snapshot_server(restored) == snap  # names are carried as written
    client = VedaliaClient(server=restored)
    want = ref_client.perplexity(fit.handle_id)
    assert client.perplexity(fit.handle_id) == pytest.approx(want, rel=1e-4)
    assert client.stats().ingest_queued[fit.handle_id] == 3
    upd = client.update(fit.handle_id, drain=True)  # the restored model keeps serving
    assert upd.drained == 3 and client.sync_view(fit.handle_id).valid


def test_port_snapshot_restores_into_a_reference_server():
    server = _server(backend_opts={"alias": {"mh_steps": 2}})
    client = VedaliaClient(server=server)
    fit = client.fit(_reviews(n=20, seed=0), num_topics=4, base_vocab=120)
    client.fit(_reviews(n=15, seed=2), num_topics=4, base_vocab=120, backend="cuda")
    client.ingest(fit.handle_id, _reviews(n=3, seed=1))
    snap = json.loads(snapshot_to_json(server))

    restored = ref_stream.restore_server(snap)
    assert _canonical(ref_stream.snapshot_server(restored)) == _canonical(snap)
    ref_client = ref_api.VedaliaClient(server=restored)
    assert ref_client.perplexity(fit.handle_id) == \
        pytest.approx(client.perplexity(fit.handle_id), rel=1e-4)
    assert ref_client.stats().ingest_queued[fit.handle_id] == 3
    upd = ref_client.update(fit.handle_id, drain=True, backend="jnp")
    assert upd.drained == 3 and ref_client.sync_view(fit.handle_id).valid


@pytest.mark.parametrize("origin", ["port", "reference"])
def test_restored_packed_handle_refines_on_the_packed_path(origin, monkeypatch):
    """A snapshot's config carries its `quant` spec; a handle restored with
    `QuantSpec.int8(w_bits=8)` refines on `cuda` through the packed branch
    (on the CPU: `resample_quant`'s plain version, not `resample`'s)."""
    if origin == "port":
        server = _server()
        fit = VedaliaClient(server=server).fit(_reviews(n=20, seed=0), num_topics=4,
                                               base_vocab=120)
        snap = json.loads(snapshot_to_json(server))
    else:
        server = _ref_server()
        fit = ref_api.VedaliaClient(server=server).fit(_ref_reviews(20, 0), num_topics=4,
                                                       base_vocab=120)
        snap = json.loads(json.dumps(ref_stream.snapshot_server(server)))
    spec = QuantSpec.int8(w_bits=8)
    snap["handles"][0]["prep"]["cfg"]["quant"] = dataclasses.asdict(spec)
    restored = restore_server(snap, device="cpu")
    handle = restored.service.handles[fit.handle_id]
    assert handle.cfg.quant_spec == spec
    assert snapshot_server(restored) == snap  # the spec survives a re-snapshot

    calls = {"quant": 0, "exact": 0}
    quant_plain, exact_plain = lda_ops.resample_quant_plain, lda_ops.resample_plain

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(lda_ops, "resample_quant_plain", count("quant", quant_plain))
    monkeypatch.setattr(lda_ops, "resample_plain", count("exact", exact_plain))
    client = VedaliaClient(server=restored)
    before = handle.state.z.clone()
    res = client.refine(fit.handle_id, num_sweeps=3, backend="cuda", seed=1)
    assert res.backend == "cuda"
    assert calls == {"quant": 3, "exact": 0}
    assert not torch.equal(handle.state.z, before)
    assert np.isfinite(client.perplexity(fit.handle_id))


def test_package_exports_the_reference_names():
    import repro_torch.stream as stream

    assert sorted(stream.__all__) == sorted(ref_stream.__all__)
    for name in stream.__all__:
        assert getattr(stream, name) is not None
    assert ReviewEvent.__dataclass_fields__.keys() == \
        ref_stream.ReviewEvent.__dataclass_fields__.keys()
