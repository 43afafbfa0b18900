"""The port's Chital offload tier (`repro_torch.offload`) vs the JAX package,
on port servers on the CPU at small sizes.

What is held, and how:
  * the cases of the reference's `tests/test_offload.py` on port servers
    (`device="cpu"`): the state-carrying wire verbs (`export_model`,
    `spot_check`, `adopt_state`), the simulated fleet (a real honest fit on
    both device samplers, `torch` and `sparse`; fabricated and corrupted
    uploads caught; churn and straggler deadlines), and the coordinator's
    lease → validate → verify → adopt loop on a short adversarial stream
    with each fleet sampler (every refit leased, no phony adoption, views
    serving, credit separated, a zero-sum ledger; an empty fleet falls
    back to server refits);
  * the fleet population equals the reference's for the same `FleetSpec`
    (the same numpy draws);
  * the coordinator's task list (shard, product, tokens, sweeps) equals the
    reference coordinator's on the same events (`refit_policy="always"`:
    the schedule depends on the event times alone);
  * state crosses the wire both ways: a reference `DeviceFleet` leases
    against a port server's transport, and a port fleet (both samplers)
    against a reference server's;
  * the reference bench's gates (`benchmarks/offload_bench.py`: >= 50% of
    refit sweep-work off the server, held-out perplexity within 2% of the
    server-only replay, no phony model adopted, honest credit above
    malicious) on port servers at the bench's config: the `torch` fleet
    at its full 80 s, the `sparse` fleet at its quick profile's 40 s.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
import repro.offload as ref_offload  # noqa: E402
import repro.stream as ref_stream  # noqa: E402
from repro_torch.api import VedaliaClient, VedaliaServer, protocol  # noqa: E402
from repro_torch.api.backends import get_backend  # noqa: E402
from repro_torch.core import codec  # noqa: E402
from repro_torch.core import perplexity as perplexity_lib  # noqa: E402
from repro_torch.data import reviews as reviews_data  # noqa: E402
from repro_torch.offload import (  # noqa: E402
    CORRUPT,
    FABRICATE,
    FABRICATE_CLAIM_RATIO,
    HONEST,
    DeviceFleet,
    FleetSpec,
    OffloadCoordinator,
    OffloadTask,
)
from repro_torch.stream import (  # noqa: E402
    IncrementalScheduler,
    StreamRouter,
    StreamSpec,
    pump,
    synthetic_events,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reviews(n=20, vocab=120, seed=0):
    return reviews_data.generate(reviews_data.SyntheticSpec(
        num_reviews=n, vocab_size=vocab, num_topics=4, mean_tokens=25, seed=seed)).reviews


def _client(**kw):
    return VedaliaClient(device="cpu", backend="jnp", num_sweeps=4, update_sweeps=1, **kw)


def _fit(client, n=20, seed=0):
    return client.fit(_reviews(n=n, seed=seed), num_topics=4, base_vocab=120)


def _ppx(exported, state):
    return float(perplexity_lib.perplexity(exported.cfg, state, exported.corpus))


def _tampered(state, seed=0):
    perm = np.random.default_rng(seed).permutation(int(state.n_wt.shape[0]))
    return dataclasses.replace(state, n_wt=state.n_wt[torch.as_tensor(perm)])


# -- state codec and the state-carrying verbs ----------------------------------


def test_state_arrays_roundtrip_and_missing_field():
    client = _client()
    exported = client.export_model(_fit(client).handle_id)
    enc = protocol.encode_state_arrays(exported.state)
    assert set(enc) == set(protocol.STATE_FIELDS)
    dec = protocol.decode_state_arrays(enc)
    for name in protocol.STATE_FIELDS:
        np.testing.assert_array_equal(dec[name], codec.as_numpy(getattr(exported.state, name)))
    enc.pop("n_wt")
    with pytest.raises(protocol.ProtocolError, match="missing field"):
        protocol.decode_state_arrays(enc)
    with pytest.raises(protocol.ProtocolError, match="JSON object"):
        protocol.decode_state_arrays([1, 2, 3])


def test_export_model_roundtrip():
    client = _client()
    fit = _fit(client)
    exported = client.export_model(fit.handle_id)
    assert exported.handle_id == fit.handle_id
    assert exported.cfg.num_topics == 4
    assert exported.num_tokens == exported.corpus.num_tokens
    assert tuple(exported.state.z.shape) == (exported.corpus.num_tokens,)
    assert exported.state.z.device.type == "cpu"
    # The exported state really is the served state: same perplexity.
    assert _ppx(exported, exported.state) == pytest.approx(
        client.perplexity(fit.handle_id), rel=1e-6)


def test_spot_check_accepts_honest_continuation():
    client = _client()
    fit = _fit(client)
    exported = client.export_model(fit.handle_id)
    state = get_backend("torch").run(exported.cfg, exported.corpus,
                                     torch.Generator().manual_seed(7), 3, state=exported.state)
    claimed = _ppx(exported, state)
    check = client.spot_check(fit.handle_id, state, claimed_perplexity=claimed)
    assert check.valid, check.reason
    assert check.state_perplexity == pytest.approx(claimed, rel=1e-6)
    assert check.post_perplexity is None  # no re-Gibbs requested


def test_spot_check_catches_fabricated_claim():
    client = _client()
    fit = _fit(client)
    exported = client.export_model(fit.handle_id)
    check = client.spot_check(fit.handle_id, exported.state,
                              claimed_perplexity=0.55 * _ppx(exported, exported.state))
    assert not check.valid
    assert "claim" in check.reason


def test_spot_check_catches_corrupted_state():
    client = _client()
    fit = _fit(client)
    exported = client.export_model(fit.handle_id)
    check = client.spot_check(fit.handle_id, _tampered(exported.state))
    assert not check.valid  # counts disagree with the assignments


def test_spot_check_regibbs_leaves_handle_untouched():
    client = _client()
    fit = _fit(client)
    exported = client.export_model(fit.handle_id)
    before = client.perplexity(fit.handle_id)
    check = client.spot_check(fit.handle_id, exported.state, num_sweeps=2, seed=3)
    assert check.valid
    assert check.post_perplexity is not None and np.isfinite(check.post_perplexity)
    # The re-Gibbs ran on a throwaway copy: the served model is unchanged.
    assert client.perplexity(fit.handle_id) == pytest.approx(before)


def test_adopt_state_swaps_serving_state_and_validates():
    client = _client()
    fit = _fit(client)
    exported = client.export_model(fit.handle_id)
    state = get_backend("torch").run(exported.cfg, exported.corpus,
                                     torch.Generator().manual_seed(11), 3, state=exported.state)
    device_ppx = _ppx(exported, state)
    res = client.adopt_state(fit.handle_id, state, sweeps_run=3)
    assert res.handle_id == fit.handle_id
    assert client.perplexity(fit.handle_id) == pytest.approx(device_ppx, rel=1e-6)
    assert client.sync_view(fit.handle_id).valid  # the handle keeps serving views
    # A tampered state is refused at the trust boundary.
    with pytest.raises(protocol.RemoteError, match="refusing to adopt"):
        client.adopt_state(fit.handle_id, _tampered(state))
    assert client.perplexity(fit.handle_id) == pytest.approx(device_ppx, rel=1e-6)


# -- fleet --------------------------------------------------------------------


FLEET_SPECS = [
    dict(num_devices=20, malicious_frac=0.2, fabricate_frac=0.5, straggler_frac=0.1, seed=3),
    dict(num_devices=1000, malicious_frac=0.2, fabricate_frac=0.5, churn_prob=0.05,
         straggler_frac=0.1, straggler_factor=8.0, seed=0),
    dict(num_devices=7, malicious_frac=0.5, fabricate_frac=0.3, straggler_frac=0.4,
         speed_range=(100.0, 900.0), seed=11),
]


@pytest.mark.parametrize("spec", FLEET_SPECS, ids=["20", "1000", "7"])
def test_fleet_population_equals_the_reference(spec):
    port = DeviceFleet(FleetSpec(**spec), device="cpu")
    ref = ref_offload.DeviceFleet(ref_offload.FleetSpec(**spec))
    assert [dataclasses.asdict(d) for d in port.devices.values()] \
        == [dataclasses.asdict(d) for d in ref.devices.values()]
    assert port.min_speed == ref.min_speed
    assert [dataclasses.asdict(s) for s in port.sellers()] \
        == [dataclasses.asdict(s) for s in ref.sellers()]
    assert FleetSpec().backend == ref_offload.FleetSpec().backend == "sparse"


def test_fleet_population_is_deterministic():
    spec = FleetSpec(**FLEET_SPECS[0])
    a, b = DeviceFleet(spec, device="cpu"), DeviceFleet(spec, device="cpu")
    assert {i: d.behavior for i, d in a.devices.items()} \
        == {i: d.behavior for i, d in b.devices.items()}
    assert [d.speed for d in a.devices.values()] == [d.speed for d in b.devices.values()]
    behaviors = [d.behavior for d in a.devices.values()]
    assert behaviors.count(FABRICATE) == 2
    assert behaviors.count(CORRUPT) == 2
    assert behaviors.count(HONEST) == 16
    assert sum(d.straggler_factor > 1.0 for d in a.devices.values()) == 2
    sellers = a.sellers()
    assert len(sellers) == 20
    assert all(s.honest == a.devices[s.seller_id].honest for s in sellers)


def test_fleet_resolves_its_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device resolves, nothing to raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceFleet(FleetSpec(num_devices=1))
    assert DeviceFleet(FleetSpec(num_devices=1), device="cpu").device == torch.device("cpu")


def _task(fit, tokens, num_sweeps=2, task_id=0, cls=OffloadTask):
    return cls(task_id=task_id, shard_id=0, handle_id=fit.handle_id, product_id=0,
               tokens=tokens, num_sweeps=num_sweeps)


@pytest.mark.parametrize("backend", ["torch", "jnp", "sparse"])
def test_honest_device_runs_a_real_fit(backend):
    client = _client()
    fit = _fit(client)
    fleet = DeviceFleet(FleetSpec(num_devices=4, malicious_frac=0.0, churn_prob=0.0,
                                  straggler_frac=0.0, backend=backend, seed=0), device="cpu")
    exported = client.export_model(fit.handle_id)
    task = _task(fit, tokens=exported.num_tokens)
    run = fleet.execute(0, task, client.transport)
    assert run.completed and not run.churned and not run.timed_out
    sub = run.submission
    assert sub.valid and sub.payload is not None
    assert sub.iterations == task.num_sweeps
    # The claimed perplexity is the *real* perplexity of the uploaded
    # state: the server's recompute agrees.
    check = client.spot_check(fit.handle_id, sub.payload, claimed_perplexity=sub.perplexity)
    assert check.valid, check.reason
    # The chain actually moved: the assignments changed.
    assert not torch.equal(sub.payload.z, exported.state.z)
    # Replayable: same (seed, device, task) -> identical submission.
    rerun = fleet.execute(0, task, client.transport)
    assert rerun.submission.perplexity == sub.perplexity
    assert torch.equal(rerun.submission.payload.z, sub.payload.z)


def test_sparse_device_is_the_sparse_backend_from_the_lease_seed():
    """A `sparse` device's fit is the `sparse` backend on the exported model
    with a generator seeded from the reference's per-lease hash."""
    client = _client()
    fit = _fit(client)
    fleet = DeviceFleet(FleetSpec(num_devices=3, malicious_frac=0.0, churn_prob=0.0,
                                  straggler_frac=0.0, seed=5), device="cpu")
    exported = client.export_model(fit.handle_id)
    task = _task(fit, tokens=exported.num_tokens, num_sweeps=3, task_id=4)
    run = fleet.execute(2, task, client.transport)
    gen = torch.Generator().manual_seed(hash((5, 2, 4)) & 0x7FFFFFFF)
    want = get_backend("sparse").run(exported.cfg, exported.corpus, gen, 3,
                                     state=exported.state)
    for field in ("z", "n_dt", "n_wt", "n_t"):
        assert torch.equal(getattr(run.submission.payload, field), getattr(want, field))


def test_malicious_devices_are_caught_by_spot_check():
    client = _client()
    fit = _fit(client)
    fleet = DeviceFleet(FleetSpec(num_devices=2, malicious_frac=1.0, fabricate_frac=0.5,
                                  churn_prob=0.0, straggler_frac=0.0, backend="torch", seed=0),
                        device="cpu")
    by_behavior = {d.behavior: d.device_id for d in fleet.devices.values()}
    assert set(by_behavior) == {FABRICATE, CORRUPT}
    exported = client.export_model(fit.handle_id)

    fab = fleet.execute(by_behavior[FABRICATE], _task(fit, exported.num_tokens),
                        client.transport)
    assert fab.submission.perplexity == pytest.approx(
        FABRICATE_CLAIM_RATIO * _ppx(exported, exported.state))
    check = client.spot_check(fit.handle_id, fab.submission.payload,
                              claimed_perplexity=fab.submission.perplexity)
    assert not check.valid  # implausibly good claim vs the recompute

    cor = fleet.execute(by_behavior[CORRUPT], _task(fit, exported.num_tokens),
                        client.transport)
    check = client.spot_check(fit.handle_id, cor.submission.payload,
                              claimed_perplexity=cor.submission.perplexity)
    assert not check.valid  # tampered counts fail the rebuild check


def test_churn_and_straggler_deadline():
    client = _client()
    fit = _fit(client)
    fleet = DeviceFleet(FleetSpec(num_devices=1, malicious_frac=0.0, churn_prob=1.0,
                                  backend="torch", seed=0), device="cpu")
    run = fleet.execute(0, _task(fit, 100), client.transport)
    assert run.churned and not run.completed
    assert not run.submission.valid and run.submission.payload is None

    slow = DeviceFleet(FleetSpec(num_devices=1, malicious_frac=0.0, churn_prob=0.0,
                                 straggler_frac=1.0, straggler_factor=8.0, backend="torch",
                                 seed=0), device="cpu")
    # Deadline sized for the advertised speed: the straggler (8x slower
    # than advertised) misses it and the lease expires without an upload.
    task = _task(fit, 100)
    deadline = 2.0 * (task.tokens * task.num_sweeps) / slow.min_speed
    run = slow.execute(0, task, client.transport, deadline=deadline)
    assert run.timed_out and not run.completed
    # No deadline -> the slow device eventually finishes a real fit.
    run = slow.execute(0, task, client.transport)
    assert run.completed and run.submission.valid


# -- state across the wire, both ways ------------------------------------------


def test_reference_fleet_leases_against_a_port_server():
    """A reference `DeviceFleet` exports from a port server, fits with JAX
    and uploads: the port server validates and adopts the honest state and
    refuses the malicious ones."""
    server = VedaliaServer(device="cpu", backend="torch", num_sweeps=4, update_sweeps=1)
    client = VedaliaClient(server=server)
    fit = _fit(client)
    ref_client = ref_api.VedaliaClient(transport=server.handle_raw)
    n = ref_client.export_model(fit.handle_id).num_tokens
    fleet = ref_offload.DeviceFleet(ref_offload.FleetSpec(
        num_devices=3, malicious_frac=2 / 3, fabricate_frac=0.5, churn_prob=0.0,
        straggler_frac=0.0, backend="jnp", seed=0))
    by_behavior = {d.behavior: d.device_id for d in fleet.devices.values()}
    task = _task(fit, n, cls=ref_offload.OffloadTask)
    honest = fleet.execute(by_behavior[HONEST], task, server.handle_raw).submission
    check = ref_client.spot_check(fit.handle_id, honest.payload,
                                  claimed_perplexity=honest.perplexity)
    assert check.valid, check.reason
    for behavior in (FABRICATE, CORRUPT):
        sub = fleet.execute(by_behavior[behavior], task, server.handle_raw).submission
        assert not client.spot_check(fit.handle_id, sub.payload,
                                     claimed_perplexity=sub.perplexity).valid
    ref_client.adopt_state(fit.handle_id, honest.payload, sweeps_run=2)
    assert client.perplexity(fit.handle_id) == pytest.approx(honest.perplexity, rel=1e-5)
    assert np.array_equal(codec.as_numpy(server.service.handles[fit.handle_id].model.state.z),
                          np.asarray(honest.payload.z))
    assert client.sync_view(fit.handle_id).valid


@pytest.mark.parametrize("backend", ["torch", "sparse"])
def test_port_fleet_leases_against_a_reference_server(backend):
    """A port `DeviceFleet` exports from a reference server, fits on the
    port and uploads: the reference server validates and adopts it."""
    ref_server = ref_api.VedaliaServer(backend="jnp", num_sweeps=4, update_sweeps=1)
    ref_client = ref_api.VedaliaClient(server=ref_server)
    fit = ref_client.fit(_reviews(), num_topics=4, base_vocab=120)
    n = ref_client.export_model(fit.handle_id).num_tokens
    fleet = DeviceFleet(FleetSpec(num_devices=3, malicious_frac=2 / 3, fabricate_frac=0.5,
                                  churn_prob=0.0, straggler_frac=0.0, backend=backend, seed=0),
                        device="cpu")
    by_behavior = {d.behavior: d.device_id for d in fleet.devices.values()}
    task = _task(fit, n)
    honest = fleet.execute(by_behavior[HONEST], task, ref_server.handle_raw).submission
    check = ref_client.spot_check(fit.handle_id, honest.payload,
                                  claimed_perplexity=honest.perplexity)
    assert check.valid, check.reason
    for behavior in (FABRICATE, CORRUPT):
        sub = fleet.execute(by_behavior[behavior], task, ref_server.handle_raw).submission
        assert not ref_client.spot_check(fit.handle_id, sub.payload,
                                         claimed_perplexity=sub.perplexity).valid
    ref_client.adopt_state(fit.handle_id, honest.payload, sweeps_run=2)
    assert ref_client.perplexity(fit.handle_id) == pytest.approx(honest.perplexity, rel=1e-5)
    assert ref_client.sync_view(fit.handle_id).valid


# -- coordinator --------------------------------------------------------------

QUICK = dict(num_products=3, duration=30.0, rate=2.0, shape="burst", shift_at=15.0, seed=0)
SCHED = dict(microbatch=6, min_fit_reviews=8, staleness_budget=8.0, refit_policy="always")
FIT_KW = dict(num_topics=4, base_vocab=120, num_sweeps=4)


def _stream(spec, refit_sweeps, executor=None, scheduler=IncrementalScheduler):
    """Replay a stream onto 2 port servers on the CPU; returns the clients,
    the scheduler and the held-out perplexity of every product that has a
    reservoir."""
    events = synthetic_events(StreamSpec(**spec))
    router = StreamRouter([0, 1], capacity=64)
    clients = {s: _client() for s in (0, 1)}
    sched = scheduler(clients, router, refit_sweeps=refit_sweeps, refit_executor=executor,
                      fit_kwargs=FIT_KW, **SCHED)
    pump(events, router, sched, step_interval=2.0)
    heldout = {pid: float(clients[st.shard_id].perplexity(st.handle_id, reviews=st.heldout))
               for pid, st in sched.products.items() if st.heldout}
    return clients, sched, heldout


@pytest.fixture(scope="module", params=["torch", "sparse"])
def offload_run(request):
    """One short adversarial stream driven through the offload tier, with
    the fleet on each device sampler."""
    fleet = DeviceFleet(FleetSpec(num_devices=12, malicious_frac=0.25, churn_prob=0.1,
                                  straggler_frac=0.15, backend=request.param, seed=0),
                        device="cpu")
    coord = OffloadCoordinator(fleet, seed=0)
    clients, sched, _ = _stream(QUICK, 3, executor=coord)
    return clients, fleet, coord, sched


def test_coordinator_leases_every_refit(offload_run):
    _, _, coord, sched = offload_run
    st = coord.stats
    assert sched.stats.refits > 0
    assert st.tasks == sched.stats.refits
    # The executor owns the launches 1:1 and the built-in server refit path
    # never ran.
    assert sched.stats.refit_launches == st.tasks
    assert sched.stats.refit_sweep_work == 0.0
    # Every task resolved: adopted from a device or explicitly fell back.
    assert st.adopted + st.fallbacks == st.tasks
    assert st.adopted > 0  # the fleet actually took work
    assert st.device_sweep_work > 0


def test_coordinator_never_adopts_phony(offload_run):
    _, _, coord, _ = offload_run
    assert coord.stats.adopted_phony == 0
    # Validation did real work: the adversarial fleet produced invalid
    # submissions and they were all caught before selection.
    assert coord.stats.invalid_submissions > 0


def test_coordinator_keeps_views_serving(offload_run):
    clients, _, _, sched = offload_run
    for status in sched.products.values():
        client = clients[status.shard_id]
        assert client.sync_view(status.handle_id).valid
        ppx = client.perplexity(status.handle_id)
        assert np.isfinite(ppx) and ppx > 0


def test_coordinator_credit_separates_honest_from_malicious(offload_run):
    _, fleet, coord, _ = offload_run
    ledger = coord.marketplace.ledger
    honest = [ledger.get(d.device_id) for d in fleet.devices.values() if d.honest]
    malicious = [ledger.get(d.device_id) for d in fleet.devices.values() if not d.honest]
    assert np.mean(honest) > np.mean(malicious)
    assert abs(ledger.total()) < 1e-9  # zero-sum survived the whole run


def test_coordinator_falls_back_when_fleet_is_empty():
    """Zero devices: every lease is an unmatched fallback — the server
    refits itself and serving never stalls."""
    spec = StreamSpec(num_products=1, duration=15.0, rate=2.0, shape="burst",
                      shift_at=None, seed=0)
    router = StreamRouter([0], capacity=64)
    client = _client()
    coord = OffloadCoordinator(DeviceFleet(FleetSpec(num_devices=0), device="cpu"), seed=0)
    sched = IncrementalScheduler(
        {0: client}, router, microbatch=5, min_fit_reviews=6, staleness_budget=6.0,
        refit_sweeps=2, refit_policy="always", refit_executor=coord,
        fit_kwargs=dict(num_topics=4, base_vocab=spec.vocab_size, num_sweeps=3))
    pump(synthetic_events(spec), router, sched, step_interval=2.0)
    st = coord.stats
    assert st.tasks > 0
    assert st.fallback_unmatched == st.tasks and st.adopted == 0
    # The fallback really refined: full server sweep-work was charged.
    assert st.server_sweep_work > 0
    assert coord.marketplace.matched_rate() == 0.0
    for status in sched.products.values():
        assert client.sync_view(status.handle_id).valid


def _recording(coord, tasks):
    """Wrap a coordinator as a `RefitExecutor` that records each task."""

    def executor(shard_id, client, statuses, num_sweeps, now):
        tasks.extend((shard_id, s.product_id, max(int(s.tokens_ingested), 1), num_sweeps)
                     for s in statuses)
        return coord(shard_id, client, statuses, num_sweeps, now)

    return executor


def test_coordinator_task_list_equals_the_reference():
    """Port servers + port coordinator against reference servers + the
    reference coordinator, on the same events and fleet spec."""
    spec = dict(num_products=2, duration=20.0, rate=2.0, shape="burst", shift_at=10.0, seed=0)
    fleet_spec = dict(num_devices=8, malicious_frac=0.25, churn_prob=0.1,
                      straggler_frac=0.15, seed=0)
    port_tasks, ref_tasks = [], []
    coord = OffloadCoordinator(DeviceFleet(FleetSpec(backend="torch", **fleet_spec),
                                           device="cpu"), seed=0)
    _, sched, _ = _stream(spec, 3, executor=_recording(coord, port_tasks))

    ref_coord = ref_offload.OffloadCoordinator(ref_offload.DeviceFleet(
        ref_offload.FleetSpec(backend="jnp", **fleet_spec)), seed=0)
    ref_router = ref_stream.StreamRouter([0, 1], capacity=64)
    ref_clients = {s: ref_api.VedaliaClient(server=ref_api.VedaliaServer(
        backend="jnp", num_sweeps=4, update_sweeps=1)) for s in (0, 1)}
    ref_sched = ref_stream.IncrementalScheduler(
        ref_clients, ref_router, refit_sweeps=3, fit_kwargs=FIT_KW,
        refit_executor=_recording(ref_coord, ref_tasks), **SCHED)
    ref_stream.pump(ref_stream.synthetic_events(ref_stream.StreamSpec(**spec)), ref_router,
                    ref_sched, step_interval=2.0)

    assert port_tasks and port_tasks == ref_tasks
    assert coord.stats.tasks == ref_coord.stats.tasks == sched.stats.refits == len(port_tasks)
    for st in (coord.stats, ref_coord.stats):
        assert st.adopted + st.fallbacks == st.tasks and st.adopted_phony == 0


@pytest.mark.parametrize("backend,duration", [("torch", 80.0), ("sparse", 40.0)],
                         ids=["torch-80s", "sparse-40s"])
def test_bench_gates_on_port_servers(backend, duration):
    """The reference bench's config and gates (`benchmarks/offload_bench.py`)
    on port servers: the same stream replayed server-only and leased to a
    1,000-device fleet (20% malicious, churn, stragglers) must give the
    same refit task list, move >= 50% of refit sweep-work off the server,
    keep held-out perplexity within 2%, adopt no phony model and separate
    honest from malicious credit on a zero-sum ledger."""
    spec = dict(num_products=4, duration=duration, rate=2.5, shape="burst", shift_at=20.0,
                seed=0)
    base_tasks, off_tasks = [], []

    class Scheduler(IncrementalScheduler):
        """The built-in refit path (coalesced `refine_batch`), with each
        task recorded as it is handed over."""

        def _execute_refits(self, sid, statuses, now):
            base_tasks.extend((sid, s.product_id, max(int(s.tokens_ingested), 1),
                               self.refit_sweeps) for s in statuses)
            return super()._execute_refits(sid, statuses, now)

    _, base, base_heldout = _stream(spec, 6, scheduler=Scheduler)
    base_work = base.stats.refit_sweep_work
    fleet = DeviceFleet(FleetSpec(num_devices=1000, malicious_frac=0.2, fabricate_frac=0.5,
                                  churn_prob=0.05, straggler_frac=0.1, straggler_factor=8.0,
                                  backend=backend, seed=0), device="cpu")
    coord = OffloadCoordinator(fleet, spot_check_sweeps=2, seed=0)
    _, _, off_heldout = _stream(spec, 6, executor=_recording(coord, off_tasks))
    st = coord.stats
    assert off_tasks == base_tasks and st.tasks == base.stats.refits > 0
    offloaded = 1.0 - st.server_sweep_work / base_work
    shared = sorted(set(base_heldout) & set(off_heldout))
    base_mean = float(np.mean([base_heldout[p] for p in shared]))
    off_mean = float(np.mean([off_heldout[p] for p in shared]))
    ledger = coord.marketplace.ledger
    honest = np.mean([ledger.get(d.device_id) for d in fleet.devices.values() if d.honest])
    malicious = np.mean([ledger.get(d.device_id) for d in fleet.devices.values()
                         if not d.honest])
    assert offloaded >= 0.5, offloaded
    assert abs(off_mean - base_mean) / base_mean <= 0.02, (off_mean, base_mean)
    assert st.adopted_phony == 0
    assert honest > malicious
    assert abs(ledger.total()) < 1e-9
    assert st.adopted > 0 and st.device_sweep_work > 0
