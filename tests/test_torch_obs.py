"""The port's spans (`repro_torch.obs.trace`): free while obs is off, nested
under one trace id, on the profiler's clock, device-timed on request; and
the spans the service, the samplers, the codec and the alias tables open. The case marked `cuda` needs a card and skips here:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_obs.py
"""

import json
import os
import select
import signal
import time
import warnings

import pytest
import torch

from repro_torch import obs
from repro_torch.api import service
from repro_torch.api.service import VedaliaService
from repro_torch.data import reviews
from repro_torch.obs import metrics, trace

CUDA = torch.device("cuda")  # a device name: constructing it needs no card


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(1)
    trace.reset()
    yield
    trace.reset()


def _reviews(n=20, seed=3):
    return reviews.generate(reviews.SyntheticSpec(
        num_reviews=n, vocab_size=200, num_topics=4, mean_tokens=25, num_users=30,
        seed=seed)).reviews


@pytest.fixture
def fake_events(monkeypatch):
    """`torch.cuda.Event` replaced by a CPU stand-in whose records fall 2.5 ms
    apart and complete at once (a test sets `done` to hold one back);
    returns the events constructed and a log of the synchronizes."""
    made, log, clock = [], [], [0.0]

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t_ms, self.done = None, False
            made.append(self)

        def record(self, stream):
            assert stream == "stream:cuda"
            self.t_ms, self.done = clock[0], True
            clock[0] += 2.5

        def query(self):
            return self.done

        def elapsed_time(self, end):
            return end.t_ms - self.t_ms

        def synchronize(self):
            log.append("synchronize")
            self.done = True

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: f"stream:{device}")
    return made, log


def test_span_is_free_while_obs_is_off(monkeypatch, fake_events):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    made, _ = fake_events
    with obs.scope(False):
        with trace.span("sweep", on=CUDA, counter=metrics.counter("obs_test_off_s"),
                        route="cuda") as sp:
            sp.set(x=1)
        assert trace.resolve() == 0
    assert entered == [] and made == [] and trace.spans() == []
    assert sp is trace._NULL


def test_spans_nest_under_one_trace_id():
    with obs.scope(True):
        with trace.span("service.refine", sweeps=3) as outer:
            with trace.span("sweep", route="alias") as inner:
                with trace.span("codec.rebuild") as leaf:
                    pass
        with trace.span("service.view") as other:
            pass
    assert [s.name for s in trace.spans()] == ["codec.rebuild", "sweep", "service.refine",
                                               "service.view"]
    assert outer.trace_id == inner.trace_id == leaf.trace_id != other.trace_id
    assert inner.parent_id == outer.span_id and leaf.parent_id == inner.span_id
    assert outer.parent_id is None and outer.attrs == {"sweeps": 3}
    assert outer.duration_s >= inner.duration_s >= leaf.duration_s >= 0.0


def test_a_span_is_a_host_event_on_the_profilers_clock():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with obs.scope(True), torch.profiler.profile(activities=acts) as prof:
        with trace.span("obs.test_outer"):
            with trace.span("obs.test_inner"):
                torch.ones(8).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("obs.test_")}
    spans = {s.name: s for s in trace.spans()}
    assert set(events) == set(spans) == {"obs.test_outer", "obs.test_inner"}
    for name, sp in spans.items():
        assert str(events[name].device_type()).endswith("CPU")
        assert abs(sp.start_ns - events[name].start_ns()) < 1_000_000, name
    outer, inner = events["obs.test_outer"], events["obs.test_inner"]
    assert outer.start_ns() <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= outer.start_ns() + outer.duration_ns()


def test_export_chrome_writes_epoch_microseconds(tmp_path):
    with obs.scope(True):
        before_us = time.time_ns() * 1e-3
        with trace.span("obs.test", handle=3):
            pass
    path = tmp_path / "trace.json"
    assert trace.export_chrome(str(path)) == 1
    (ev,) = json.loads(path.read_text())["traceEvents"]
    (sp,) = trace.spans()
    assert ev["ts"] == pytest.approx(sp.start_ns * 1e-3)
    assert abs(ev["ts"] - before_us) < 1e6  # the epoch, not the monotonic clock
    assert ev["name"] == "obs.test" and ev["args"]["handle"] == 3
    assert not hasattr(trace, "export_jsonl")


def test_trace_ids_are_random_and_a_forked_child_draws_its_own():
    ids = [trace.new_trace_id() for _ in range(1000)]
    assert len(set(ids)) == 1000 and all(len(i) == 16 for i in ids)
    int(ids[0], 16)
    read, write = os.pipe()
    with warnings.catch_warnings():  # the child runs pure Python, then exits
        warnings.simplefilter("ignore")
        pid = os.fork()
    if pid == 0:  # the child: its next trace id and span id
        os.write(write, json.dumps([trace.new_trace_id(), trace._new_span_id()]).encode())
        os._exit(0)
    os.close(write)
    if not select.select([read], [], [], 30)[0]:  # never hang the run on a stuck child
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
        pytest.fail("the forked child did not answer")
    with os.fdopen(read) as f:
        child_trace, child_span = json.loads(f.read())
    os.waitpid(pid, 0)
    assert child_trace != trace.new_trace_id() and child_trace not in ids
    assert child_span[:8] != trace._new_span_id()[:8]  # the child's own nonce


def test_service_op_span_covers_its_synchronize_and_resolve(monkeypatch, fake_events):
    waited = []
    monkeypatch.setattr(service.timers, "_block", lambda value: (
        waited.append(value), time.sleep(0.02)))
    with obs.scope(True):
        with service._op("refine", "cuda", sweeps=1, tokens=8) as wait:
            with trace.span("codec.rebuild", on=CUDA) as rebuild:
                pass
            wait("n_wt")
        (req,) = [s for s in trace.spans() if s.name == "service.refine"]
        assert waited == ["n_wt"] and not trace._pending
        assert req.duration_s >= 0.02  # the synchronize is inside the span
        assert rebuild.attrs["device_s"] == pytest.approx(2.5e-3)


def test_device_timed_span_resolves_without_waiting(fake_events):
    made, log = fake_events
    counter = metrics.counter("obs_test_device_s")
    counter.reset()
    with obs.scope(True):
        with trace.span("codec.rebuild", on=CUDA, counter=counter) as sp:
            pass
        with trace.span("obs.host", on=torch.device("cpu")):  # no events off the card
            pass
        assert len(made) == 2 and "device_s" not in sp.attrs
        made[1].done = False  # the device has not reached the end event yet
        assert trace.resolve() == 1
        assert "device_s" not in sp.attrs and counter.value() == 0.0 and log == []
        made[1].done = True
        assert trace.resolve() == 0
        assert sp.attrs["device_s"] == pytest.approx(2.5e-3)
        assert counter.value() == pytest.approx(2.5e-3)
        with trace.span("alias.tables", on=CUDA) as sp2:
            pass
        assert len(made) == 2  # the resolved pair's events, recorded again
        end = trace._pending[-1][3]
        end.done = False
        trace.flush()  # waits, then resolves
    assert log == ["synchronize"] and sp2.attrs["device_s"] == pytest.approx(2.5e-3)
    assert trace.resolve() == 0


def test_pending_device_spans_stay_bounded(monkeypatch, fake_events):
    made, _ = fake_events
    monkeypatch.setattr(trace, "MAX_PENDING", 3)
    with obs.scope(True):
        for _ in range(4):
            with trace.span("sweep", on=CUDA):
                pass
        assert len(trace._pending) == 0  # the fourth resolved all: a query each
    assert all("device_s" in s.attrs for s in trace.spans())


@pytest.mark.parametrize("backend", ["alias", "cuda"])
def test_service_refine_opens_its_spans_and_counts_sweeps(backend):
    svc = VedaliaService(device="cpu", backend=backend, num_sweeps=2)
    handle = svc.fit(_reviews(), num_topics=6, base_vocab=200, seed=1)
    sweeps = metrics.REGISTRY.get("vedalia_sweeps_total")
    before = sweeps.value(route=backend)
    with obs.scope(True):
        svc.refine(handle, 3, seed=2)
        after = sweeps.value(route=backend)
    assert after - before == 3
    names = [s.name for s in trace.spans()]
    per_sweep = ["alias.tables", "codec.rebuild", "sweep"] if backend == "alias" else [
        "codec.rebuild", "sweep"]
    assert names == per_sweep * 3 + ["service.refine"]
    spans = trace.spans()
    (req,) = [s for s in spans if s.name == "service.refine"]
    assert req.attrs == {"backend": backend, "sweeps": 3,
                         "tokens": handle.model.corpus.num_tokens}
    for s in spans:
        if s.name == "sweep":
            assert s.attrs == {"route": backend, "tokens": handle.model.corpus.num_tokens}
        assert s.trace_id == req.trace_id and "device_s" not in s.attrs  # CPU: untimed


def _syncs(prof) -> int:
    return sum(e.name() in ("cudaDeviceSynchronize", "cudaStreamSynchronize")
               for e in prof.profiler.kineto_results.events())


@pytest.mark.cuda
def test_spans_time_the_device_without_a_synchronize():
    if not torch.cuda.is_available():
        pytest.skip("device-timed spans need a CUDA card")
    svc = VedaliaService(device="cuda", backend="cuda", num_sweeps=1)
    handle = svc.fit(_reviews(), num_topics=6, base_vocab=200, seed=1)
    svc.refine(handle, 1, seed=2)  # warm: the kernel's build and first launch
    rebuild_s = metrics.REGISTRY.get("vedalia_rebuild_device_seconds_total")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counts = {}
    for on in (False, True):
        torch.cuda.synchronize()
        with obs.scope(on), torch.profiler.profile(activities=acts) as prof:
            before = rebuild_s.value()
            svc.refine(handle, 3, seed=3)
            spans = trace.spans()  # read before any flush: resolved by the op itself
            added = rebuild_s.value() - before
        counts[on] = _syncs(prof)
    # obs on adds the op timer's one synchronize, and the spans add none
    assert counts[True] == counts[False] + 1
    assert [s.name for s in spans] == ["codec.rebuild", "sweep"] * 3 + ["service.refine"]
    assert not trace._pending
    rebuilds = [s.attrs["device_s"] for s in spans if s.name == "codec.rebuild"]
    assert len(rebuilds) == 3 and all(x > 0 for x in rebuilds)
    assert added == pytest.approx(sum(rebuilds))
    assert all("device_s" not in s.attrs for s in spans if s.name != "codec.rebuild")
