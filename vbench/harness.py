"""Find a cell's pieces by name and run it.

`BENCHMARK.json` at the root of the checkout names the cells. Everything
else is found by name under the benchmark's folder (the first of `paths`):

  configs      the `file` of each configuration entry; its `inputs` names
               the input generator, inputs/<generator>.py (`make`)
  traffic      traffic/<mix>.json          (read by `vbench.loop`)
  verbs        verbs/<verb>.py             (each step of a mix names one)
  cells        workloads/<cell>.json       (the check's `limits`, and its
                                            name, `check`: "sweeps" if absent)
  checks       checks/<check>.py           (its `Tap`, `check`, `verdict`,
                                            `unread`, `context` and
                                            `LIMITS`, the names a cell's
                                            `limits` has to give)
  metrics      metrics/<metric>.py         (a `read(ctx)` function each)

so a later change adds a configuration, a mix, a verb, a cell or a metric
by adding files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import random
import statistics
import time
from pathlib import Path
from typing import Callable, Optional

REPO = Path(__file__).resolve().parents[1]
#: Requests made in set-up, before the window: every shape the window uses.
WARMUP = 1
#: The check of a cell whose file names none.
DEFAULT_CHECK = "sweeps"


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    make_inputs: Callable  # (config, seed, device) -> the inputs
    mix: dict
    verbs: dict  # step of the mix ("serve", "request") -> its verb's module
    limits: dict  # the check's limits
    check: object  # the check's module, checks/<check>.py
    end_to_end: list  # metric entries (with "read": the reader)
    per_layer: list

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def load_benchmark(root: Path = REPO) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The module in the file `path`, loaded by its path."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    kind = path.parent.name
    spec = importlib.util.spec_from_file_location(f"vbench_{kind}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(path: Path) -> Callable:
    return load_module(path).read


def _check_limits(cell: str, check: str, module, limits: dict) -> dict:
    """`limits`, the cell file's, once they name exactly what its check
    declares in `LIMITS`; a `ValueError` that names the difference if not."""
    declared = getattr(module, "LIMITS", None)
    if declared is None:
        raise ValueError(f"cell {cell!r}: check {check!r} declares no LIMITS")
    missing, undeclared = set(declared) - set(limits), set(limits) - set(declared)
    if missing or undeclared:
        raise ValueError(f"cell {cell!r}: its limits differ from check {check!r}'s LIMITS: "
                         f"missing {sorted(missing)}, undeclared {sorted(undeclared)}")
    return limits


def load_cell(name: str, root: Path = REPO) -> Cell:
    """The cell `name` with its configuration and input generator, its mix
    and the mix's verbs, the check and its limits, and the readers of the
    metrics it reports. Limits other than the check's `LIMITS` are refused."""
    root = Path(root)
    bench = load_benchmark(root)
    home = root / bench["paths"][0]
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])

    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}

    def listed(m) -> bool:  # without a list: every cell that reports what it moves
        return name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names

    per_layer = [m for m in bench["per_layer"] if listed(m)]
    for m in e2e + per_layer:
        m["read"] = load_reader(home / "metrics" / f"{m['name']}.py")
    mix = _json(home / "traffic" / f"{w['traffic']}.json")
    verbs = {step: load_module(home / "verbs" / f"{mix[step]['verb']}.py")
             for step in ("serve", "request") if mix.get(step)}
    spec = _json(home / "workloads" / f"{name}.json")
    check_name = spec.get("check", DEFAULT_CHECK)
    check = load_module(home / "checks" / f"{check_name}.py")
    limits = _check_limits(name, check_name, check, spec["limits"])
    return Cell(name=name, chips=w["chips"], config=config,
                make_inputs=load_module(home / "inputs" / f"{config['inputs']}.py").make,
                mix=mix, verbs=verbs, limits=limits, check=check, end_to_end=e2e,
                per_layer=per_layer)


def _counters() -> dict:
    from repro_torch.obs import metrics

    return {name: sum(s.get("value", 0.0) for s in body["series"])
            for name, body in metrics.snapshot().items() if body["type"] == "counter"}


def _set_up(cell: Cell, seed: int, dev):
    """Inputs, the served models or system and the warm-up: the work
    `setup_s` counts. Corpora are served through a `VedaliaService`; other
    inputs by what the mix's serve verb builds."""
    from vbench import loop

    inputs = cell.make_inputs(cell.config, sub_seed(seed, "inputs"), dev)
    corpora = loop.are_corpora(inputs)
    service = None
    if corpora:
        from repro_torch.api.service import VedaliaService

        service = VedaliaService(device=dev, seed=sub_seed(seed, "service"))
    session = loop.Session(service, inputs, cell.mix, cell.verbs, device=dev)
    session.serve(sub_seed(seed, "serve"))
    if corpora:
        session.live_tokens  # noqa: B018 -- counted once, in set-up
    for w in range(WARMUP):
        req, _ = session.issue(-1 - w, sub_seed(seed, "warmup", w))
        if req.error:
            raise RuntimeError(f"warm-up request failed: {req.error}")
    return inputs, session


def _window(cell: Cell, session, seed: int, seconds: float, trace: bool, tap):
    """The measured window, traced with the port's counters on when
    `trace`: (requests, tapped products, window seconds, the profiler or
    None, the counters' increments)."""
    import torch
    from repro_torch import obs

    from vbench import loop, traceview

    tapped = tap.armed
    prof, before = None, {}
    if trace:
        obs.enable()
        before = _counters()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if session.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    tap.install()
    try:
        with torch.profiler.record_function(traceview.WINDOW):
            requests, products, window_s = loop.run(
                session, seconds, lambda i: sub_seed(seed, "request", i), tap, tapped)
    finally:
        tap.request = None
        tap.uninstall()
        if prof is not None:
            prof.stop()
            obs.disable()
    counters = {k: v - before.get(k, 0.0) for k, v in _counters().items()} if trace else {}
    return requests, products, window_s, prof, counters


def _log_latency(requests, window_s: float, log) -> None:
    lat = sorted((r.end - r.start) * 1e3 for r in requests if r.error is None)
    if len(lat) >= 4:
        q1, q2, q3 = statistics.quantiles(lat, n=4)
        log(f"window {window_s:.3f} s, {len(requests)} requests; latency ms: min {lat[0]:.3f} "
            f"q1 {q1:.3f} median {q2:.3f} q3 {q3:.3f} max {lat[-1]:.3f}; first "
            + " ".join(f"{(r.end - r.start) * 1e3:.1f}" for r in requests[:5]))
    elif lat:
        log(f"window {window_s:.3f} s, {len(requests)} requests; latency ms: "
            + " ".join(f"{(r.end - r.start) * 1e3:.1f}" for r in requests))
    for r in requests:
        if r.error:
            log(f"request {r.index} failed: {r.error}")


def _check(cell: Cell, inputs, tap, products, control: bool, log):
    """The check's numbers and whether they keep their limits, and with
    `control` each of the check's controls' numbers, by name."""
    chk = cell.check
    t_check = time.perf_counter()
    try:
        numbers = chk.check(cell, inputs, tap, products)
    except (RuntimeError, IndexError, ValueError) as exc:  # the output could not be read
        log(f"check failed: {type(exc).__name__}: {exc}")
        numbers = chk.unread(products)
    log(f"check: {time.perf_counter() - t_check:.1f} s, {len(tap.records)} tapped calls of "
        f"{len(products)} requests")
    ok, table = chk.verdict(numbers, cell.limits)
    control_numbers = ({name: chk.check(cell, inputs, tap, products, control=name)
                        for name in chk.CONTROLS} if control else None)
    return ok, table, control_numbers


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t0: Optional[float] = None, log=print, control: bool = False) -> dict:
    """One run of `cell`: set-up, the measured window, the check, the
    metrics; returns the result line's object. With `control`, the
    controls' numbers on the same output too, under "control", by name
    (`vbench.calibrate`)."""
    import torch

    from vbench import readers, traceview

    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    inputs, session = _set_up(cell, seed, dev)
    setup_s = time.perf_counter() - t0

    tap = cell.check.Tap(random.Random(sub_seed(seed, "check")))
    requests, products, window_s, prof, counters = _window(cell, session, seed, seconds, trace,
                                                           tap)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    _log_latency(requests, window_s, log)
    session.close()  # the program's state goes before the reference runs
    del session
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ok, table, control_numbers = _check(cell, inputs, tap, products, control, log)
    extra = cell.check.context(tap)
    del tap, products

    view = None
    if prof is not None:
        t_trace = time.perf_counter()
        view = traceview.read(prof)
        log(f"trace: {len(view.device_ops)} device and {len(view.host_ops)} host operations "
            f"read in {time.perf_counter() - t_trace:.1f} s")
    ctx = readers.Context(device=dev.type, setup_s=setup_s, window_s=window_s,
                          requests=requests, config=cell.config, inputs=inputs,
                          trace=view, counters=counters, **extra)
    metrics = {}
    for m in cell.metrics(trace):
        value = m["read"](ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(r.error is not None for r in requests)
    result = {"correct": bool(ok and failed == 0 and requests), "attempted": len(requests),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if view is not None:
        result["device"].update(busy_s=view.busy_s(), window_s=view.window_s)
        result["breakdown"] = {"device_ops": view.top_device_ops(),
                               "idle_gaps": view.idle_gaps()}
    if control_numbers is not None:
        result["control"] = control_numbers
    result["checks"] = table
    return result
