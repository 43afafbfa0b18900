"""Dry run: what each (arch x shape x mesh) step needs of a device.

The reference's `repro.launch.dryrun` lowers and compiles every step onto
512 placeholder TPU devices and reads XLA's memory and cost analyses. The
port has no compiler to ask, so it runs the step itself on abstract inputs:

  static bytes      exact from the specs on every mesh (`pod16x16`,
                    `pod2x16x16`, and `h100x1`, the card): per device, the
                    parameters, gradients and optimizer state (train), the
                    batch, and the cache (prefill's output, decode's state)
  flops, peak       on the card mesh only: the step (`train.step.
                    make_train_step`, `models.model.prefill` or `decode_step`)
                    run on `meta` tensors (`abstract_model`, `abstract_batch`,
                    `abstract_cache`, `Optimizer.abstract_state`), which
                    allocates nothing, under `torch.utils.flop_counter.
                    FlopCounterMode` and `LiveBytes`, a dispatch mode that
                    tracks every live storage's bytes, the inputs' included
  roofline          compute (the FLOPs over the H100's bf16 peak), memory
                    (the static bytes a device read once: a lower bound),
                    the bottleneck, and `fits_card`: the step's peak (static
                    bytes alone on a pod mesh) within the card's memory

The step runs at two and at three layer groups, and the FLOPs and the peak
are extrapolated linearly to the config's depth: the layers of a group are
identical stacks, and the embedding and loss head are the same at every
depth (the train step's update, whose peak is its largest leaf's, is
measured at full depth apart: it runs no model). A group is a layer, a
dense local/global pair, a MoE dense/MoE pair, a hybrid group of Mamba2
layers (zamba2: 6), a VLM group of self layers and a cross layer (5), or
an encoder and a decoder layer (audio).

FLOPs are what `FlopCounterMode` counts: matrix products (mm, bmm, addmm,
baddbmm), convolutions and fused attention; elementwise work is not
counted. On `meta` the served kernels take their plain versions, so a
decode record counts the plain decode attention's products over the whole
cache, and an ssm or hybrid record the plain scan's. `meta` takes the
card's branches elsewhere (`layers.OUT_DTYPE_GEMM_DEVICES`).

What a record cannot say: a pod's collectives (`collectives` is null on
every mesh) and a pod device's activations under tensor parallelism
(`activations` null on the pod meshes); one card can neither measure nor
trace them. The reference's `--impl` and `--embed` select XLA variants
(tile strategies, a one-hot embedding) that the port does not have: its
attention has one tile enumeration and its embedding is a gather.

The card mesh is always recorded, beside the (16, 16) pod (`--multi-pod`:
the (2, 16, 16) one instead; `--both-meshes`: both). Records go to
experiments/dryrun_torch/<arch>__<shape>__<mesh>.json:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import configs
from repro_torch.configs import shapes as shapes_lib
from repro_torch.configs.base import REFERENCE_ARCHS
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models.params import leaves, map_tree
from repro_torch.sharding.specs import shard_shape
from repro_torch.train.optim import OptConfig, make_optimizer
from repro_torch.train.step import ACCUM_DTYPES, make_train_step

# long_500k needs sub-quadratic attention: run for the SSM and hybrid archs
# and the sliding-window dense variant only.
LONG_OK = {"rwkv6-1.6b", "zamba2-2.7b", "gemma2-9b-sw"}
LONG_SKIP = "full-attention arch at 524k decode (the long_500k policy)"
FLOPS_COUNTED = ("matrix products (mm, bmm, addmm, baddbmm), convolutions and fused "
                 "attention, as torch.utils.flop_counter counts them; elementwise "
                 "work is not counted")
PLAIN_KERNELS = ("on meta the served kernels take their plain versions: a decode step "
                 "counts the plain decode attention over the whole cache, a prefill "
                 "the plain chunked scan")
NO_COLLECTIVES = "a pod's collectives cannot be measured or traced on one card"
NO_POD_ACTIVATIONS = ("a pod device's activations under tensor parallelism cannot be "
                      "measured or traced on one card")
OUTDIR = "experiments/dryrun_torch"
SMALL_STORAGE = 8  # bytes; `LiveBytes` counts only larger storages


# ---------------------------------------------------------------------------
# Live storage bytes
# ---------------------------------------------------------------------------


class LiveBytes(TorchDispatchMode):
    """Tracks the bytes of every live storage on one device type: the held
    trees' storages from the start, then each storage an op returns, until
    it is freed (a weakref finalizer on the storage). `peak` is the most
    live at once. Storages of `SMALL_STORAGE` bytes or fewer are not
    counted: 0-d scalars, the optimizer's host scalars (which lie on the
    CPU) among them."""

    def __init__(self, device_type: str, *held):
        super().__init__()
        self.device_type = device_type
        self.live = 0
        self.peak = 0
        self._cells = WeakIdKeyDictionary()
        for tree in held:
            for _, t in leaves(tree):
                self._track(t)

    def _release(self, cell):
        self.live -= cell[0]

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        n = st.nbytes()
        if n <= SMALL_STORAGE:
            return
        cell = self._cells.get(st)
        if cell is None:
            cell = self._cells[st] = [0]
            weakref.finalize(st, self._release, cell)
        if n > cell[0]:  # a new storage, or one an op resized
            self.live += n - cell[0]
            cell[0] = n
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, _types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


# ---------------------------------------------------------------------------
# Depth groups
# ---------------------------------------------------------------------------


def group_layers(cfg) -> int:
    """Layers (of `num_layers`) in one repeated group of the config."""
    if cfg.arch_type == "hybrid":
        return cfg.hybrid_attn_every
    if cfg.arch_type == "vlm":
        return cfg.cross_attn_every
    if cfg.attn_pattern == "local_global" or (cfg.num_experts and cfg.moe_every == 2):
        return 2
    return 1


def num_groups(cfg) -> int:
    per = group_layers(cfg)
    if cfg.num_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole groups of {per}")
    if cfg.arch_type == "audio" and cfg.encoder_layers != cfg.num_layers:
        raise ValueError(f"{cfg.name}: the encoder's {cfg.encoder_layers} layers and the "
                         f"decoder's {cfg.num_layers} do not pair into groups")
    return cfg.num_layers // per


def at_groups(cfg, g: int):
    """The config cut to `g` groups (the encoder too, for audio)."""
    enc = {"encoder_layers": g} if cfg.arch_type == "audio" else {}
    return dataclasses.replace(cfg, num_layers=g * group_layers(cfg), **enc)


# ---------------------------------------------------------------------------
# Static bytes from the specs
# ---------------------------------------------------------------------------


def sharded_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of a tree of (meta) tensors laid out by `specs`."""
    spec_of = dict(leaves(specs))
    return sum(math.prod(shard_shape(t.shape, spec_of[path], mesh)) * t.element_size()
               for path, t in leaves(tree))


def static_bytes(cfg, shape, mesh) -> dict:
    """Per-device bytes of what the step holds whatever its activations:
    parameters, gradients and optimizer state (train; the gradients in the
    accumulation type when `cfg.microbatch` > 1), the batch, and the cache
    (prefill's output, decode's state)."""
    kind, b, s = shape.kind, shape.global_batch, shape.seq_len
    pspecs = M.model_pspecs(cfg, mesh)
    params = M.abstract_model(cfg)
    out = {"params": sharded_bytes(params, pspecs, mesh), "grads": 0, "opt_state": 0,
           "batch": sharded_bytes(M.abstract_batch(cfg, kind, b, s),
                                  M.batch_pspecs(cfg, mesh, kind, b), mesh),
           "cache": 0}
    if kind == "train":
        opt = make_optimizer(OptConfig(name=cfg.optimizer))
        out["opt_state"] = sharded_bytes(opt.abstract_state(params),
                                         opt.state_pspecs(pspecs), mesh)
        grads = params
        if cfg.microbatch > 1:
            dt = ACCUM_DTYPES[cfg.grad_accum_dtype]
            grads = {"/".join(p): torch.empty(t.shape, dtype=dt, device="meta")
                     for p, t in leaves(params)}
            pspecs = {"/".join(p): spec for p, spec in leaves(pspecs)}
        out["grads"] = sharded_bytes(grads, pspecs, mesh)
    else:
        out["cache"] = sharded_bytes(M.abstract_cache(cfg, b, s),
                                     M.cache_pspecs(cfg, mesh, b, s, kind=kind), mesh)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# The step on abstract (or real) inputs
# ---------------------------------------------------------------------------


def _inputs(cfg, kind: str, b: int, s: int, device) -> dict:
    """The step's inputs: on `meta` the abstract builds; on another device
    real ones (seeded weights and batch, a zero cache), for a test to hold
    the `meta` run to."""
    dev = torch.device(device)
    meta = dev.type == "meta"
    out = {"params": M.abstract_model(cfg) if meta else M.init_model(cfg, seed=0, device=dev),
           "batch": (M.abstract_batch(cfg, kind, b, s) if meta else M.real_batch(
               cfg, kind, b, s, generator=torch.Generator(device=dev).manual_seed(0)))}
    if kind == "train":
        opt = make_optimizer(OptConfig(name=cfg.optimizer))
        out["state"] = opt.abstract_state(out["params"]) if meta else opt.init(out["params"])
        out["step"] = make_train_step(cfg, opt)
    elif kind == "decode":
        out["cache"] = (M.abstract_cache(cfg, b, s) if meta
                        else M.init_cache(cfg, b, s, device=dev))
    elif kind != "prefill":
        raise ValueError(f"unknown step kind {kind!r}")
    return out


def _measured(run, device, *held) -> dict:
    """`run()` under `FlopCounterMode` and `LiveBytes` (holding `held`): its
    counted FLOPs and the peak of live bytes, the held bytes included."""
    live = LiveBytes(torch.device(device).type, *held)
    counter = FlopCounterMode(display=False)
    with counter, live:
        out = run()
    del out
    return {"flops": int(counter.get_total_flops()), "peak_bytes": live.peak}


def measure_step(cfg, kind: str, b: int, s: int, device="meta") -> dict:
    """The whole step (train, prefill or decode) measured at `cfg`'s depth."""
    x = _inputs(cfg, kind, b, s, device)
    params, batch = x["params"], x["batch"]
    if kind == "train":
        return _measured(lambda: x["step"](params, x["state"], batch, 0), device,
                         params, x["state"], batch)
    if kind == "prefill":
        with torch.no_grad():
            return _measured(lambda: M.prefill(params, cfg, batch, s), device, params, batch)
    with torch.no_grad():
        return _measured(lambda: M.decode_step(params, cfg, x["cache"], batch["tokens"], s - 1),
                         device, params, x["cache"], batch)


def _measure_grads(cfg, b: int, s: int, device) -> dict:
    """The train step's first half (`train_step.grads`), the parameters,
    optimizer state and batch held."""
    x = _inputs(cfg, "train", b, s, device)
    return _measured(lambda: x["step"].grads(x["params"], x["batch"]), device,
                     x["params"], x["state"], x["batch"])


def _measure_apply(cfg, b: int, s: int, device) -> dict:
    """The train step's second half (`train_step.apply`: the global norm and
    the update) on gradients as the first half leaves them (the parameters'
    type, or the accumulation type with microbatches)."""
    x = _inputs(cfg, "train", b, s, device)
    dt = ACCUM_DTYPES[cfg.grad_accum_dtype] if cfg.microbatch > 1 else None
    grads = map_tree(lambda p: torch.zeros(p.shape, dtype=dt or p.dtype, device=p.device),
                     x["params"])
    return _measured(lambda: x["step"].apply(x["params"], x["state"], grads, 0), device,
                     x["params"], x["state"], x["batch"], grads)


def estimate(cfg, kind: str, b: int, s: int, device="meta") -> dict:
    """The step's counted FLOPs and peak bytes at the config's depth, from
    runs at two and three groups extrapolated linearly (run whole when the
    config has at most three). From the second group on each group adds
    the same; the first may not (a weight-shared block's gradient starts
    accumulating at its second use). The train step's update is measured
    at full depth apart: its peak is the largest leaf's temporaries, which
    is not linear in depth (the embedding's at one group, a stacked layer
    leaf's at 14 of qwen2-7b's); its first half is."""
    g = num_groups(cfg)
    shape = {"groups": g, "group_layers": group_layers(cfg)}
    if g <= 3:
        return dict(measure_step(cfg, kind, b, s, device), extrapolated=False, **shape)
    if kind == "train":
        def part(c):
            return _measure_grads(c, b, s, device)
    else:
        def part(c):
            return measure_step(c, kind, b, s, device)
    two, three = part(at_groups(cfg, 2)), part(at_groups(cfg, 3))
    out = {k: two[k] + (three[k] - two[k]) * (g - 2) for k in two}
    if kind == "train":
        tail = _measure_apply(cfg, b, s, device)
        out = {"flops": out["flops"] + tail["flops"],
               "peak_bytes": max(out["peak_bytes"], tail["peak_bytes"])}
    return dict(out, extrapolated=True, **shape)


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


def card_memory() -> tuple[int, str]:
    """The card's memory in bytes, and where the number comes from."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                f"torch.cuda.get_device_properties(0).total_memory "
                f"({torch.cuda.get_device_name(0)})")
    return int(mesh_lib.HBM_BYTES), "launch.mesh.HBM_BYTES (no card present)"


def meshes_for(multi_pod: bool = False, both: bool = False) -> list:
    """The card mesh, then the pod mesh(es) asked for."""
    pods = ([mesh_lib.make_production_mesh(), mesh_lib.make_production_mesh(multi_pod=True)]
            if both else [mesh_lib.make_production_mesh(multi_pod=multi_pod)])
    return [mesh_lib.make_card_mesh()] + pods


def record(arch: str, shape_name: str, mesh, *, activations: bool = True) -> dict:
    """One (arch, shape, mesh) record; `activations=False` skips the `meta`
    run on the card mesh (static bytes only)."""
    cfg = configs.get(arch)
    shape = shapes_lib.get(shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh.name,
           "chips": mesh_lib.mesh_chips(mesh), "kind": shape.kind,
           "layers": cfg.num_layers, "global_batch": shape.global_batch,
           "seq_len": shape.seq_len}
    if shape_name == "long_500k" and arch not in LONG_OK:
        return dict(rec, skipped=LONG_SKIP)
    t0 = time.perf_counter()
    static = static_bytes(cfg, shape, mesh)
    card_bytes, card_source = card_memory()
    rec.update(collectives=None, collectives_reason=NO_COLLECTIVES,
               memory={**{f"{k}_bytes": v for k, v in static.items()},
                       "card_bytes": card_bytes, "card_bytes_source": card_source})
    memory_s = static["total"] / mesh_lib.HBM_BW
    on_card = mesh.devices.size == 1
    if on_card and activations:
        est = estimate(cfg, shape.kind, shape.global_batch, shape.seq_len)
        peak = max(est["peak_bytes"], static["total"])
        compute_s = est["flops"] / mesh_lib.PEAK_FLOPS_BF16
        rec.update(flops=est["flops"], flops_counted=FLOPS_COUNTED, plain_kernels=PLAIN_KERNELS,
                   depth={k: est[k] for k in ("groups", "group_layers", "extrapolated")},
                   activations=peak - static["total"])
        rec["memory"].update(peak_bytes=peak, activation_bytes=peak - static["total"])
        rec["roofline"] = {"compute_s": compute_s, "memory_s": memory_s,
                           "bottleneck": "compute_s" if compute_s >= memory_s else "memory_s"}
        rec["fits_card"], rec["fits_card_counts"] = peak <= card_bytes, "static + activations"
    else:
        rec["flops"] = None
        rec["activations"] = None
        rec["activations_reason"] = (NO_POD_ACTIVATIONS if not on_card
                                     else "not run (static bytes only)")
        rec["roofline"] = {"compute_s": None, "memory_s": memory_s, "bottleneck": None}
        rec["fits_card"], rec["fits_card_counts"] = static["total"] <= card_bytes, "static"
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def write(rec: dict, outdir: str, tag: str = "") -> str:
    os.makedirs(outdir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(outdir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def run_one(arch: str, shape_name: str, mesh, outdir: str = OUTDIR, tag: str = "") -> dict:
    print(f"[dryrun] {arch} x {shape_name} on {mesh.name} ...", flush=True)
    rec = record(arch, shape_name, mesh)
    if outdir:
        write(rec, outdir, tag)
    if "skipped" in rec:
        print(f"[dryrun]   SKIP: {rec['skipped']}", flush=True)
        return rec
    m = rec["memory"]
    line = (f"[dryrun]   static {m['total_bytes'] / 1e9:.3f} GB a device "
            f"(params {m['params_bytes'] / 1e9:.3f}, grads {m['grads_bytes'] / 1e9:.3f}, "
            f"opt {m['opt_state_bytes'] / 1e9:.3f}, batch {m['batch_bytes'] / 1e9:.4f}, "
            f"cache {m['cache_bytes'] / 1e9:.3f})")
    if rec["flops"] is not None:
        r = rec["roofline"]
        line += (f"; flops {rec['flops']:.4g}, peak {m['peak_bytes'] / 1e9:.3f} GB -> "
                 f"compute {r['compute_s'] * 1e3:.2f} ms | memory {r['memory_s'] * 1e3:.2f} "
                 f"ms [{r['bottleneck']}]")
    print(line + f"; fits_card={rec['fits_card']} ({rec['fits_card_counts']}), "
          f"{rec['wall_s']:.1f} s", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) pod mesh in place of (16, 16)")
    ap.add_argument("--both-meshes", action="store_true", help="both pod meshes")
    ap.add_argument("--tag", default="", help="suffix for output files")
    ap.add_argument("--outdir", default=OUTDIR)
    args = ap.parse_args(argv)

    archs = list(REFERENCE_ARCHS) if args.arch == "all" else [args.arch]
    shape_names = list(shapes_lib.SHAPES) if args.shape == "all" else [args.shape]
    failures = []
    for arch in archs:
        for shape_name in shape_names:
            for mesh in meshes_for(args.multi_pod, args.both_meshes):
                try:
                    run_one(arch, shape_name, mesh, args.outdir, args.tag)
                except Exception as e:  # noqa: BLE001 - the grid goes on; failures exit 1
                    failures.append((arch, shape_name, mesh.name, repr(e)))
                    print(f"[dryrun] FAIL {arch} x {shape_name} on {mesh.name}: {e}",
                          flush=True)
                    traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("   ", f)
        return 1
    print("[dryrun] every combination recorded")
    return 0


if __name__ == "__main__":
    sys.exit(main())
