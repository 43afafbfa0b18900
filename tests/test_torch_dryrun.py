"""The port's one-card dry run (`launch.dryrun`) on the CPU.

- Static bytes a device equal a sum over the reference's own specs and
  abstract shapes (`model_pspecs`, `state_pspecs`, `batch_pspecs`,
  `cache_pspecs` on its `FakeMesh` idiom), for every registered arch and
  shape on each mesh.
- The `meta` run counts what a run on real CPU tensors counts: the same
  FLOPs and the same tracked peak of live bytes, exactly, for a reduced
  arch of every family and every step kind (`meta` following the CPU's
  GEMM branch here, `layers.OUT_DTYPE_GEMM_DEVICES`, so both run one code).
- The depth extrapolation (two and three groups) equals a full-depth
  `meta` run on reduced widths at five groups: the FLOPs exactly, the peak
  within `PEAK_SLACK` bytes (storages of a few bytes, a VLM gate's
  positions among them, live or not at the peak's moment from one depth
  to the next: 32 bytes of 3.4 MB at most here).
- The served wrappers take their plain versions on `meta` and raise on a
  device that is neither the CPU, `meta` nor CUDA.
"""

import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as ref_configs  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import optim as RO  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.configs.base import REFERENCE_ARCHS  # noqa: E402
from repro_torch.kernels.alias_mh import ops as mh_ops  # noqa: E402
from repro_torch.kernels.chunk_scan import ops as cs_ops  # noqa: E402
from repro_torch.kernels.decode_attn import ops as da_ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import layers  # noqa: E402

# One reduced arch of each family, and the pair / group layouts.
FAMILY_ARCHS = ["qwen2-7b", "gemma2-9b", "arctic-480b", "llama4-maverick-400b-a17b",
                "rwkv6-1.6b", "zamba2-2.7b", "llama-3.2-vision-90b", "whisper-base"]
KINDS = ["train", "prefill", "decode"]
PEAK_SLACK = 4096  # bytes: 8 of the card allocator's 512-byte blocks


class FakeMesh:
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


MESHES = [(mesh_lib.make_card_mesh(), {"data": 1, "model": 1}),
          (mesh_lib.make_production_mesh(), {"data": 16, "model": 16}),
          (mesh_lib.make_production_mesh(multi_pod=True), {"pod": 2, "data": 16, "model": 16})]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_leaves(tree[k])
    else:
        yield tree


def _ref_bytes(abstract, specs, sizes) -> int:
    """Per-device bytes of a reference tree of ShapeDtypeStructs under its
    PartitionSpecs, the division done here."""
    total = 0
    for sds, spec in zip(_ref_leaves(abstract), _ref_leaves(specs)):
        entries = tuple(spec) + (None,) * (len(sds.shape) - len(tuple(spec)))
        n = 1
        for dim, entry in zip(sds.shape, entries):
            names = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
            ways = int(np.prod([sizes[a] for a in names])) if names else 1
            assert dim % ways == 0
            n *= dim // ways
        total += n * np.dtype(sds.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
@pytest.mark.parametrize("shape_name", list(shapes.SHAPES))
def test_static_bytes_equal_the_reference_specs(arch, shape_name):
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    shp = ref_shapes.get(shape_name)
    kind, b, s = shp.kind, shp.global_batch, shp.seq_len
    for mesh, sizes in MESHES:
        fake = FakeMesh(sizes)
        got = D.static_bytes(cfg, shapes.get(shape_name), mesh)
        params = RM.abstract_model(ref_cfg)
        pspecs = RM.model_pspecs(ref_cfg, fake)
        want = {"params": _ref_bytes(params, pspecs, sizes),
                "batch": _ref_bytes(RM.abstract_batch(ref_cfg, kind, b, s),
                                    RM.batch_pspecs(ref_cfg, fake, kind, b), sizes),
                "grads": 0, "opt_state": 0, "cache": 0}
        if kind == "train":
            opt = RO.make_optimizer(RO.OptConfig(name=ref_cfg.optimizer))
            want["opt_state"] = _ref_bytes(opt.abstract_state(params),
                                           opt.state_pspecs(pspecs), sizes)
            accum = np.dtype(ref_cfg.grad_accum_dtype).itemsize
            want["grads"] = (want["params"] if ref_cfg.microbatch == 1 else
                             sum(_ref_bytes(p, s_, sizes) // np.dtype(p.dtype).itemsize * accum
                                 for p, s_ in zip(_ref_leaves(params), _ref_leaves(pspecs))))
        else:
            want["cache"] = _ref_bytes(RM.abstract_cache(ref_cfg, b, s),
                                       RM.cache_pspecs(ref_cfg, fake, b, s, kind=kind), sizes)
        want["total"] = sum(want.values())
        assert got == want, (mesh.name, got, want)


def _small(arch):
    cfg = configs.get(arch).reduced()
    if cfg.arch_type == "vlm":
        cfg = dataclasses.replace(cfg, num_frontend_tokens=8)
    return cfg


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_meta_run_counts_what_a_cpu_run_counts(arch, kind, monkeypatch):
    monkeypatch.setattr(layers, "OUT_DTYPE_GEMM_DEVICES", ("cuda",))
    cfg = _small(arch)
    meta = D.measure_step(cfg, kind, 2, 32, "meta")
    cpu = D.measure_step(cfg, kind, 2, 32, "cpu")
    assert meta["flops"] > 0
    assert meta == cpu


def test_meta_takes_the_cards_gemm_branch(monkeypatch):
    """With `meta` on the card's branch (the default), the loss's and the
    last logits' float32 GEMMs widen no table: the peaks of the train
    step's first half and of a prefill drop below the CPU branch's."""
    cfg = dataclasses.replace(_small("qwen2-7b"), vocab_size=50_000)
    assert "meta" in layers.OUT_DTYPE_GEMM_DEVICES

    def both():
        return D._measure_grads(cfg, 2, 32, "meta"), D.measure_step(cfg, "prefill", 2, 32)

    card = both()
    monkeypatch.setattr(layers, "OUT_DTYPE_GEMM_DEVICES", ("cuda",))
    for got, widened in zip(card, both()):
        assert got["flops"] == widened["flops"]
        assert got["peak_bytes"] < widened["peak_bytes"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_depth_extrapolation_equals_a_full_depth_run(arch, kind):
    cfg = _small(arch)
    cfg = D.at_groups(cfg, 5)
    assert D.num_groups(cfg) == 5
    est = D.estimate(cfg, kind, 2, 32)
    assert est["extrapolated"] and est["groups"] == 5
    full = D.measure_step(cfg, kind, 2, 32)
    assert est["flops"] == full["flops"]
    assert abs(est["peak_bytes"] - full["peak_bytes"]) <= PEAK_SLACK


def test_hardware_constants_are_the_h100s():
    assert mesh_lib.PEAK_FLOPS_BF16 == 989e12
    assert mesh_lib.PEAK_FLOPS_F32 == 67e12
    assert mesh_lib.HBM_BW == 3.35e12
    assert mesh_lib.NVLINK_BW == 450e9
    assert mesh_lib.HBM_BYTES == 80e9


def test_groups_of_each_family():
    want = {"qwen2-7b": (1, 28), "gemma2-9b": (2, 21), "gemma2-9b-sw": (1, 42),
            "arctic-480b": (1, 35), "llama4-maverick-400b-a17b": (2, 24),
            "rwkv6-1.6b": (1, 24), "zamba2-2.7b": (6, 9), "llama-3.2-vision-90b": (5, 20),
            "whisper-base": (1, 6)}
    for arch, (per, groups) in want.items():
        cfg = configs.get(arch)
        assert (D.group_layers(cfg), D.num_groups(cfg)) == (per, groups), arch
        cut = D.at_groups(cfg, 2)
        assert cut.num_layers == 2 * per


def _stand_in(device: str):
    """An object with a tensor's `device` on a device torch cannot hold here."""
    return types.SimpleNamespace(device=torch.device(device))


def test_served_wrappers_take_their_plain_versions_on_meta():
    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    bf = torch.bfloat16
    out = da_ops.decode_attention(m(2, 8, 64, dtype=bf), m(2, 128, 4, 64, dtype=bf),
                                  m(2, 128, 4, 64, dtype=bf), length=128, pos=127)
    assert out.device.type == "meta" and out.shape == (2, 8, 64)
    y, st = cs_ops.chunk_scan(m(1, 64, 2, 16), m(1, 64, 2, 16), m(1, 64, 2, 16),
                              m(1, 64, 2, 16), m(2, 16), include_current=False, chunk=32)
    assert (y.shape, st.shape) == ((1, 64, 2, 16), (1, 2, 16, 16))
    y, st = cs_ops.chunk_scan_mamba2(m(1, 64, 2), m(1, 64, 16), m(1, 64, 16),
                                     m(1, 64, 2, 8), chunk=32)
    assert (y.shape, st.shape) == ((1, 64, 2, 8), (1, 2, 16, 8))
    n, d, v, k, s = 64, 4, 10, 8, 2
    i32 = torch.int32
    args = (m(n, dtype=i32), m(n, dtype=i32), m(n, dtype=i32), m(n), m(d, k), m(v, k), m(k),
            m(v, k), m(v, k, dtype=i32), m(d, k), m(d, k, dtype=i32))
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.1)
    z = mh_ops.mh_resample(*args, m(s, n, dtype=i32), m(s, n), m(s, n), **hp)
    assert z.device.type == "meta" and z.shape == (n,)
    stacked = tuple(torch.empty((3, *a.shape), dtype=a.dtype, device="meta") for a in args)
    z = mh_ops.mh_resample_many(*stacked, m(3, s, n, dtype=i32), m(3, s, n), m(3, s, n), **hp)
    assert z.shape == (3, n)


def test_served_wrappers_raise_on_other_devices():
    x = _stand_in("xpu")
    with pytest.raises(ValueError, match="no decode_attn kernel for device xpu"):
        da_ops.decode_attention(x, x, x, length=1, pos=0)
    with pytest.raises(ValueError, match="no chunk_scan kernel for device xpu"):
        cs_ops.chunk_scan(x, x, x, x, x, include_current=True)
    with pytest.raises(ValueError, match="no chunk_scan kernel for device xpu"):
        cs_ops.chunk_scan_mamba2(x, x, x, x)
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.1)
    with pytest.raises(ValueError, match="no alias_mh kernel for device xpu"):
        mh_ops.mh_resample(*([x] * 11), **hp)
    with pytest.raises(ValueError, match="no alias_mh kernel for device xpu"):
        mh_ops.mh_resample_many(*([x] * 11), **hp)


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_long_500k_records(arch, tmp_path):
    mesh = mesh_lib.make_production_mesh()
    if arch in D.LONG_OK:
        rec = D.record(arch, "long_500k", mesh, activations=False)
        assert "skipped" not in rec and rec["memory"]["cache_bytes"] > 0
        return
    rec = D.run_one(arch, "long_500k", mesh, outdir=str(tmp_path))
    assert rec["skipped"] == D.LONG_SKIP
    saved = json.loads((tmp_path / f"{arch}__long_500k__pod16x16.json").read_text())
    assert saved == rec


def test_card_and_pod_records():
    """The card mesh's record: FLOPs, the peak and the roofline from the
    `meta` run (decode: seconds at full size), its memory the card's
    (`HBM_BYTES` without one here); a pod mesh's: static bytes only."""
    rec = D.record("qwen2-7b", "decode_32k", mesh_lib.make_card_mesh())
    mem = rec["memory"]
    assert rec["flops"] > 0 and rec["depth"] == {"groups": 28, "group_layers": 1,
                                                 "extrapolated": True}
    assert mem["peak_bytes"] >= mem["total_bytes"] > 0
    assert mem["activation_bytes"] == mem["peak_bytes"] - mem["total_bytes"]
    assert rec["collectives"] is None and rec["collectives_reason"]
    if not torch.cuda.is_available():
        assert mem["card_bytes"] == int(mesh_lib.HBM_BYTES)
    r = rec["roofline"]
    assert r["compute_s"] == rec["flops"] / mesh_lib.PEAK_FLOPS_BF16
    assert r["memory_s"] == mem["total_bytes"] / mesh_lib.HBM_BW
    assert rec["fits_card"] == (mem["peak_bytes"] <= mem["card_bytes"])
    assert rec["fits_card_counts"] == "static + activations"
    pod = D.record("qwen2-7b", "decode_32k", mesh_lib.make_production_mesh())
    assert pod["flops"] is None and pod["activations"] is None
    assert pod["activations_reason"] == D.NO_POD_ACTIVATIONS
    assert pod["fits_card_counts"] == "static"
    assert pod["fits_card"] == (pod["memory"]["total_bytes"] <= pod["memory"]["card_bytes"])


def test_cli_writes_a_record_a_mesh(tmp_path):
    rc = D.main(["--arch", "whisper-base", "--shape", "decode_32k", "--both-meshes",
                 "--outdir", str(tmp_path), "--tag", "t"])
    assert rc == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"whisper-base__decode_32k__{m}__t.json"
                     for m in ("h100x1", "pod16x16", "pod2x16x16")]
