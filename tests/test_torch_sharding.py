"""The port's pod layout (`sharding.specs`, `launch.mesh`, the abstract
builds and specs of `models.params`, `models.model` and `train.optim`)
against the reference's, on the CPU.

Every registered arch on the (16, 16) and (2, 16, 16) production meshes, a
(13, 13) mesh that divides no width, and the (1, 1) card: the reference's
rule builders read a mesh's `axis_names` and `devices.shape`, so the
reference's `FakeMesh` idiom (`tests/test_sharding.py`) and the port's
`launch.mesh.Mesh` are handed to both packages. A reference
`PartitionSpec` is read as a tuple; shapes and dtypes are compared exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as ref_configs  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.sharding import specs as RS  # noqa: E402
from repro.train import optim as RO  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.configs.base import REFERENCE_ARCHS  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import leaves  # noqa: E402
from repro_torch.sharding import specs as S  # noqa: E402
from repro_torch.train import optim as O  # noqa: E402


class FakeMesh:
    """The reference's test idiom: axis names and a device array's shape."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


MESHES = {
    "16x16": ({"data": 16, "model": 16}, mesh_lib.make_production_mesh()),
    "2x16x16": ({"pod": 2, "data": 16, "model": 16},
                mesh_lib.make_production_mesh(multi_pod=True)),
    "13x13": ({"data": 13, "model": 13}, mesh_lib.Mesh("odd13x13", ("data", "model"), (13, 13))),
    "1x1": ({"data": 1, "model": 1}, mesh_lib.make_card_mesh()),
}


@pytest.fixture(params=list(MESHES), ids=list(MESHES))
def meshes(request):
    """(the reference's FakeMesh, the port's Mesh) of the same sizes."""
    sizes, port_mesh = MESHES[request.param]
    return FakeMesh(sizes), port_mesh


def _ref_leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict of the reference, sorted keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _specs(tree) -> dict:
    return {p: tuple(s) for p, s in _ref_leaves(tree)}


def _shapes(tree) -> dict:
    """path -> (shape, dtype name) of a tree of ShapeDtypeStructs or tensors."""
    out = {}
    for p, x in _ref_leaves(tree):
        dt = str(x.dtype).replace("torch.", "")
        out[p] = (tuple(x.shape), dt)
    return out


def test_meshes_describe_the_reference_meshes():
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data", "model"))):
        m = mesh_lib.make_production_mesh(multi_pod=multi)
        assert (m.devices.shape, m.axis_names) == (shape, axes)
        assert mesh_lib.mesh_chips(m) == int(np.prod(shape))
    card = mesh_lib.make_card_mesh()
    assert card.axis_names == ("data", "model") and mesh_lib.mesh_chips(card) == 1


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_build_rules_equal_the_reference(arch, meshes):
    fake, port_mesh = meshes
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    want = RS.build_rules(ref_cfg, fake)
    assert S.build_rules(cfg, fake) == want
    assert S.build_rules(cfg, port_mesh) == want
    # the reference's builder reads the port's mesh description too
    assert RS.build_rules(ref_cfg, port_mesh) == want
    assert S.batch_axes(port_mesh) == RS.batch_axes(fake)


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_activation_specs_equal_the_reference(arch, kind, meshes):
    fake, port_mesh = meshes
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    for global_batch in (0, 1, 32, 256):  # 1: long_500k's batch replicates
        want = {k: tuple(v) for k, v in
                RS.activation_specs(ref_cfg, fake, kind, global_batch).items()}
        assert S.activation_specs(cfg, port_mesh, kind, global_batch) == want


def test_activation_specs_batch_fallback():
    cfg = configs.get("qwen2-7b")
    mesh = mesh_lib.make_production_mesh(multi_pod=True)
    assert S.activation_specs(cfg, mesh, "decode", 256)["residual"][0] == ("pod", "data")
    assert S.activation_specs(cfg, mesh, "decode", 1)["residual"][0] is None
    assert S.activation_specs(cfg, mesh_lib.make_production_mesh(), "train", 1)[
        "residual"] == (None, None, None)


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_model_pspecs_equal_the_reference_leaf_for_leaf(arch, meshes):
    fake, port_mesh = meshes
    want = _specs(RM.model_pspecs(ref_configs.get(arch), fake))
    got = dict(leaves(M.model_pspecs(configs.get(arch), port_mesh)))
    assert got == want


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_abstract_model_equals_the_reference(arch):
    got = M.abstract_model(configs.get(arch))
    assert all(t.device.type == "meta" for _, t in leaves(got))
    assert _shapes(got) == _shapes(RM.abstract_model(ref_configs.get(arch)))


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_cache_pspecs_equal_the_reference(arch, kind, meshes):
    fake, port_mesh = meshes
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    for b, cache_len in ((128, 32_768), (32, 32_768), (1, 524_288), (3, 4_000)):
        want = {k: tuple(v) for k, v in
                RM.cache_pspecs(ref_cfg, fake, b, cache_len, kind=kind).items()}
        assert M.cache_pspecs(cfg, port_mesh, b, cache_len, kind=kind) == want


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_abstract_cache_equals_the_reference(arch):
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    for b, cache_len in ((128, 32_768), (1, 524_288), (2, 100)):
        got = M.abstract_cache(cfg, b, cache_len)
        assert all(t.device.type == "meta" for t in got.values())
        assert _shapes(got) == _shapes(RM.abstract_cache(ref_cfg, b, cache_len))


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_batch_builds_and_specs_equal_the_reference(arch, meshes):
    fake, port_mesh = meshes
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    for name, shp in shapes.SHAPES.items():
        ref_shp = ref_shapes.get(name)
        assert (shp.kind, shp.global_batch, shp.seq_len) == (
            ref_shp.kind, ref_shp.global_batch, ref_shp.seq_len)
        b, s = shp.global_batch, shp.seq_len
        for bb in (b, 3):  # 3 divides no batch axis: the batch replicates
            got = M.batch_pspecs(cfg, port_mesh, shp.kind, bb)
            want = {k: tuple(v) for k, v in
                    RM.batch_pspecs(ref_cfg, fake, shp.kind, bb).items()}
            assert got == want
        built = M.abstract_batch(cfg, shp.kind, b, s)
        assert all(t.device.type == "meta" for t in built.values())
        assert _shapes(built) == _shapes(RM.abstract_batch(ref_cfg, shp.kind, b, s))


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizer_state_builds_and_specs_equal_the_reference(arch, opt_name, meshes):
    fake, port_mesh = meshes
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    opt = O.make_optimizer(O.OptConfig(name=opt_name))
    ref_opt = RO.make_optimizer(RO.OptConfig(name=opt_name))
    state = opt.abstract_state(M.abstract_model(cfg))
    assert all(t.device.type == "meta" for _, t in leaves(state))
    assert _shapes(state) == _shapes(ref_opt.abstract_state(RM.abstract_model(ref_cfg)))
    got = dict(leaves(opt.state_pspecs(M.model_pspecs(cfg, port_mesh))))
    assert got == _specs(ref_opt.state_pspecs(RM.model_pspecs(ref_cfg, fake)))


def test_shard_shape_divides_and_raises_on_an_uneven_split():
    pod2 = mesh_lib.make_production_mesh(multi_pod=True)
    assert S.shard_shape((64, 3584, 7), (("pod", "data"), "model"), pod2) == (2, 224, 7)
    assert S.shard_shape((5,), (None,), pod2) == (5,)
    card = mesh_lib.make_card_mesh()
    assert S.shard_shape((13, 7), ("data", "model"), card) == (13, 7)
    with pytest.raises(ValueError, match="does not split"):
        S.shard_shape((10, 16), ("data", None), mesh_lib.make_production_mesh())
    with pytest.raises(ValueError, match="does not split"):
        S.shard_shape((48,), (("pod", "data"),), pod2)
    with pytest.raises(ValueError, match="longer"):
        S.shard_shape((16,), ("data", None), pod2)


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_rule_built_specs_always_divide(arch, meshes):
    """Every spec the rules build shards exactly (the rules drop each axis a
    dim does not divide), so `shard_shape` never raises on them."""
    _, port_mesh = meshes
    cfg = configs.get(arch)
    specs = dict(leaves(M.model_pspecs(cfg, port_mesh)))
    for path, t in leaves(M.abstract_model(cfg)):
        got = S.shard_shape(t.shape, specs[path], port_mesh)
        assert np.prod(got) * port_mesh.devices.size >= np.prod(t.shape)
