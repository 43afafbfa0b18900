"""The card's constants and mesh descriptions.

The reference's `repro.launch.mesh` builds jax meshes over TPU v5e chips.
One H100 has no mesh, so here a mesh is a description: axis names and
sizes, with no devices. The dry run (`launch.dryrun`) and the spec rules
(`sharding.specs`) read it to say what a device of a pod would hold; the
card itself runs everything on its own.

  make_production_mesh()               ("data", "model") (16, 16): a pod of 256
  make_production_mesh(multi_pod=True) ("pod", "data", "model") (2, 16, 16): 512;
                                       the 'pod' axis carries pure data parallelism
  make_card_mesh()                     (1, 1) with the production axis names: one
                                       card (the reference's `make_host_mesh`)

A `Mesh` exposes `axis_names` and `devices.shape` / `devices.size`, the
two attributes the reference's rule builders read from a jax mesh, so a
test can hand one description to both packages.

The constants are those of one NVIDIA H100 80GB HBM3 SXM at its 700 W
limit (NVIDIA's data sheet, dense rates): the roofline terms of
`launch.dryrun` and `launch.dryrun_rlda`.
"""

from __future__ import annotations

import dataclasses
import math

# NVIDIA H100 80GB HBM3 SXM, 700 W (NVIDIA data sheet, dense, no sparsity).
PEAK_FLOPS_BF16 = 989e12  # tensor cores, bf16 in, float32 accumulation
PEAK_FLOPS_F32 = 67e12  # float32 outside the tensor cores
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s a direction (NVLink 4, 18 links)
HBM_BYTES = 80e9


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """The shape of a mesh's device array, with no devices in it."""

    shape: tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named mesh: axis names and sizes, no devices."""

    name: str
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{self.name}: axes {self.axis_names} and shape {self.shape} "
                             f"differ in rank")

    @property
    def devices(self) -> DeviceGrid:
        return DeviceGrid(self.shape)

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh("pod2x16x16", ("pod", "data", "model"), (2, 16, 16))
    return Mesh("pod16x16", ("data", "model"), (16, 16))


def make_card_mesh() -> Mesh:
    """One card, with the production axis names (every axis of size 1)."""
    return Mesh("h100x1", ("data", "model"), (1, 1))


def mesh_chips(mesh) -> int:
    return int(mesh.devices.size)
