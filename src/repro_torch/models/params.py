"""Parameter schema: declare each weight once with shape + logical axes.

The reference's `PDef` and `init_params` (`repro.models.params`), drawn with
a `torch.Generator` directly on the target device. The init kinds are the
reference's: ``normal`` (truncated at ±2, fan-in scaled), ``small_normal``
(the same times 0.1), ``zeros``, ``ones`` and ``decay`` (U(-6, -2)). JAX's
threefry and torch's Philox streams differ, so the same seed gives other
weights than the reference's; tests carry the reference's weights across
with `models.convert.params_from_reference` instead.

`abstract_params` gives the dry run's tensors on the `meta` device (shape
and dtype, no storage); `partition_specs` maps each leaf's logical axes
through a rule table (`sharding.specs.build_rules`) to a plain-tuple spec.
`count_params` and `tree_bytes` take a tree of tensors or of `PDef`s (so a
full config is counted without allocating it).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import DeviceLike, resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class PDef:
    """One parameter's declaration."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | decay | small_normal
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


Schema = dict  # nested dict[str, PDef | Schema]


def _fan_in(shape: tuple[int, ...]) -> int:
    # For stacked (layers-leading) weights, fan-in excludes the output
    # (last) dim, as the reference's does.
    if len(shape) == 1:
        return shape[0]
    return math.prod(shape[:-1])


def leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


def init_params(schema: Schema, *, seed: int = 0, device: DeviceLike = None) -> dict:
    """Materialize real parameters on `device` (default CUDA) from `seed`:
    one generator on that device draws every leaf in sorted-path order."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: dict = {}
    for path, pdef in leaves(schema):
        dtype = DTYPES[pdef.dtype]
        if pdef.init == "zeros":
            arr = torch.zeros(pdef.shape, dtype=dtype, device=dev)
        elif pdef.init == "ones":
            arr = torch.ones(pdef.shape, dtype=dtype, device=dev)
        elif pdef.init == "decay":
            # SSM decay-ish params: a stable negative band.
            arr = torch.empty(pdef.shape, dtype=torch.float32, device=dev)
            arr.uniform_(-6.0, -2.0, generator=gen)
            arr = arr.to(dtype)
        elif pdef.init in ("normal", "small_normal"):
            scale = 1.0 / math.sqrt(max(_fan_in(pdef.shape), 1))
            if pdef.init == "small_normal":
                scale *= 0.1
            arr = torch.empty(pdef.shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(arr, 0.0, 1.0, -2.0, 2.0, generator=gen)
            arr = arr.mul_(scale).to(dtype)
        else:
            raise ValueError(f"unknown init {pdef.init!r} at {'/'.join(path)}")
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return out


def abstract_params(schema: Schema) -> dict:
    """The parameter tree as `meta` tensors (the dry run's: no allocation)."""
    return map_tree(lambda pdef: torch.empty(pdef.shape, dtype=DTYPES[pdef.dtype],
                                               device="meta"), schema)


def partition_specs(schema: Schema, rules: dict) -> dict:
    """The spec tree: each leaf's logical axes through `rules` (unknown axes
    replicate). A dim its mesh axis does not divide must already be out of
    the rules (`sharding.specs.build_rules` drops it)."""
    return map_tree(lambda pdef: tuple(rules.get(a) for a in pdef.axes), schema)


def map_tree(fn, tree):
    """`fn` of every leaf of a nested dict (a schema's `PDef`s, a tree of
    tensors), in a tree of the same keys."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _itemsize(x) -> int:
    if isinstance(x, PDef):
        return DTYPES[x.dtype].itemsize
    return x.element_size()


def tree_bytes(tree) -> int:
    return sum(math.prod(x.shape) * _itemsize(x) for _, x in leaves(tree))


def count_params(tree) -> int:
    return sum(math.prod(x.shape) for _, x in leaves(tree))
