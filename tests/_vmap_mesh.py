"""The reference's mesh programs on one CPU device, for the port's tests.

The reference's sync and program bodies use only `all_gather`, `psum`,
`psum_scatter` and `axis_index`, which `jax.vmap` with named axes runs on
one device: nested vmaps, one per mesh axis, stand in for the device mesh
that `shard_map` would map over. One gap: jax 0.9.0 cannot batch a tiled
`all_gather` over two named axes at once ("axis size doesn't match"), so
`vmappable_all_gather` gathers over the minor axis, then the major one —
the row-major worker order `shard_map` gives the axes tuple.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np


def vmappable_all_gather(one):
    """`jax.lax.all_gather` (`one`) that takes a tuple of named axes under
    nested vmaps: tiled gathers minor axis first."""

    def all_gather(x, axis_name, **kw):
        if isinstance(axis_name, (tuple, list)) and len(axis_name) > 1:
            for a in reversed(axis_name):
                x = one(x, a, **kw)
            return x
        return one(x, axis_name, **kw)

    return all_gather


def on_grid(fn, grid, *xs):
    """`fn` on each worker of an (n_data, n_model) grid (axes "data",
    "model") under nested vmap: (W, ...) arrays in, a tuple of (W, ...)
    arrays out."""
    nd, nm = grid
    f = jax.vmap(jax.vmap(fn, axis_name="model"), axis_name="data")
    outs = f(*(jnp.asarray(x).reshape(nd, nm, *x.shape[1:]) for x in xs))
    return tuple(np.asarray(o).reshape(nd * nm, *o.shape[2:]) for o in outs)


class VmapMesh(contextlib.nullcontext):
    """What the reference's programs read of a mesh (axis names, the
    devices' shape, a `with` block that does nothing), for a worker grid
    run by `vmap_shard_map`."""

    def __init__(self, shape, axis_names=("data", "model")):
        super().__init__()
        self.axis_names = tuple(axis_names)
        self.devices = np.empty(shape, object)


def vmap_shard_map(fn, mesh, in_specs, out_specs):
    """`make_shard_map` under one vmap a mesh axis: arguments sharded on
    dim 0 split into (*mesh shape, rows, ...), replicated ones broadcast;
    outputs sharded over every worker concatenated, over the model axis
    (minor) taken from the first index of the others, replicated ones from
    worker 0."""
    names, shape = tuple(mesh.axis_names), mesh.devices.shape
    lead = len(shape)

    def sharded(spec):
        return len(spec) > 0 and spec[0] is not None

    def run(*args):
        in_axes = tuple(0 if sharded(s) else None for s in in_specs)
        f = fn
        for name in reversed(names):
            f = jax.vmap(f, in_axes=in_axes, axis_name=name)
        outs = f(*(a.reshape(*shape, -1, *a.shape[1:]) if sharded(s) else a
                   for a, s in zip(args, in_specs)))
        first = (0,) * lead
        return tuple(o[first] if not sharded(s)
                     else o[first[:-1]].reshape(-1, *o.shape[lead + 1:]) if s[0] == "model"
                     else o.reshape(-1, *o.shape[lead + 1:])
                     for o, s in zip(outs, out_specs))

    return run
