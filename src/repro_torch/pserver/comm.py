"""The worker seam of the mesh fit tiers: three collectives, two renderings.

The reference runs one worker a TPU device inside `shard_map` and reaches
its peers through `jax.lax` collectives. The port's sweep code instead
talks to one of these objects, and never asks which one it has:

  `Stacked`       all W workers in this process (the card, and the CPU
                  tests): every per-worker tensor carries a leading (W,)
                  axis, so `all_gather` is the tensor itself, `psum` a sum
                  over that axis broadcast back to every worker, and
                  `psum_scatter` a sum over each model group followed by
                  a slice of `v_shard` rows a model index;
  `ProcessGroup`  one worker a rank over `torch.distributed`
                  (`all_gather_into_tensor`, `all_reduce`,
                  `reduce_scatter_tensor`); its per-worker tensors carry a
                  leading axis of 1.

Workers form a (n_data, n_model) grid with flat index
``d * n_model + m`` (row-major, the model axis minor), as
`topology.build_plan` lays out their documents. `worker_ids` are the flat
indices of this process's workers (all W for `Stacked`, the rank for
`ProcessGroup`), and `generators` derives one generator a worker from
the caller's: the worker index the reference folds into its key.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """SplitMix64's finalizer: a well-spread 64-bit word from any 64-bit word."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class _Seam:
    """What both renderings share: the grid and the per-worker helpers."""

    n_data: int
    n_model: int
    worker_ids: list

    @property
    def n_workers(self) -> int:
        return self.n_data * self.n_model

    @property
    def w_local(self) -> int:
        """Workers in this process: the length of the leading axis."""
        return len(self.worker_ids)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a (W, ...) tensor that every process holds."""
        if self.w_local == self.n_workers:
            return x
        return x[self.worker_ids[0]: self.worker_ids[-1] + 1]

    def generators(self, gen: Optional[torch.Generator], device) -> list:
        """One generator a local worker. A single worker keeps the caller's
        generator itself (the reference leaves its key unfolded at one
        worker), so a one-worker run consumes it as `core.gibbs.run` does.
        Otherwise one word is drawn from `gen` — `philox_key` on the card
        (no sync), a `randint` on the CPU — and worker w's generator is
        seeded from that word mixed with w, so every process that holds the
        same caller state derives the same W generators."""
        if self.n_workers == 1:
            return [gen]
        if gen is None:  # injected noise: the engines draw nothing
            return [None] * self.w_local
        if gen.device.type == "cuda":
            from repro_torch.kernels.lda_gibbs.ops import philox_key

            seed, offset = philox_key(gen)
            base = _mix(seed ^ _mix(offset))
        else:
            base = int(torch.randint(0, 1 << 62, (1,), generator=gen))
        return [torch.Generator(device=device).manual_seed(_mix(base ^ _mix(w)) >> 1)
                for w in self.worker_ids]


class Stacked(_Seam):
    """W = n_data * n_model workers in one process on a leading (W,) axis."""

    def __init__(self, n_data: int = 1, n_model: int = 1):
        if n_data < 1 or n_model < 1:
            raise ValueError(f"a worker grid needs n_data, n_model >= 1, got "
                             f"({n_data}, {n_model})")
        self.n_data, self.n_model = int(n_data), int(n_model)
        self.worker_ids = list(range(self.n_workers))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(W, ...) per-worker pieces -> the (W, ...) tensor of all of them."""
        return x

    def psum(self, x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Sum over every worker (`axis` None) or over the data index within
        each model column (`axis="data"`), broadcast back: (W, ...) -> (W, ...)."""
        if axis is None:
            return x.sum(0, keepdim=True).expand_as(x).contiguous()
        if axis != "data":
            raise ValueError(f"psum axis must be None or 'data', got {axis!r}")
        if self.n_data == 1:
            return x
        g = x.reshape(self.n_data, self.n_model, *x.shape[1:])
        return g.sum(0, keepdim=True).expand_as(g).reshape(x.shape)

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled reduce-scatter over the model axis on the row dimension:
        (W, R, ...) -> (W, R / n_model, ...), worker (d, m) holding rows
        [m R/n_model, (m+1) R/n_model) of its model group's sum."""
        if self.n_model == 1:
            return x
        rows = x.shape[1]
        if rows % self.n_model:
            raise ValueError(f"{rows} rows do not split over {self.n_model} model shards")
        g = x.reshape(self.n_data, self.n_model, rows, *x.shape[2:]).sum(1)
        return g.reshape(self.n_data * self.n_model, rows // self.n_model, *x.shape[2:])

    def __repr__(self):
        return f"Stacked(n_data={self.n_data}, n_model={self.n_model})"


class ProcessGroup(_Seam):
    """One worker a rank of the initialized default `torch.distributed`
    group (gloo on the CPU): rank r is flat worker r. Every rank must
    construct it, in the same order, since the model and data subgroups
    are made here."""

    def __init__(self, n_data: int, n_model: int = 1):
        import torch.distributed as dist

        self._dist = dist
        self.n_data, self.n_model = int(n_data), int(n_model)
        world = dist.get_world_size()
        if world != self.n_workers:
            raise ValueError(f"a ({n_data}, {n_model}) grid needs {self.n_workers} ranks, "
                             f"the group has {world}")
        self.rank = dist.get_rank()
        self.worker_ids = [self.rank]
        self._model_group = self._data_group = None
        for d in range(self.n_data):  # every rank makes every subgroup, in order
            g = dist.new_group([d * self.n_model + m for m in range(self.n_model)])
            if d == self.rank // self.n_model:
                self._model_group = g
        for m in range(self.n_model):
            g = dist.new_group([d * self.n_model + m for d in range(self.n_data)])
            if m == self.rank % self.n_model:
                self._data_group = g

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty((self.n_workers, *x.shape[1:]), dtype=x.dtype, device=x.device)
        self._dist.all_gather_into_tensor(out, x.contiguous())
        return out

    def psum(self, x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        if axis not in (None, "data"):
            raise ValueError(f"psum axis must be None or 'data', got {axis!r}")
        if axis == "data" and self.n_data == 1:
            return x
        y = x.clone()
        self._dist.all_reduce(y, group=None if axis is None else self._data_group)
        return y

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        if self.n_model == 1:
            return x
        rows = x.shape[1]
        if rows % self.n_model:
            raise ValueError(f"{rows} rows do not split over {self.n_model} model shards")
        out = torch.empty((rows // self.n_model, *x.shape[2:]), dtype=x.dtype, device=x.device)
        self._dist.reduce_scatter_tensor(out, x[0].contiguous(), group=self._model_group)
        return out[None]

    def __repr__(self):
        return f"ProcessGroup(n_data={self.n_data}, n_model={self.n_model}, rank={self.rank})"


Seam = Union[Stacked, ProcessGroup]


def make(workers: Union[Seam, int, Sequence[int]] = (1, 1)) -> Seam:
    """A seam from a seam, a worker count (all on the data axis) or an
    (n_data, n_model) pair (a `Stacked` grid in this process)."""
    if isinstance(workers, _Seam):
        return workers
    if isinstance(workers, int):
        return Stacked(workers, 1)
    n_data, n_model = workers
    return Stacked(n_data, n_model)
