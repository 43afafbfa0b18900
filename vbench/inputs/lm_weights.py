"""Input generator `lm_weights`: a language model's weights drawn on the
device from the run's seed.

A configuration that names it (`"inputs": "lm_weights"`) names the port's
architecture (`arch`, a registered `repro_torch.configs` name) and gives
its widths under the `ArchConfig` field names; the file's values are the
ones served. The parameter tree takes the layout the port's model reads
(`models.model.build_schema`: keys, shapes, types); the values are drawn
here, leaf by leaf in sorted order from one `torch.Generator` on the
device, each in float32 and then cast to the leaf's type:

  normal        truncated normal (+-2 sigma), sigma 1/sqrt(fan in): the
                matrix's input width (the second-last axis), a vector's
                length
  small_normal  the same times 0.1
  decay         uniform in (-6, -2)
  zeros, ones   as named

The program receives only these tensors. The check's reference reads the
same ones.
"""

import dataclasses
import math

import torch

from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models import params as plib

U64 = (1 << 64) - 1


@dataclasses.dataclass
class LM:
    cfg: object  # the port's ArchConfig at the file's widths
    params: dict


def arch_config(config: dict):
    """The port's `ArchConfig` of `config["arch"]` with every field the
    file gives taken from the file."""
    base = configs.get(config["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    return dataclasses.replace(base, **{k: v for k, v in config.items() if k in fields})


def _draw(pdef, gen, dev) -> torch.Tensor:
    shape, kind = pdef.shape, pdef.init
    if kind in ("zeros", "ones"):
        out = torch.full(shape, float(kind == "ones"), device=dev)
    elif kind == "decay":
        out = torch.empty(shape, device=dev).uniform_(-6.0, -2.0, generator=gen)
    elif kind in ("normal", "small_normal"):
        fan_in = shape[-2] if len(shape) > 1 else shape[0]
        sigma = (0.1 if kind == "small_normal" else 1.0) / math.sqrt(fan_in)
        out = torch.empty(shape, device=dev)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
        out.mul_(sigma)
    else:
        raise ValueError(f"no draw for init {kind!r}")
    return out.to(plib.DTYPES[pdef.dtype])


def make(config: dict, seed: int, device) -> LM:
    """The weights of `config`, drawn from `seed` on `device`."""
    cfg = arch_config(config)
    gen = torch.Generator(device=device).manual_seed(int(seed) & U64)
    params: dict = {}
    for path, pdef in plib.leaves(M.build_schema(cfg)):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _draw(pdef, gen, gen.device)
    return LM(cfg, params)
