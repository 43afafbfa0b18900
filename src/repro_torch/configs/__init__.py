"""Architecture configs. Importing this package registers every ported arch.

Only `zamba2-2.7b` is ported (the hybrid serving path); the reference's
other archs raise `NotImplementedError` from `get` (ROADMAP.md queue 1,
item 13).
"""

from repro_torch.configs.base import ArchConfig, get, names, register  # noqa: F401
from repro_torch.configs.zamba2_2_7b import ZAMBA2_2_7B  # noqa: F401
