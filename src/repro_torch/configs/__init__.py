"""Architecture configs. Importing this package registers every arch.

Every arch the reference registers, each with its serving path on the port:
the dense family (`qwen2-7b`, `gemma-7b`, `gemma2-9b`, `gemma2-9b-sw`,
`phi3-medium-14b`), the ssm family (`rwkv6-1.6b`), the hybrid family
(`zamba2-2.7b`), the audio family (`whisper-base`), the VLM family
(`llama-3.2-vision-90b`) and the MoE family (`arctic-480b`,
`llama4-maverick-400b-a17b`; `expert_share` for one card's share of their
experts). `configs.shapes` holds the reference's four input shapes.
"""

from repro_torch.configs import shapes  # noqa: F401
from repro_torch.configs.arctic_480b import ARCTIC_480B  # noqa: F401
from repro_torch.configs.base import (ArchConfig, ExpertShare, expert_share, get,  # noqa: F401
                                      names, register)
from repro_torch.configs.gemma2_9b import GEMMA2_9B, GEMMA2_9B_SW  # noqa: F401
from repro_torch.configs.gemma_7b import GEMMA_7B  # noqa: F401
from repro_torch.configs.llama4_maverick_400b_a17b import LLAMA4_MAVERICK_400B  # noqa: F401
from repro_torch.configs.llama_3_2_vision_90b import LLAMA_3_2_VISION_90B  # noqa: F401
from repro_torch.configs.phi3_medium_14b import PHI3_MEDIUM_14B  # noqa: F401
from repro_torch.configs.qwen2_7b import QWEN2_7B  # noqa: F401
from repro_torch.configs.rwkv6_1_6b import RWKV6_1_6B  # noqa: F401
from repro_torch.configs.whisper_base import WHISPER_BASE  # noqa: F401
from repro_torch.configs.zamba2_2_7b import ZAMBA2_2_7B  # noqa: F401
