"""Metric `decode_attn_roofline.zamba2`: `vbench.readers.decode_attn_roofline`."""

from vbench.readers import decode_attn_roofline as read  # noqa: F401
