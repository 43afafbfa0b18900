"""Metric `chunk_scan_roofline.zamba2`: `vbench.readers.chunk_scan_roofline`."""

from vbench.readers import chunk_scan_roofline as read  # noqa: F401
