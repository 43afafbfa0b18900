"""Metric `serve_mfu.zamba2`: `vbench.readers.serve_mfu`."""

from vbench.readers import serve_mfu as read  # noqa: F401
