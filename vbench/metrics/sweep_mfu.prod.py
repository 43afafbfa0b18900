"""Metric `sweep_mfu.prod`: `vbench.readers.sweep_mfu`."""

from vbench.readers import sweep_mfu as read  # noqa: F401
