"""Metric `setup_s`: `vbench.readers.setup_s`."""

from vbench.readers import setup_s as read  # noqa: F401
