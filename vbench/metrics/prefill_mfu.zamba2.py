"""Metric `prefill_mfu.zamba2`: `vbench.readers.prefill_mfu`."""

from vbench.readers import prefill_mfu as read  # noqa: F401
