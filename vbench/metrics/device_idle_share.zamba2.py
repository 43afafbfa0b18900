"""Metric `device_idle_share.zamba2`: `vbench.readers.idle_share`."""

from vbench.readers import idle_share as read  # noqa: F401
