"""Metric `launches_per_sweep.prod`: `vbench.readers.launches_per_sweep`."""

from vbench.readers import launches_per_sweep as read  # noqa: F401
