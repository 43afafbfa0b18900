"""Metric `refine_p95_ms`: `vbench.readers.request_p95_ms`."""

from vbench.readers import request_p95_ms as read  # noqa: F401
