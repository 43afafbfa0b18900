"""Metric `ttft_mean_ms`: `vbench.readers.first_token_mean_ms`."""

from vbench.readers import first_token_mean_ms as read  # noqa: F401
