"""Metric `serve_tokens_per_s`: `vbench.readers.tokens_per_s`."""

from vbench.readers import tokens_per_s as read  # noqa: F401
