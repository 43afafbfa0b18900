"""Metric `alias_roofline.prod`: `vbench.readers.alias_roofline`."""

from vbench.readers import alias_roofline as read  # noqa: F401
