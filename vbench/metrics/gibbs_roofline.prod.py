"""Metric `gibbs_roofline.prod`: `vbench.readers.gibbs_roofline`."""

from vbench.readers import gibbs_roofline as read  # noqa: F401
