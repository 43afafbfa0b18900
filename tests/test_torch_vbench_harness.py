"""`vbench/tests/test_vbench_harness.py`, collected with the port's tests."""

from _torch_vbench import reexport

reexport("test_vbench_harness", globals())
