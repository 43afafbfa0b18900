"""`vbench/tests/test_vbench_card.py`, collected with the port's tests."""

from _torch_vbench import reexport

reexport("test_vbench_card", globals())
