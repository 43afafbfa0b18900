"""Collect the benchmark's CPU tests (`vbench/tests`) with the port's own.

Each `tests/test_torch_vbench_<name>.py` re-exports one module of
`vbench/tests`: its tests, its fixtures (autouse ones included) and its
`pytestmark`, under their own names, so `pytest tests` runs them as they
are. Run them where they live with

    PYTHONPATH=src python -m pytest -q vbench/tests
"""

import importlib
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VBENCH_TESTS = ROOT / "vbench" / "tests"
for _p in (ROOT, VBENCH_TESTS):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def _is_fixture(obj) -> bool:
    return (hasattr(obj, "_fixture_function_marker")  # pytest >= 8.4
            or hasattr(obj, "_pytestfixturefunction"))


def _conftest():
    """`vbench/tests/conftest.py`, loaded under a name of its own so it does
    not shadow `tests/conftest.py`."""
    name = "vbench_tests_conftest"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, VBENCH_TESTS / "conftest.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def reexport(module: str, namespace: dict) -> None:
    """Copy `vbench/tests/<module>.py`'s tests and fixtures, and the
    conftest's fixtures, into a test module's `namespace`."""
    for mod in (_conftest(), importlib.import_module(module)):
        for key, obj in vars(mod).items():
            if key.startswith("test_") or key == "pytestmark" or _is_fixture(obj):
                namespace[key] = obj
