import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture(scope="session")
def zoo_root(tmp_path_factory):
    """A checkout whose benchmark also has the tiny zoo cell."""
    from _tiny import zoo_checkout

    return zoo_checkout(tmp_path_factory.mktemp("zoo"))
