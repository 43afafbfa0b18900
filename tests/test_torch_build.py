"""`repro_torch.kernels._build`: a library is built once and keeps its
compiler report beside it.

nvcc is not on this host: a stand-in compiler (a Python script) writes the
output file and prints a ptxas-style report, as `nvcc -Xptxas -v` does.
"""

import stat
import sys

from repro_torch.kernels import _build

REPORT = ("ptxas info    : Compiling entry function '_Z1kPf' for 'sm_90a'\n"
          "ptxas info    : Used 12 registers, 4096 bytes smem, 360 bytes cmem[0]\n")


def _fake_nvcc(tmp_path, calls):
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"open({str(calls)!r}, 'a').write('x')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'lib')\n"
        f"sys.stderr.write({REPORT!r})\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_cached_build_returns_the_report_kept_beside_the_library(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path, calls))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    source = tmp_path / "k.cu"
    source.write_text("__global__ void k(float* x) {}\n")
    path, report = _build.build(source, "k")
    assert report == REPORT and path.read_bytes() == b"lib"
    kept = path.with_suffix(".ptxas.txt")
    assert kept.name == path.name[:-len(".so")] + ".ptxas.txt"
    assert kept.read_text() == REPORT
    again, report2 = _build.build(source, "k")
    assert (again, report2) == (path, REPORT)
    assert calls.read_text() == "x"  # compiled once
    # A library built without a kept report (an older build) returns "".
    kept.unlink()
    assert _build.build(source, "k") == (path, "")
    source.write_text("__global__ void k(float* x) { x[0] = 1; }\n")
    path2, report3 = _build.build(source, "k")
    assert path2 != path and report3 == REPORT and calls.read_text() == "xx"
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [path.name, path2.name, path2.with_suffix(".ptxas.txt").name])
