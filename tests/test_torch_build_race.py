"""First use of the port's built-at-first-use libraries from many threads
at once: the host C libraries (``native/hostops.py::build_library``: the
NMS, the RLE API and the JPEG decoder) and the CUDA libraries
(``utils/cuda_build.py::CudaLibrary``, here with a stand-in compiler that
runs ``gcc`` on a tiny C file).  Every thread gets the C library, each
library is built once, and no temporary file is left."""

import os
import stat
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from mx_rcnn_tpu_torch.native import hostops, jpeg, rle
from mx_rcnn_tpu_torch.data.image import load_image
from mx_rcnn_tpu_torch.utils import cuda_build

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "jpeg" / "voc_420_baseline.jpg"


@pytest.fixture
def fresh_host_libs(tmp_path, monkeypatch):
    """An empty build directory and the three modules' load state reset."""
    build = tmp_path / "build"
    monkeypatch.setattr(hostops, "BUILD_DIR", build)
    for mod in (hostops, rle):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", False)
    monkeypatch.setattr(jpeg, "_LIB", None)
    return build


def run_at_once(n: int, fn):
    """``fn(i)`` in ``n`` threads released together, the interpreter
    switching threads every microsecond → results, errors."""
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def work(i):
        barrier.wait()
        try:
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — every failure is asserted on
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return results, errors


@pytest.mark.parametrize("trial", range(3))
def test_eight_threads_first_calls_share_one_build_per_library(fresh_host_libs, trial):
    dets = np.array([[0, 0, 10, 10, 0.9], [1, 1, 11, 11, 0.8], [50, 50, 60, 60, 0.7]],
                    np.float32)
    mask = np.zeros((6, 5), np.uint8)
    mask[1:4, 2:4] = 1

    def first_calls(i):
        which = (i + trial) % 3
        out = []
        for k in range(3):  # each thread calls all three, starting at a different one
            j = (which + k) % 3
            if j == 0:
                out.append(("nms", hostops.nms_host(dets, 0.5)))
            elif j == 1:
                out.append(("rle", rle.encode(mask)["counts"]))
            else:
                out.append(("jpeg", load_image(str(FIXTURE)).sum()))
        return dict(out)

    results, errors = run_at_once(8, first_calls)
    assert errors == []
    assert hostops.backend() == "c" and rle.backend() == "c" and jpeg._LIB is not None
    for r in results:
        assert r == results[0]
    assert results[0]["nms"] == [0, 2]
    built = sorted(os.listdir(fresh_host_libs))
    assert [n.split("-")[0] for n in built] == ["hostops", "jpegdec", "rlelib"], built
    assert all(n.endswith(".so") for n in built)


def test_decodes_in_threads_equal_the_serial_decode(fresh_host_libs):
    want = load_image(str(FIXTURE))
    results, errors = run_at_once(8, lambda i: load_image(str(FIXTURE)))
    assert errors == []
    for r in results:
        np.testing.assert_array_equal(r, want)


def test_failed_host_build_raises_the_compiler_error_and_leaves_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(hostops, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "broken.c"
    src.write_text("int f(void) { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        hostops.build_library(src)
    assert os.listdir(tmp_path / "build") == []


def test_jpeg_has_no_fallback_when_the_build_fails(fresh_host_libs, monkeypatch):
    monkeypatch.setattr(hostops, "_compiler", lambda: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        load_image(str(FIXTURE))
    assert jpeg._LIB is None
    # the NMS and RLE keep their numpy twins
    assert hostops.backend() == "numpy" and rle.backend() == "numpy"


STUB_C = "int answer(void) { return 42; }\n"

# stands in for nvcc: counts its runs, then compiles the source (the last
# argument) with gcc into the -o path, ignoring the nvcc flags
STUB_NVCC = """#!{python}
import subprocess, sys, time
args = sys.argv[1:]
with open({count!r}, "a") as f:
    f.write("run\\n")
time.sleep(0.2)  # keep the build open while the other threads arrive
if {fail!r}:
    print("stub nvcc: error in source")
    sys.exit(1)
out = args[args.index("-o") + 1]
subprocess.run(["gcc", "-shared", "-fPIC", "-o", out, args[-1]], check=True)
print("ptxas info: stub")
"""


def stub_compiler(tmp_path: Path, fail: bool = False) -> Path:
    count = tmp_path / "runs.txt"
    script = tmp_path / "stub_nvcc.py"
    script.write_text(STUB_NVCC.format(python=sys.executable, count=str(count), fail=fail))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    (tmp_path / "stub.c").write_text(STUB_C)
    return script


@pytest.mark.parametrize("threads", [2, 8])
def test_cuda_library_first_use_from_threads_builds_once(tmp_path, monkeypatch, threads):
    script = stub_compiler(tmp_path)
    build = tmp_path / "build"
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(script))
    library = cuda_build.CudaLibrary(str(tmp_path / "stub.c"))
    results, errors = run_at_once(threads, lambda i: library.lib().answer())
    assert errors == [] and results == [42] * threads
    assert (tmp_path / "runs.txt").read_text().count("run") == 1
    out = library.library_path()
    assert sorted(os.listdir(build)) == sorted([out.name, out.with_suffix(".ptxas.txt").name])
    assert "ptxas info: stub" in library.ptxas_log
    assert library.build_seconds is not None


def test_cuda_library_failed_build_raises_and_leaves_nothing(tmp_path, monkeypatch):
    script = stub_compiler(tmp_path, fail=True)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(script))
    library = cuda_build.CudaLibrary(str(tmp_path / "stub.c"))
    with pytest.raises(RuntimeError, match="stub nvcc: error in source"):
        library.lib()
    assert os.listdir(tmp_path / "build") == []
