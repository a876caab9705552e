"""Host greedy NMS: ctypes binding of ``hostops.c`` with a numpy twin (port
of ``nms_host`` in ``mx_rcnn_tpu/native/hostops.py`` and its build helper).

The library is built at first use with the host C compiler (``$CC``, else
``cc``, else ``gcc``) into ``native/build/`` (git-ignored), named by a hash
of the source and the flags.  Each build writes a temporary file of its own
(``mkstemp``) and renames it into place, so concurrent processes never load
a half-written file; within a process a lock per library covers the check,
the build and the load, and the first call's lock makes threads that call
at once share one load.  Without a compiler :func:`nms_host` runs
``ops/nms.py::nms_numpy``, which keeps the same indices in the same order;
:func:`backend` says which one loaded, and the first call logs it.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "hostops.c"
BUILD_DIR = _SRC.parent / "build"
# no FMA contraction: floating-point results round as numpy's do (the NMS's
# IoU: borderline keeps agree with nms_numpy)
CFLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()
# one lock per built library (keyed by its output path), made under _BUILD_LOCKS_LOCK
_BUILD_LOCKS: Dict[Path, threading.Lock] = {}
_BUILD_LOCKS_LOCK = threading.Lock()


def _compiler() -> Optional[str]:
    for cc in (os.environ.get("CC"), "cc", "gcc"):
        if cc and shutil.which(cc):
            return cc
    return None


def _build_lock(path: Path) -> threading.Lock:
    with _BUILD_LOCKS_LOCK:
        return _BUILD_LOCKS.setdefault(path, threading.Lock())


def build_library(src: Path) -> ctypes.CDLL:
    """Compile the C source ``src`` (unless built) into ``BUILD_DIR`` and
    load it; raises when there is no compiler or the build or load fails
    (with the compiler's error).  ``native/rle.py`` and ``native/jpeg.py``
    build their sources with it too."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"{src.stem}-{digest}.so"
    with _build_lock(so_path):
        if not so_path.exists():
            cc = _compiler()
            if cc is None:
                raise RuntimeError("no C compiler found ($CC, cc, gcc)")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([cc, *CFLAGS, str(src), "-o", tmp], capture_output=True,
                                      text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"{cc} failed for {src.name}:\n{proc.stderr}")
                os.replace(tmp, so_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return ctypes.CDLL(str(so_path))


def _build_and_load() -> Optional[ctypes.CDLL]:
    """Compile (unless built) and load the library; None on any failure."""
    try:
        lib = build_library(_SRC)
    except Exception as e:  # noqa: BLE001 — no compiler or load failure: numpy twin
        logger.warning("host NMS: C library unavailable (%s); using ops/nms.py::nms_numpy", e)
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.cpu_nms.restype = ctypes.c_int
    lib.cpu_nms.argtypes = [f32p, ctypes.c_int, ctypes.c_float, i32p]
    logger.info("host NMS: C library %s", Path(lib._name).name)
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        with _LOCK:
            if not _TRIED:
                _LIB = _build_and_load()
                _TRIED = True
    return _LIB


def backend() -> str:
    """``"c"`` when the C library loaded, else ``"numpy"`` (builds on first
    call)."""
    return "c" if _lib() is not None else "numpy"


def nms_host(dets: np.ndarray, thresh: float) -> List[int]:
    """Greedy NMS on (N, 5) [x1, y1, x2, y2, score] → kept indices in
    score-descending order (equal scores: the later index first), the same
    list as ``ops/nms.py::nms_numpy``."""
    n = int(dets.shape[0])
    if n == 0:
        return []
    lib = _lib()
    if lib is not None:
        dets32 = np.ascontiguousarray(dets[:, :5], dtype=np.float32)
        keep = np.empty(n, np.int32)
        n_keep = lib.cpu_nms(dets32, n, float(thresh), keep)
        if n_keep >= 0:
            return keep[:n_keep].tolist()
        # -1: an allocation failed inside the C path
    from mx_rcnn_tpu_torch.ops.nms import nms_numpy

    return nms_numpy(dets, thresh)
