"""Build the hand-written CUDA kernels under ``csrc/`` and bind them with ctypes.

Each kernel source exposes a plain C interface, so ``nvcc`` compiles it into
its own shared library in seconds (no PyTorch headers).  The library is built
at first use into ``csrc/build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, so an edited source never loads a stale build.
Nothing is built when a module is imported: the CPU tests import every module
on machines without ``nvcc``.

A :class:`CudaLibrary` is one source; a :class:`CudaKernel` is one C launcher
it exports, with its own launch count.  One library may export several
launchers (``roi_align.cu``: forward and backward), and builds once: a lock
per library covers the check, the build and the load, so threads that first
call it at once share one build.  ``nvcc`` writes a temporary file of its
own (``mkstemp``) that is renamed into place, so concurrent processes never
load a half-written library.  A source may include the shared headers
``csrc/*.cuh``; they are hashed into every library's name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction: the NMS IoU must round exactly like the plain
    # version (and the JAX reference) so borderline keep decisions agree
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel, kept in ptxas_log
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


class CudaLibrary:
    """One ``csrc/<source>`` compiled into a shared library at first use."""

    def __init__(self, source: str):
        self.source = CSRC / source
        self.build_seconds: Optional[float] = None
        self.ptxas_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        # the shared headers (``*.cuh``) are part of every source's build
        headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def lib(self) -> ctypes.CDLL:
        """The loaded library, running ``nvcc`` first unless it is built.
        ptxas' log is kept beside the library, so a build made earlier
        still reports its registers and spills."""
        with self._lock:
            if self._lib is None:
                out = self.library_path()
                log = out.with_suffix(".ptxas.txt")
                if not out.exists():
                    self._build(out, log)
                self.ptxas_log = log.read_text() if log.exists() else ""
                self._lib = ctypes.CDLL(str(out))
            return self._lib

    def _build(self, out: Path, log: Path) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            t0 = time.monotonic()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.source.name}:\n{proc.stdout}")
            log.write_text(proc.stdout)
            os.replace(tmp, out)
            self.build_seconds = time.monotonic() - t0
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


class CudaKernel:
    """One C launcher ``function`` exported by ``library``.

    The launcher takes ``argtypes`` and returns the ``cudaError_t`` of its
    launches as an int.  ``launches`` counts wrapper calls that launched the
    kernel (the wrapper increments it); a run resets it to show that a path
    went through it.
    """

    def __init__(self, library: CudaLibrary, function: str, argtypes: Sequence):
        self.library = library
        self.function = function
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        """Launch, and raise if the launch was refused."""
        if self._fn is None:
            fn = getattr(self.library.lib(), self.function)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.library.source.name}:{self.function} failed with cudaError {rc}")


def build_all(libraries: Sequence[CudaLibrary]) -> None:
    """Build every library at once: one ``nvcc`` per source, all started
    together (each waits in its own thread)."""
    with ThreadPoolExecutor(max_workers=max(len(libraries), 1)) as pool:
        list(pool.map(CudaLibrary.lib, libraries))


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def kernel_input(name: str, t: torch.Tensor, dtypes, ndim: int) -> torch.Tensor:
    """``t`` as the kernels take it: a contiguous, 16-byte aligned CUDA
    tensor of one of ``dtypes`` (a dtype or a tuple: those the kernel was
    built for).  No dtype is converted: a tensor of another dtype (checked
    first), or on another device, raises."""
    dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}: the kernel is built for {dtypes}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t
