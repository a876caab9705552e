"""Build the hand-written CUDA kernels under ``csrc/`` and bind them with ctypes.

Each kernel source exposes a plain C interface, so ``nvcc`` compiles it into
its own shared library in seconds (no PyTorch headers).  The library is built
at first use into ``csrc/build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, so an edited source never loads a stale build.
Nothing is built when a module is imported: the CPU tests import every module
on machines without ``nvcc``.

A :class:`CudaLibrary` is one source; a :class:`CudaKernel` is one C launcher
it exports, with its own launch count.  One library may export several
launchers (``roi_align.cu``: forward and backward), and builds once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def lib(self) -> ctypes.CDLL:
        """The loaded library, running ``nvcc`` first unless it is built."""
        if self._lib is None:
            out = self.library_path()
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                t0 = time.monotonic()
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {self.source.name}:\n{proc.stdout}")
                os.replace(tmp, out)
                self.build_seconds = time.monotonic() - t0
                self.ptxas_log = proc.stdout
            self._lib = ctypes.CDLL(str(out))
        return self._lib


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


def kernel_input(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> torch.Tensor:
    """``t`` as the kernels take it: a contiguous, 16-byte aligned CUDA
    tensor of ``dtype``; raises for a tensor on another device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    t = t.to(dtype).contiguous()
    return t.clone() if t.data_ptr() % 16 else t
