"""JPEG decoding: ctypes binding of ``jpegdec.c``, the port's own baseline
and progressive Huffman decoder, pixel-identical to ``cv2.imread(path,
cv2.IMREAD_COLOR)`` (libjpeg-turbo's default decompression) in RGB order.

The library is built at first use with ``native/hostops.py::build_library``
into the git-ignored ``native/build/``.  There is no numpy twin: a failed
build or load raises with the compiler's error.  The decode runs in a
``ctypes.CDLL`` call, which releases the GIL, so loader threads decode in
parallel.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "jpegdec.c"
_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_ERR_LEN = 512


class JPEGError(ValueError):
    """A JPEG the decoder does not read: corrupt, truncated, or a feature
    left out (the message names it)."""


def _build_and_load() -> ctypes.CDLL:
    from mx_rcnn_tpu_torch.native.hostops import build_library

    lib = build_library(_SRC)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.jpeg_info.restype = ctypes.c_int
    lib.jpeg_info.argtypes = [u8p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
                              ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.c_size_t,
                                ctypes.c_char_p, ctypes.c_int]
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = _build_and_load()
    return _LIB


def is_jpeg(data: bytes) -> bool:
    """The file starts with the SOI marker ``FF D8``."""
    return data[:2] == b"\xff\xd8"


def _bytes(data: bytes):
    buf = np.frombuffer(data, np.uint8)
    return buf, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def jpeg_info(data: bytes, name: str = "<bytes>") -> Tuple[int, int, int, int]:
    """(height, width, source components, EXIF orientation) of the decoded
    image: the EXIF orientation already applied to height and width."""
    buf, p = _bytes(data)
    info = (ctypes.c_int * 4)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _lib().jpeg_info(p, buf.size, info, err, _ERR_LEN) != 0:
        raise JPEGError(f"{name}: {err.value.decode()}")
    return info[1], info[0], info[2], info[3]


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The JPEG ``data`` as an (H, W, 3) RGB uint8 array, EXIF orientation
    applied; raises :class:`JPEGError` naming ``name`` and the case (no
    partial image is returned)."""
    h, w, _, _ = jpeg_info(data, name)
    buf, p = _bytes(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = _lib().jpeg_decode(p, buf.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            out.nbytes, err, _ERR_LEN)
    if rc != 0:
        raise JPEGError(f"{name}: {err.value.decode()}")
    return out
