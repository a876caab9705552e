"""RLE mask API: ctypes binding of ``rlelib.c`` with a numpy fallback (port
of ``mx_rcnn_tpu/native/rle.py``, the C source copied beside it).

The library is built at first use with ``native/hostops.py::build_library``
into the git-ignored ``native/build/``; without a compiler every function
runs its numpy twin, and :func:`backend` says which one loaded.

Format: column-major alternating run lengths starting with a zero-run, the
uncompressed COCO convention, as ``{"size": [h, w], "counts": [..]}``
dicts.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "rlelib.c"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def _build_and_load() -> Optional[ctypes.CDLL]:
    from mx_rcnn_tpu_torch.native.hostops import build_library

    try:
        lib = build_library(_SRC)
    except Exception as e:  # noqa: BLE001 — no compiler or load failure: numpy twins
        logger.warning("RLE: C library unavailable (%s); using the numpy fallback", e)
        return None
    u32p = np.ctypeslib.ndpointer(np.uint32)
    i32p = np.ctypeslib.ndpointer(np.int32)
    u8p = np.ctypeslib.ndpointer(np.uint8)
    f64p = np.ctypeslib.ndpointer(np.float64)
    lib.rle_encode.restype = ctypes.c_int
    lib.rle_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u32p]
    lib.rle_decode.restype = None
    lib.rle_decode.argtypes = [u32p, ctypes.c_int, u8p]
    lib.rle_area.restype = ctypes.c_double
    lib.rle_area.argtypes = [u32p, ctypes.c_int]
    lib.rle_iou.restype = None
    lib.rle_iou.argtypes = [u32p, i32p, ctypes.c_int, u32p, i32p,
                            ctypes.c_int, u8p, ctypes.c_int, f64p]
    lib.rle_merge.restype = ctypes.c_int
    lib.rle_merge.argtypes = [u32p, i32p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_long, u32p]
    lib.poly_fill.restype = None
    lib.poly_fill.argtypes = [f64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              u8p]
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


# ------------------------------------------------------------------ public
def counts_from_string(s: str) -> List[int]:
    """Decode the COCO compressed-RLE counts string (LEB128-style 6-bit
    chunks, deltas from counts[m-2]) into plain run lengths — real COCO
    jsons store crowd masks this way."""
    cnts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def ensure_list_counts(r: Dict) -> Dict:
    """Normalize an RLE dict to plain list-of-int counts (decoding the
    compressed string form if needed)."""
    if isinstance(r.get("counts"), (bytes, str)):
        s = r["counts"]
        if isinstance(s, bytes):
            s = s.decode("ascii")
        return {"size": list(r["size"]), "counts": counts_from_string(s)}
    return r


def encode(mask: np.ndarray) -> Dict:
    """(h, w) binary mask → RLE dict."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")
    flat = np.ascontiguousarray(flat)
    lib = _lib()
    if lib is not None:
        cnts = np.empty(h * w + 1, np.uint32)
        k = lib.rle_encode(flat, h, w, cnts)
        counts = cnts[:k].tolist()
    else:
        change = np.flatnonzero(np.diff(flat)) + 1
        runs = np.diff(np.concatenate([[0], change, [flat.size]]))
        counts = runs.tolist()
        if flat[0]:  # counts must start with a (possibly empty) zero-run
            counts = [0] + counts
    return {"size": [h, w], "counts": [int(c) for c in counts]}


def decode(rle: Dict) -> np.ndarray:
    """RLE dict → (h, w) uint8 mask."""
    h, w = rle["size"]
    cnts = np.asarray(rle["counts"], np.uint32)
    lib = _lib()
    if lib is not None:
        out = np.empty(h * w, np.uint8)
        lib.rle_decode(np.ascontiguousarray(cnts), len(cnts), out)
    else:
        vals = np.arange(len(cnts)) % 2
        out = np.repeat(vals.astype(np.uint8), cnts)
    return out.reshape((h, w), order="F")


def area(rle: Dict) -> float:
    cnts = np.asarray(rle["counts"], np.uint32)
    lib = _lib()
    if lib is not None:
        return float(lib.rle_area(np.ascontiguousarray(cnts), len(cnts)))
    return float(cnts[1::2].sum())


def _pack(rles: Sequence[Dict]):
    ks = np.asarray([len(r["counts"]) for r in rles], np.int32)
    max_k = int(ks.max()) if len(ks) else 1
    buf = np.zeros((len(rles), max_k), np.uint32)
    for i, r in enumerate(rles):
        buf[i, : ks[i]] = r["counts"]
    return np.ascontiguousarray(buf), ks, max_k


def iou(dt: Sequence[Dict], gt: Sequence[Dict], iscrowd: Sequence[int]) -> np.ndarray:
    """(n_dt, n_gt) mask IoU; crowd gt → intersection / dt area."""
    if not dt or not gt:
        return np.zeros((len(dt), len(gt)))
    lib = _lib()
    crowd = np.asarray(iscrowd, np.uint8)
    if lib is not None:
        dbuf, dk, mk1 = _pack(dt)
        gbuf, gk, mk2 = _pack(gt)
        mk = max(mk1, mk2)
        if mk1 < mk:
            dbuf = np.pad(dbuf, ((0, 0), (0, mk - mk1)))
        if mk2 < mk:
            gbuf = np.pad(gbuf, ((0, 0), (0, mk - mk2)))
        out = np.zeros((len(dt), len(gt)), np.float64)
        lib.rle_iou(np.ascontiguousarray(dbuf), dk, len(dt),
                    np.ascontiguousarray(gbuf), gk, len(gt),
                    crowd, mk, out)
        return out
    # numpy fallback: decode and compare
    dm = np.stack([decode(r).reshape(-1) for r in dt]).astype(np.float64)
    gm = np.stack([decode(r).reshape(-1) for r in gt]).astype(np.float64)
    inter = dm @ gm.T
    da = dm.sum(1)[:, None]
    ga = gm.sum(1)[None, :]
    union = np.where(crowd[None, :], da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def merge(rles: Sequence[Dict]) -> Dict:
    """Union-merge RLEs of one image."""
    assert rles, "merge of zero masks"
    h, w = rles[0]["size"]
    lib = _lib()
    if lib is not None:
        buf, ks, mk = _pack(rles)
        out = np.empty(h * w + 1, np.uint32)
        k = lib.rle_merge(buf, ks, len(rles), mk, h * w, out)
        assert k > 0, "rle_merge allocation failure"
        return {"size": [h, w], "counts": out[:k].tolist()}
    m = np.zeros((h, w), np.uint8)
    for r in rles:
        m |= decode(r)
    return encode(m)


def from_polygons(polys: Sequence[Sequence[float]], h: int, w: int) -> Dict:
    """COCO polygon list ([[x1, y1, x2, y2, ...], ...]) → merged RLE."""
    m = np.zeros(h * w, np.uint8)
    lib = _lib()
    for poly in polys:
        xy = np.ascontiguousarray(np.asarray(poly, np.float64))
        if lib is not None:
            lib.poly_fill(xy, len(xy) // 2, h, w, m)
        else:
            m |= _poly_fill_np(xy.reshape(-1, 2), h, w).reshape(-1, order="F")
    return encode(m.reshape((h, w), order="F"))


def _poly_fill_np(pts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Even-odd scanline fill on pixel centers (numpy fallback)."""
    m = np.zeros((h, w), np.uint8)
    n = len(pts)
    for col in range(w):
        px = col + 0.5
        ys = []
        for i in range(n):
            x0, y0 = pts[i]
            x1, y1 = pts[(i + 1) % n]
            if (x0 <= px < x1) or (x1 <= px < x0):
                t = (px - x0) / (x1 - x0)
                ys.append(y0 + t * (y1 - y0))
        ys.sort()
        for a, b in zip(ys[0::2], ys[1::2]):
            r0 = max(int(np.ceil(a - 0.5)), 0)
            r1 = min(int(np.floor(b - 0.5)), h - 1)
            if r1 >= r0:  # crossings fully off-image must fill nothing
                m[r0 : r1 + 1, col] = 1
    return m
