"""Detection overlays and a PNG writer (port of
``mx_rcnn_tpu/utils/visualize.py``), with no OpenCV dependency.

:func:`class_color` is the JAX package's seeded draw (a BGR triple, applied
to the RGB image as JAX applies it).  :func:`draw_detections` draws each
box as ``cv2.rectangle(im, p1, p2, color, 2)`` does, pixel for pixel: the
union of 3-pixel bands centred on the four edges.  The label, whose Hershey
glyphs exist only inside OpenCV, is drawn with a small built-in bitmap font
in the class colour, inside the box ``cv2.getTextSize(label,
FONT_HERSHEY_SIMPLEX, 0.5, 1)`` gives at ``(x1, max(y1 - 4, 10))``: the
glyphs fill rows ``y - 9 .. y - 1`` and advance less than Hershey's.
:func:`save_image` writes an 8-bit RGB PNG with ``zlib`` and ``struct``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

# 5-column glyphs: 7 rows down to the baseline, 2 descender rows ('#' ink);
# each glyph advances by its inked width + 1 (a space by 3)
_GLYPH_ROWS = {
    "0": ".###. #...# #..## #.#.# ##..# #...# .###.",
    "1": "..#.. .##.. ..#.. ..#.. ..#.. ..#.. .###.",
    "2": ".###. #...# ....# ...#. ..#.. .#... #####",
    "3": "####. ....# ....# .###. ....# ....# ####.",
    "4": "...#. ..##. .#.#. #..#. ##### ...#. ...#.",
    "5": "##### #.... ####. ....# ....# #...# .###.",
    "6": "..##. .#... #.... ####. #...# #...# .###.",
    "7": "##### ....# ...#. ..#.. .#... .#... .#...",
    "8": ".###. #...# #...# .###. #...# #...# .###.",
    "9": ".###. #...# #...# .#### ....# ...#. .##..",
    "A": ".###. #...# #...# ##### #...# #...# #...#",
    "B": "####. #...# #...# ####. #...# #...# ####.",
    "C": ".###. #...# #.... #.... #.... #...# .###.",
    "D": "###.. #..#. #...# #...# #...# #..#. ###..",
    "E": "##### #.... #.... ####. #.... #.... #####",
    "F": "##### #.... #.... ####. #.... #.... #....",
    "G": ".###. #...# #.... #.### #...# #...# .####",
    "H": "#...# #...# #...# ##### #...# #...# #...#",
    "I": ".###. ..#.. ..#.. ..#.. ..#.. ..#.. .###.",
    "J": "..### ...#. ...#. ...#. ...#. #..#. .##..",
    "K": "#...# #..#. #.#.. ##... #.#.. #..#. #...#",
    "L": "#.... #.... #.... #.... #.... #.... #####",
    "M": "#...# ##.## #.#.# #.#.# #...# #...# #...#",
    "N": "#...# #...# ##..# #.#.# #..## #...# #...#",
    "O": ".###. #...# #...# #...# #...# #...# .###.",
    "P": "####. #...# #...# ####. #.... #.... #....",
    "Q": ".###. #...# #...# #...# #.#.# #..#. .##.#",
    "R": "####. #...# #...# ####. #.#.. #..#. #...#",
    "S": ".#### #.... #.... .###. ....# ....# ####.",
    "T": "##### ..#.. ..#.. ..#.. ..#.. ..#.. ..#..",
    "U": "#...# #...# #...# #...# #...# #...# .###.",
    "V": "#...# #...# #...# #...# #...# .#.#. ..#..",
    "W": "#...# #...# #...# #.#.# #.#.# #.#.# .#.#.",
    "X": "#...# #...# .#.#. ..#.. .#.#. #...# #...#",
    "Y": "#...# #...# .#.#. ..#.. ..#.. ..#.. ..#..",
    "Z": "##### ....# ...#. ..#.. .#... #.... #####",
    "a": "..... ..... .###. ....# .#### #...# .####",
    "b": "#.... #.... #.##. ##..# #...# #...# ####.",
    "c": "..... ..... .###. #.... #.... #...# .###.",
    "d": "....# ....# .##.# #..## #...# #...# .####",
    "e": "..... ..... .###. #...# ##### #.... .###.",
    "f": "..##. .#..# .#... ###.. .#... .#... .#...",
    "g": "..... ..... .#### #...# #...# #...# .#### ....# .###.",
    "h": "#.... #.... #.##. ##..# #...# #...# #...#",
    "i": "..#.. ..... .##.. ..#.. ..#.. ..#.. .###.",
    "j": "...#. ..... ..##. ...#. ...#. ...#. ...#. #..#. .##..",
    "k": "#.... #.... #..#. #.#.. ##... #.#.. #..#.",
    "l": ".##.. ..#.. ..#.. ..#.. ..#.. ..#.. .###.",
    "m": "..... ..... ##.#. #.#.# #.#.# #.#.# #.#.#",
    "n": "..... ..... #.##. ##..# #...# #...# #...#",
    "o": "..... ..... .###. #...# #...# #...# .###.",
    "p": "..... ..... ####. #...# #...# #...# ####. #.... #....",
    "q": "..... ..... .#### #...# #...# #...# .#### ....# ....#",
    "r": "..... ..... #.##. ##..# #.... #.... #....",
    "s": "..... ..... .###. #.... .###. ....# ####.",
    "t": ".#... .#... ###.. .#... .#... .#..# ..##.",
    "u": "..... ..... #...# #...# #...# #..## .##.#",
    "v": "..... ..... #...# #...# #...# .#.#. ..#..",
    "w": "..... ..... #...# #...# #.#.# #.#.# .#.#.",
    "x": "..... ..... #...# .#.#. ..#.. .#.#. #...#",
    "y": "..... ..... #...# #...# #...# #...# .#### ....# .###.",
    "z": "..... ..... ##### ...#. ..#.. .#... #####",
    ".": "..... ..... ..... ..... ..... .##.. .##..",
    ",": "..... ..... ..... ..... ..... .##.. .##.. ..#.. .#...",
    "-": "..... ..... ..... .###. ..... ..... .....",
    "_": "..... ..... ..... ..... ..... ..... #####",
    ":": "..... .##.. .##.. ..... .##.. .##.. .....",
    ";": "..... .##.. .##.. ..... .##.. .##.. ..#.. .#...",
    "!": "..#.. ..#.. ..#.. ..#.. ..#.. ..... ..#..",
    "?": ".###. #...# ....# ...#. ..#.. ..... ..#..",
    "(": "...#. ..#.. .#... .#... .#... ..#.. ...#.",
    ")": ".#... ..#.. ...#. ...#. ...#. ..#.. .#...",
    "[": ".###. .#... .#... .#... .#... .#... .###.",
    "]": ".###. ...#. ...#. ...#. ...#. ...#. .###.",
    "{": "...#. ..#.. ..#.. .#... ..#.. ..#.. ...#.",
    "}": ".#... ..#.. ..#.. ...#. ..#.. ..#.. .#...",
    "/": "....# ....# ...#. ..#.. .#... #.... #....",
    "\\": "#.... #.... .#... ..#.. ...#. ....# ....#",
    "|": "..#.. ..#.. ..#.. ..#.. ..#.. ..#.. ..#..",
    "%": "##..# ##..# ...#. ..#.. .#... #..## #..##",
    "+": "..... ..#.. ..#.. ##### ..#.. ..#.. .....",
    "=": "..... ..... ##### ..... ##### ..... .....",
    "#": ".#.#. .#.#. ##### .#.#. ##### .#.#. .#.#.",
    "*": "..... ..#.. #.#.# .###. #.#.# ..#.. .....",
    "&": ".##.. #..#. #.#.. .#... #.#.# #..#. .##.#",
    "'": "..#.. ..#.. .#... ..... ..... ..... .....",
    '"': ".#.#. .#.#. ..... ..... ..... ..... .....",
    "`": ".#... ..#.. ..... ..... ..... ..... .....",
    "<": "...#. ..#.. .#... #.... .#... ..#.. ...#.",
    ">": ".#... ..#.. ...#. ....# ...#. ..#.. .#...",
    "@": ".###. #...# #.### #.#.# #.### #.... .###.",
    "^": "..#.. .#.#. #...# ..... ..... ..... .....",
    "~": "..... ..... .#... #.#.# ...#. ..... .....",
    "$": "..#.. .#### #.#.. .###. ..#.# ####. ..#..",
}
# a character the font lacks is drawn as a hollow box
_MISSING = "..... ##### #...# #...# #...# #...# #####"
_GLYPH_H = 9


def _glyph(rows: str) -> np.ndarray:
    """The glyph's (9, width) ink mask, its empty columns trimmed."""
    g = np.zeros((_GLYPH_H, 5), bool)
    for r, row in enumerate(rows.split()):
        g[r] = [c == "#" for c in row]
    cols = np.flatnonzero(g.any(0))
    return g[:, cols[0]: cols[-1] + 1]


_GLYPHS = {c: _glyph(rows) for c, rows in _GLYPH_ROWS.items()}
_GLYPHS[" "] = np.zeros((_GLYPH_H, 2), bool)
_GLYPH_MISSING = _glyph(_MISSING)


def class_color(cls_idx: int) -> Tuple[int, int, int]:
    """Deterministic bright BGR color for a class id (the JAX package's
    draw)."""
    rng = np.random.RandomState(cls_idx * 9973 + 17)
    c = rng.randint(64, 256, size=3)
    return int(c[0]), int(c[1]), int(c[2])


def _fill(im: np.ndarray, x0: int, x1: int, y0: int, y1: int, color) -> None:
    """Set pixels x0..x1, y0..y1 (inclusive), clipped to the image."""
    h, w = im.shape[:2]
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w - 1), min(y1, h - 1)
    if x0 <= x1 and y0 <= y1:
        im[y0: y1 + 1, x0: x1 + 1] = color


def draw_rectangle(im: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color) -> None:
    """``cv2.rectangle(im, p1, p2, color, 2)`` (LINE_8), in place: each
    edge a band 3 pixels wide centred on it, spanning the edge's extent
    (the end caps' discs lie inside the neighbouring bands)."""
    (x1, y1), (x2, y2) = p1, p2
    xa, xb, ya, yb = min(x1, x2), max(x1, x2), min(y1, y2), max(y1, y2)
    for y in (y1, y2):
        _fill(im, xa, xb, y - 1, y + 1, color)
    for x in (x1, x2):
        _fill(im, x - 1, x + 1, ya, yb, color)


def draw_text(im: np.ndarray, text: str, org: Tuple[int, int], color) -> None:
    """``text`` in the bitmap font, in place: from column ``org[0] + 1``,
    rows ``org[1] - 9 .. org[1] - 1``, clipped to the image."""
    h, w = im.shape[:2]
    x = org[0] + 1
    top = org[1] - _GLYPH_H
    for ch in text:
        g = _GLYPHS.get(ch, _GLYPH_MISSING)
        gh, gw = g.shape
        ys, xs = np.nonzero(g)
        ys, xs = ys + top, xs + x
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        im[ys[keep], xs[keep]] = color
        x += gw + 1


def draw_detections(
    im_rgb: np.ndarray,
    dets_by_class: Dict[str, np.ndarray],
    thresh: float = 0.7,
) -> np.ndarray:
    """Render detections onto an RGB uint8 copy of ``im_rgb``:
    ``dets_by_class[name]`` = (n, 5) [x1, y1, x2, y2, score] arrays in the
    image's frame; each box scoring ``thresh`` or more gets its rectangle
    and its ``"{name} {score:.3f}"`` label in its class's colour."""
    im = np.ascontiguousarray(im_rgb.astype(np.uint8))
    for k, (name, dets) in enumerate(sorted(dets_by_class.items())):
        color = class_color(k + 1)
        for det in np.asarray(dets):
            score = float(det[4])
            if score < thresh:
                continue
            x1, y1, x2, y2 = (int(round(v)) for v in det[:4])
            draw_rectangle(im, (x1, y1), (x2, y2), color)
            draw_text(im, f"{name} {score:.3f}", (x1, max(y1 - 4, 10)), color)
    return im


def save_image(path: str, im_rgb: np.ndarray) -> None:
    """Write an (H, W, 3) RGB image (values cast to uint8) as a PNG file:
    8-bit RGB, one IHDR, IDAT and IEND chunk, filter 0 on every row."""
    im = np.ascontiguousarray(np.asarray(im_rgb).astype(np.uint8))
    if im.ndim != 3 or im.shape[2] != 3:
        raise ValueError(f"save_image takes (H, W, 3) RGB, got shape {im.shape}")
    h, w = im.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = im.reshape(h, 3 * w)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))
