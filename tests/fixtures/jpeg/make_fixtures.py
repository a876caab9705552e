"""Write the JPEG fixtures of this directory and their ``manifest.json``
with OpenCV's encoder (the reference decoder's own library):

    python tests/fixtures/jpeg/make_fixtures.py

Each image is a seeded scene (a shaded background, a few filled boxes and
discs, mild noise), so the files hold smooth areas, edges and texture.
The manifest records each file's decoded shape, chroma sampling, mode,
restart interval, quality and EXIF orientation, and the SHA-256 of the
RGB uint8 array that ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns
(converted BGR → RGB).  ``tests/test_torch_jpeg.py`` recomputes those
hashes with cv2, and ``chip_smoke.py`` holds the port's decoder to them.
"""

import hashlib
import json
import struct
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent

# name, (height, width), sampling factor, progressive, restart interval, quality, gray, orientation
FIXTURES = (
    ("voc_420_baseline.jpg", (375, 500), 0x221111, False, 0, 90, False, 0),
    ("coco_422_progressive.jpg", (480, 640), 0x211111, True, 0, 85, False, 0),
    ("coco_444_restart.jpg", (240, 320), 0x111111, False, 4, 92, False, 0),
    ("odd_411.jpg", (161, 243), 0x411111, False, 0, 75, False, 0),
    ("gray.jpg", (201, 150), 0x111111, False, 0, 88, True, 0),
    ("exif_rotated_6.jpg", (180, 260), 0x221111, False, 0, 87, False, 6),
)
SAMPLING = {0x221111: "4:2:0", 0x211111: "4:2:2", 0x111111: "4:4:4", 0x411111: "4:1:1"}


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded BGR uint8 scene."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    c0, c1 = rng.uniform(40, 215, (2, 3))
    t = (x / w + y / h)[..., None] / 2
    im = (c0 * (1 - t) + c1 * t).astype(np.float32)
    for _ in range(6):
        x0, y0 = int(rng.integers(0, w - 10)), int(rng.integers(0, h - 10))
        x1, y1 = int(rng.integers(x0 + 8, w)), int(rng.integers(y0 + 8, h))
        color = tuple(float(v) for v in rng.uniform(0, 255, 3))
        if rng.random() < 0.5:
            cv2.rectangle(im, (x0, y0), (x1, y1), color, -1)
        else:
            cv2.circle(im, ((x0 + x1) // 2, (y0 + y1) // 2), max((x1 - x0) // 3, 4), color, -1)
    im += rng.normal(0, 6, im.shape).astype(np.float32)
    return np.clip(im, 0, 255).astype(np.uint8)


def exif_app1(orientation: int) -> bytes:
    """An APP1 segment whose little-endian TIFF IFD0 holds only the
    orientation tag."""
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIH2x", 0x0112, 3, 1, orientation) + struct.pack("<I", 0))
    payload = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def main() -> None:
    entries = []
    for seed, (name, (h, w), samp, prog, rst, q, gray, orient) in enumerate(FIXTURES):
        im = scene(h, w, seed)
        if gray:
            im = cv2.cvtColor(im, cv2.COLOR_BGR2GRAY)
        params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp,
                  cv2.IMWRITE_JPEG_PROGRESSIVE, int(prog)]
        if rst:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
        data = cv2.imencode(".jpg", im, params)[1].tobytes()
        if orient:
            data = data[:2] + exif_app1(orient) + data[2:]
        path = HERE / name
        path.write_bytes(data)
        rgb = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        entries.append({
            "name": name, "shape": list(rgb.shape),
            "sampling": "gray" if gray else SAMPLING[samp],
            "mode": "progressive" if prog else "baseline", "restart_interval": rst,
            "quality": q, "orientation": orient or 1, "bytes": len(data),
            "sha256": hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest(),
        })
    (HERE / "manifest.json").write_text(json.dumps({"files": entries}, indent=1) + "\n")


if __name__ == "__main__":
    main()
