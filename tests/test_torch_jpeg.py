"""The port's JPEG decoder (``native/jpegdec.c`` through
``data/image.py::load_image``) against ``cv2.imread(path, IMREAD_COLOR)``
→ RGB, the JAX package's reader: pixel-identical (max absolute difference
0) on files the installed ``cv2.imwrite`` writes across chroma samplings,
baseline and progressive modes, restart intervals, qualities, odd sizes,
grayscale and EXIF orientations, and on the committed fixtures, whose
manifest hashes are recomputed here with cv2.  Every input the decoder does
not read raises an error that names the case."""

import hashlib
import io
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from mx_rcnn_tpu.data.image import load_image as jax_load_image
from mx_rcnn_tpu_torch.data.image import load_image
from mx_rcnn_tpu_torch.native.jpeg import JPEGError, decode_jpeg, jpeg_info

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["files"]

SAMPLINGS = {"420": 0x221111, "422": 0x211111, "444": 0x111111, "411": 0x411111,
             "440": 0x121111}
# odd sizes: the chroma planes' last row and column are partial, and the
# triangle filters meet the image edges (widths 1 and 2 skip them)
SIZES = ((1, 1), (17, 9), (9, 17), (2, 5), (35, 47))


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """Seeded BGR pixels: a gradient under noise, so every DCT band is hit."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 / max(w, 1), y * 255 / max(h, 1), (x + y) * 127 / (h + w)], -1)
    return np.clip(base + rng.normal(0, 35, (h, w, 3)), 0, 255).astype(np.uint8)


def cv2_rgb(path) -> np.ndarray:
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def assert_identical(path) -> None:
    want = cv2_rgb(path)
    got = load_image(str(path))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want.astype(np.float32)).max() == 0


def write(tmp_path, name, im, params) -> Path:
    path = tmp_path / name
    assert cv2.imwrite(str(path), im, params)
    return path


@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("mode", ["baseline", "progressive"])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_decode_equals_cv2(tmp_path, sampling, mode, restart, quality):
    for i, (h, w) in enumerate(SIZES):
        params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling],
                  cv2.IMWRITE_JPEG_PROGRESSIVE, int(mode == "progressive")]
        if restart:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        assert_identical(write(tmp_path, f"{h}x{w}.jpg", scene(h, w, i), params))


@pytest.mark.parametrize("mode", ["baseline", "progressive"])
@pytest.mark.parametrize("size", SIZES)
def test_grayscale_comes_back_as_three_equal_channels(tmp_path, size, mode):
    h, w = size
    gray = cv2.cvtColor(scene(h, w, 7), cv2.COLOR_BGR2GRAY)
    path = write(tmp_path, "g.jpg", gray, [cv2.IMWRITE_JPEG_PROGRESSIVE, int(mode == "progressive")])
    assert jpeg_info(path.read_bytes())[2] == 1
    assert_identical(path)
    im = load_image(str(path))
    assert (im[..., 0] == im[..., 1]).all() and (im[..., 1] == im[..., 2]).all()


def exif_app1(orientation: int, little_endian: bool) -> bytes:
    """An APP1 ``Exif`` segment whose IFD0 holds a make tag and the
    orientation tag."""
    e = "<" if little_endian else ">"
    make = b"Cam\0"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 2)
            + struct.pack(e + "HHI", 0x010F, 2, 4) + make
            + struct.pack(e + "HHIH", 0x0112, 3, 1, orientation) + b"\0\0"
            + struct.pack(e + "I", 0))
    payload = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


@pytest.mark.parametrize("little_endian", [True, False])
@pytest.mark.parametrize("orientation", [1, 2, 3, 4, 5, 6, 7, 8])
def test_exif_orientation_applied_as_cv2_does(tmp_path, orientation, little_endian):
    data = cv2.imencode(".jpg", scene(17, 30, 3), [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
    path = tmp_path / "o.jpg"
    path.write_bytes(data[:2] + exif_app1(orientation, little_endian) + data[2:])
    h, w, _, orient = jpeg_info(path.read_bytes())
    assert orient == orientation
    assert (h, w) == ((30, 17) if orientation >= 5 else (17, 30))
    assert_identical(path)


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["name"] for e in MANIFEST])
def test_fixture_hashes_are_cv2s_and_the_ports(entry):
    """The manifest the card's check reads holds cv2's decode, and the
    port's decode (and JAX's float reader) agree with it."""
    path = FIXTURES / entry["name"]
    want = cv2_rgb(path)
    assert list(want.shape) == entry["shape"]
    assert hashlib.sha256(want.tobytes()).hexdigest() == entry["sha256"]
    got = decode_jpeg(path.read_bytes(), str(path))
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    np.testing.assert_array_equal(load_image(str(path)), jax_load_image(str(path)))


def test_fixtures_cover_the_cases_and_stay_small():
    cases = {(e["sampling"], e["mode"], bool(e["restart_interval"]), e["orientation"] != 1)
             for e in MANIFEST}
    assert ("4:2:0", "baseline", False, False) in cases
    assert ("4:2:2", "progressive", False, False) in cases
    assert ("4:4:4", "baseline", True, False) in cases
    assert any(c[0] == "4:1:1" for c in cases) and any(c[0] == "gray" for c in cases)
    assert any(c[3] for c in cases)
    assert [e["shape"] for e in MANIFEST if e["sampling"] == "4:2:0"][0] == [375, 500, 3]
    assert sum((FIXTURES / e["name"]).stat().st_size for e in MANIFEST) < 400_000


def test_adobe_rgb_and_pil_encodes_equal_cv2(tmp_path):
    """Other encoders' choices: PIL's optimized Huffman tables and its
    progression, and an Adobe-marked RGB (untransformed) file."""
    from PIL import Image

    rgb = scene(41, 57, 5)[..., ::-1]
    for i, kw in enumerate([dict(quality=75, optimize=True), dict(quality=95, progressive=True),
                            dict(quality=60, subsampling=1, optimize=True, progressive=True),
                            dict(quality=80, keep_rgb=True)]):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(rgb)).save(buf, "JPEG", **kw)
        path = tmp_path / f"pil{i}.jpg"
        path.write_bytes(buf.getvalue())
        assert_identical(path)


# ------------------------------------------------------------- refusals
def _baseline_bytes() -> bytes:
    return cv2.imencode(".jpg", scene(40, 48, 11), [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()


def _with_sof(data: bytes, marker: int, precision: int = 8) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[: i + 1] + bytes([marker]) + data[i + 2: i + 4] + bytes([precision]) + data[i + 5:]


def test_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError, match="nowhere.jpg"):
        load_image(str(tmp_path / "nowhere.jpg"))


def test_a_png_is_refused_by_name(tmp_path):
    path = tmp_path / "image.jpg"
    assert cv2.imwrite(str(tmp_path / "image.png"), scene(8, 8, 0))
    path.write_bytes((tmp_path / "image.png").read_bytes())
    with pytest.raises(NotImplementedError, match=r"image\.jpg: PNG file.*item 7"):
        load_image(str(path))


def test_not_an_image_is_refused(tmp_path):
    path = tmp_path / "notes.jpg"
    path.write_bytes(b"just some text")
    with pytest.raises(NotImplementedError, match="unknown format"):
        load_image(str(path))


@pytest.mark.parametrize("keep", [0.3, 0.7, -2])
def test_truncated_file_raises_with_its_name_and_offset(tmp_path, keep):
    """cv2 returns libjpeg's filled-in rest; the port returns no image."""
    data = _baseline_bytes()
    cut = len(data) + keep if keep < 0 else int(len(data) * keep)
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:cut])
    with pytest.raises(JPEGError, match=r"cut\.jpg: truncated or corrupt JPEG.*at byte \d+"):
        load_image(str(path))


def test_arithmetic_coding_raises(tmp_path):
    """Neither cv2 nor PIL writes arithmetic-coded files: a baseline file's
    SOF0 is relabelled SOF9, and the decoder refuses it before any scan."""
    path = tmp_path / "arith.jpg"
    path.write_bytes(_with_sof(_baseline_bytes(), 0xC9))
    with pytest.raises(JPEGError, match="arithmetic-coded JPEG"):
        load_image(str(path))


def test_lossless_raises():
    with pytest.raises(JPEGError, match=r"lossless JPEG \(SOF3\)"):
        decode_jpeg(_with_sof(_baseline_bytes(), 0xC3))


def test_twelve_bit_raises():
    with pytest.raises(JPEGError, match="12-bit JPEG"):
        decode_jpeg(_with_sof(_baseline_bytes(), 0xC1, precision=12))


def test_oversized_header_raises_before_allocating():
    """A SOF claiming 65535 x 65535 pixels (cv2 refuses it too)."""
    data = _baseline_bytes()
    i = data.index(b"\xff\xc0")
    huge = data[: i + 5] + struct.pack(">HH", 65535, 65535) + data[i + 9:]
    assert cv2.imdecode(np.frombuffer(huge, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(JPEGError, match="2\\^30-pixel limit"):
        decode_jpeg(huge)


def test_cmyk_raises(tmp_path):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(scene(16, 16, 2)).convert("CMYK").save(buf, "JPEG")
    path = tmp_path / "cmyk.jpg"
    path.write_bytes(buf.getvalue())
    with pytest.raises(JPEGError, match="CMYK"):
        load_image(str(path))


def test_unrefined_progressive_scans_raise():
    """A progressive file cut after its first scans (then EOI) would need
    libjpeg's block smoothing: refused, not decoded differently."""
    data = cv2.imencode(".jpg", scene(40, 48, 12), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    third_sos = [i for i in range(len(data) - 1) if data[i: i + 2] == b"\xff\xda"][2]
    with pytest.raises(JPEGError, match="unrefined"):
        decode_jpeg(data[:third_sos] + b"\xff\xd9")
