"""The port's JPEG decoder (`sigma_tpu_torch/data/jpeg.py`, host C++ in
`csrc/jpeg_decode.cpp`) against cv2, on the CPU.

  * the committed fixtures (`tests/fixtures/jpeg/`, written by
    `make_fixtures.py` with cv2.imwrite: sampling 4:4:4, 4:2:2 and 4:2:0,
    one component, a restart interval, 37x53 and 47x61, qualities 50 and
    95, two 480x640 scenes; and progressive ones: one component, 4:4:4,
    4:2:0, a restart interval, a 480x640 scene) against the sha256 of
    `cv2.imread`'s arrays recorded with them: no cv2 needed, as on the
    card's machine;
  * the dataset reader `_read` against the JAX package's reader
    (`sigma_tpu/data/dataset.py`: cv2.imread, colour and gray) bit for
    bit, tolerance 0, on the fixtures and on files written here: 4:4:0
    and 4:1:1, 1x1 and 16x17, restart intervals, files cut short inside
    their scan (with and without an EOI), every EXIF orientation in both
    byte orders, no JFIF marker with an Adobe transform 0 and with 'RGB'
    component ids; progressive 4:4:0, 4:1:1, 1x1, 16x17 with a restart
    interval, and files cut short in their last scan;
  * arithmetic-coded, lossless, 12-bit and 4-component files, damaged
    ones, and a progressive one cut short before its first 10
    coefficients are complete (libjpeg smooths its blocks) raise a
    ValueError naming the file and ROADMAP C8.
"""

import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import pytest

from sigma_tpu_torch.data.dataset import _read

FIXTURES = Path(__file__).parent / "fixtures" / "jpeg"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_decodes_to_its_cv2_digests(name):
    want = DIGESTS[name]
    color = _read(str(FIXTURES / name), gray=False)
    gray = _read(str(FIXTURES / name), gray=True)
    assert list(color.shape) == want["shape"] and color.dtype == np.uint8
    assert gray.shape == color.shape[:2] and gray.dtype == np.uint8
    assert _sha(color) == want["color"]
    assert _sha(gray) == want["gray"]


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0), 128 + 90 * np.cos(y / 5.0),
                    (x * 3 + y * 5) % 256], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(
        np.uint8)


def _segment(marker, payload):
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + \
        payload


def _exif(order, orientation):
    e = "<" if order == b"II" else ">"
    entries = (struct.pack(e + "HHII", 0x010F, 2, 4, 0)
               + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0))
    tiff = (order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 2)
            + entries + struct.pack(e + "I", 0))
    return _segment(0xE1, b"Exif\x00\x00" + tiff)


def _without_jfif(data):
    assert data[2:4] == b"\xff\xe0"
    (n,) = struct.unpack(">H", data[4:6])
    return data[:2] + data[4 + n:]


def _rgb_ids(data):
    b = bytearray(_without_jfif(data))
    sof, sos = b.find(b"\xff\xc0"), b.find(b"\xff\xda")
    for k in range(3):
        b[sof + 10 + 3 * k] = b[sos + 5 + 2 * k] = b"RGB"[k]
    return bytes(b)


def _cut(data, frac, eoi, last_scan=False):
    """`data` cut `frac` of the way into its first scan (or its last) and
    ended with an EOI or not."""
    sos = data.rfind(b"\xff\xda") if last_scan else data.find(b"\xff\xda")
    cut = sos + 14 + int(frac * (len(data) - sos - 14))
    return data[:cut] + (b"\xff\xd9" if eoi else b"")


# name: (height, width, sampling, quality, restart interval, edit[,
# progressive])
_LIVE = {
    "prog_s440_q95_37x53": (37, 53, "440", 95, 0, None, True),
    "prog_s411_q50_47x61": (47, 61, "411", 50, 0, None, True),
    "prog_s420_q95_1x1": (1, 1, "420", 95, 0, None, True),
    "prog_s422_q95_16x17_rst1": (16, 17, "422", 95, 1, None, True),
    # libjpeg smooths no block: coefficients 1-9 are complete by then
    "prog_s420_q95_cut_in_last_scan": (
        47, 61, "420", 95, 0, lambda d: _cut(d, 0.5, False, True), True),
    "prog_s420_q95_rst2_cut_in_last_scan_eoi": (
        47, 61, "420", 95, 2, lambda d: _cut(d, 0.3, True, True), True),
    "s440_q95_37x53": (37, 53, "440", 95, 0, None),
    "s411_q50_47x61": (47, 61, "411", 50, 0, None),
    "s420_q95_1x1": (1, 1, "420", 95, 0, None),
    "s422_q95_16x17_rst2": (16, 17, "422", 95, 2, None),
    "s420_q95_cut_at_40pct": (47, 61, "420", 95, 0,
                              lambda d: _cut(d, 0.4, False)),
    "s420_q95_rst1_cut_at_70pct_eoi": (47, 61, "420", 95, 1,
                                       lambda d: _cut(d, 0.7, True)),
    "s444_adobe_transform_0": (
        21, 34, "444", 90, 0,
        lambda d: d[:2] + _segment(0xEE, b"Adobe" + struct.pack(
            ">HHHB", 100, 0, 0, 0)) + _without_jfif(d)[2:]),
    "s420_rgb_component_ids": (21, 34, "420", 90, 0, _rgb_ids),
    **{f"exif_{o.decode()}_orientation_{k}": (
        21, 34, "420", 90, 0,
        lambda d, o=o, k=k: d[:2] + _exif(o, k) + d[2:])
       for o in (b"II", b"MM") for k in range(1, 9)},
}


def _write_live(path, case):
    cv2 = pytest.importorskip("cv2")
    h, w, sampling, q, rst, edit, *prog = case
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    ok, buf = cv2.imencode(".jpg", _scene(h, w, h * w), [
        cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        factor, cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(bool(prog))])
    assert ok
    data = buf.tobytes()
    path.write_bytes(edit(data) if edit else data)


@pytest.mark.parametrize("name", sorted(DIGESTS) + sorted(_LIVE))
def test_reader_equals_the_jax_readers_cv2(name, tmp_path):
    pytest.importorskip("cv2")
    from sigma_tpu.data.dataset import RGBXDataset as JaxDataset

    if name in DIGESTS:
        path = FIXTURES / name
    else:
        path = tmp_path / (name + ".jpg")
        _write_live(path, _LIVE[name])
    for gray, ref in ((False, JaxDataset._open_rgb),
                      (True, JaxDataset._open_gray)):
        got, want = _read(str(path), gray), ref(str(path))
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape, (gray, got.shape, want.shape)
        assert np.array_equal(got, want), (gray, int(np.sum(got != want)))


def _patched(data, marker=None, precision=None, components=None):
    b = bytearray(data)
    sof = b.find(b"\xff\xc0")
    if marker is not None:
        b[sof + 1] = marker
    if precision is not None:
        b[sof + 4] = precision
    if components is not None:
        b[sof + 9] = components
    return bytes(b)


def test_unsupported_and_damaged_files_raise_naming_the_file(tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = _scene(21, 34, 0)
    base = cv2.imencode(".jpg", img)[1].tobytes()
    progressive = cv2.imencode(
        ".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    cases = {
        # cut in its third scan: libjpeg would smooth the blocks
        "block smoothing": progressive[:progressive.find(
            b"\xff\xda", progressive.find(b"\xff\xda", progressive.find(
                b"\xff\xda") + 2) + 2) + 40],
        "arithmetic-coded": _patched(base, marker=0xC9),
        "lossless": _patched(base, marker=0xC3),
        "12-bit": _patched(base, precision=12),
        "4-component": _patched(base, components=4),
        "damaged": b"\xff\xd8",
        "not a JPEG": b"GIF89a",
    }
    bad_table = bytearray(base)  # three 1-bit Huffman codes
    bad_table[bad_table.find(b"\xff\xc4") + 5] = 3
    cases["damaged JPEG: bad Huffman table"] = bytes(bad_table)
    for i, (what, data) in enumerate(cases.items()):
        path = tmp_path / f"case{i}.jpg"
        path.write_bytes(data)
        for gray in (False, True):
            with pytest.raises(ValueError, match=what) as e:
                _read(str(path), gray)
            assert str(path) in str(e.value)
            assert "ROADMAP C8" in str(e.value) or what == "not a JPEG"
