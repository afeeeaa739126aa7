"""The port's file-backed path without cv2, against cv2 and the JAX
package, on the CPU.

  * `sigma_tpu_torch/data/png.py` against `cv2.imread` on PNGs that cv2
    writes (gray, RGB, RGBA, 8 and 16 bits, every row filter cv2 can be
    asked for, odd widths) and on palette and gray-alpha files written
    here with a random filter on every row; cv2's own 480x640 fixture
    (`tests/fixtures/cv2_adaptive_480x640.png`, written by cv2 5.0 on
    libpng 1.6.58 with `IMWRITE_PNG_ALL_FILTERS`) against the digests
    `chip_smoke.py` checks on the card's host; the writer read back by
    cv2; the errors.
  * `sigma_tpu_torch/data/resize.py` against `cv2.resize` in both call
    forms, bilinear and nearest, at every train scale and both eval
    scales, on 480x640, 47x61 and 37x53, RGB and 2-D: bit for bit (the
    share of differing pixels is 0 in every case).
  * the dataset reader, `TrainPre` and `SlidingEvaluator` (scales 0.75,
    1, 1.25 with flip, a 3-channel and a 2-D modal-x; `image_batch` 3
    over 5 images) run with `sys.modules["cv2"] = None`, against the JAX
    package's counterparts, which use cv2; `save_prediction` too, and no
    module of the port imports cv2 (JPEG: tests/test_torch_port_jpeg.py).
"""

import ast
import hashlib
import struct
import sys
import zlib
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import configs as jax_configs
from sigma_tpu.data import RGBXDataset as JaxDataset
from sigma_tpu.data import TrainPre as JaxTrainPre
from sigma_tpu.engine.evaluator import SlidingEvaluator as JaxEvaluator
from sigma_tpu_torch import configs
from sigma_tpu_torch.data import RGBXDataset, TrainPre
from sigma_tpu_torch.data.png import read_png, write_png
from sigma_tpu_torch.data.resize import resize_u8
from sigma_tpu_torch.engine.evaluator import SlidingEvaluator
from sigma_tpu_torch.utils.visualize import save_prediction

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TRAIN_SCALES = (0.5, 0.75, 1, 1.25, 1.5, 1.75)
EVAL_SCALES = (0.75, 1.25)
CV2_FILTERS = {
    "default": [],
    "all": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS],
    "paeth": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_PAETH],
    "avg": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_AVG],
    "up": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_UP],
    "none": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_NONE],
}


@pytest.fixture
def no_cv2(monkeypatch):
    """An import of cv2 fails while the test runs."""
    monkeypatch.setitem(sys.modules, "cv2", None)


def _cv2_read(path, gray):
    img = cv2.imread(str(path),
                     cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    return img if gray else img[..., ::-1]


def _image(rng, h, w, c, dtype=np.uint8):
    """Noise over a ramp (so that every filter is worth choosing), the
    first rows with equal channels (the gray conversion's own case)."""
    top = np.iinfo(dtype).max
    ramp = np.add.outer(np.arange(h), 3 * np.arange(w)) * (top // 255)
    img = (ramp[..., None] * (1 + np.arange(c))
           + rng.integers(0, top // 8, (h, w, c))) % (top + 1)
    img = img.astype(dtype)
    img[: h // 4, :, 1:min(c, 3)] = img[: h // 4, :, :1]
    return img if c > 1 else img[..., 0]


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba"])
@pytest.mark.parametrize("depth", [8, 16])
def test_reader_matches_cv2_on_cv2_files(tmp_path, kind, depth):
    rng = np.random.default_rng(depth)
    c = {"gray": 1, "rgb": 3, "rgba": 4}[kind]
    for h, w in ((37, 53), (64, 97), (5, 1), (1, 7)):
        img = _image(rng, h, w, c, np.uint8 if depth == 8 else np.uint16)
        for name, params in CV2_FILTERS.items():
            path = tmp_path / f"{name}.png"
            assert cv2.imwrite(str(path), img, params)
            for gray in (False, True):
                got, want = read_png(path, gray=gray), _cv2_read(path, gray)
                assert got.dtype == np.uint8 and got.shape == want.shape
                assert np.array_equal(got, want), (h, w, name, gray)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _write_filtered(path, px, ctype, rng, palette=None, trns=None,
                    interlace=0, depth=8):
    """A PNG with a random filter (0-4) on every row."""
    h, w = px.shape[:2]
    rows = px.reshape(h, -1).astype(np.int64)
    bpp = rows.shape[1] // w
    data, prev = [], np.zeros(rows.shape[1], np.int64)
    for x in rows:
        f = int(rng.integers(0, 5))
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = [0, a, b, (a + b) >> 1,
                np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))][f]
        data.append(bytes([f]) + ((x - pred) & 255).astype(np.uint8)
                    .tobytes())
        prev = x
    buf = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        buf += _chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        buf += _chunk(b"tRNS", trns)
    buf += _chunk(b"IDAT", zlib.compress(b"".join(data))) + _chunk(
        b"IEND", b"")
    Path(path).write_bytes(buf)


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_reader_matches_cv2_on_every_row_filter(tmp_path, ctype):
    """Every colour type, each row with a random filter (Average and
    Paeth rows go through the anti-diagonal decode), palette with tRNS."""
    rng = np.random.default_rng(ctype)
    path = tmp_path / "f.png"
    for h, w in ((37, 53), (3, 1), (1, 9), (40, 4)):
        palette = trns = None
        if ctype == 3:
            palette = rng.integers(0, 256, (23, 3), dtype=np.uint8)
            palette[5] = 90  # a gray entry
            trns = bytes([0, 128, 255])
            px = rng.integers(0, 23, (h, w, 1)).astype(np.uint8)
        else:
            px = _image(rng, h, w, {0: 1, 2: 3, 4: 2, 6: 4}[ctype])
            px = px.reshape(h, w, -1)
        _write_filtered(path, px, ctype, rng, palette, trns)
        for gray in (False, True):
            got, want = read_png(path, gray=gray), _cv2_read(path, gray)
            assert got.shape == want.shape and np.array_equal(got, want), (
                h, w, gray)


@pytest.mark.parametrize("gray", [False, True])
def test_cv2_fixture_decodes_to_cv2s_array(gray):
    """The 480x640 file chip_smoke.py decodes on the card's host: cv2's
    array, and the digests that script holds it to."""
    path = chip_smoke.CV2_PNG
    got, want = read_png(path, gray=gray), _cv2_read(path, gray)
    assert got.shape == want.shape and np.array_equal(got, want)
    digest = hashlib.sha256(np.ascontiguousarray(want).tobytes())
    assert digest.hexdigest() == chip_smoke.CV2_PNG_SHA256[gray]


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (1, 1, 3)])
def test_writer_is_read_back_by_cv2(tmp_path, shape):
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "w.png"
    write_png(path, img)
    back = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(back if img.ndim == 2 else back[..., ::-1], img)
    assert np.array_equal(read_png(path, gray=img.ndim == 2), img)


def test_reader_errors_name_the_file(tmp_path, no_cv2):
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (4, 5, 1), dtype=np.uint8)
    cases = {}
    _write_filtered(tmp_path / "adam7.png", px, 0, rng, interlace=1)
    cases["adam7.png"] = "interlaced"
    _write_filtered(tmp_path / "depth4.png", px, 0, rng, depth=4)
    cases["depth4.png"] = "bit depth 4"
    good = tmp_path / "good.png"
    write_png(good, px[..., 0])
    (tmp_path / "cut.png").write_bytes(good.read_bytes()[:-20])
    cases["cut.png"] = "damaged|ends before IEND"
    (tmp_path / "text.png").write_bytes(b"not a png")
    cases["text.png"] = "not a PNG"
    for name, what in cases.items():
        with pytest.raises(ValueError, match=what) as e:
            read_png(tmp_path / name)
        assert name in str(e.value)
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "x.png", px.astype(np.uint16))
    # the dataset reader: a missing file, and a damaged JPEG without cv2
    with pytest.raises(FileNotFoundError):
        RGBXDataset._open_rgb(str(tmp_path / "missing.png"))
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(ValueError, match="a.jpg.*damaged.*C8"):
        RGBXDataset._open_rgb(str(tmp_path / "a.jpg"))


@pytest.mark.parametrize("size", [(480, 640), (47, 61), (37, 53)])
@pytest.mark.parametrize("mode", ["linear", "nearest"])
def test_resize_matches_cv2_bit_for_bit(size, mode):
    """Both call forms at every train scale and both eval scales (the fx
    form also at the train scales: 0.5 is cv2's INTER_AREA fast path,
    odd sizes included). Share of pixels that differ from cv2: 0 in
    every case."""
    interp = {"linear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST}
    rng = np.random.default_rng(size[0])
    h, w = size
    for img in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                rng.integers(0, 256, (h, w), dtype=np.uint8)):
        t = torch.from_numpy(img)
        for s in TRAIN_SCALES + EVAL_SCALES:
            for kw, ckw in (
                    (dict(dsize=(int(w * s), int(h * s))),
                     dict(dsize=(int(w * s), int(h * s)))),
                    (dict(fx=s), dict(dsize=None, fx=s, fy=s))):
                want = cv2.resize(img, interpolation=interp[mode], **ckw)
                got = resize_u8(t, interpolation=mode, **kw).numpy()
                assert got.shape == want.shape, (s, kw)
                assert (got != want).mean() == 0.0, (s, kw)


# --- a per-pixel linear "model" shared by both evaluators --------------
C = 7
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
_r = np.random.default_rng(0)
W1 = (_r.standard_normal((3, C)) * 0.3).astype(np.float32)
W2 = (_r.standard_normal((3, C)) * 0.2).astype(np.float32)
V = (_r.standard_normal(C) * 0.5).astype(np.float32)


class JaxLinear:
    """Per pixel linear, plus a row cumsum, so that a window at the wrong
    offset changes the scores."""

    def apply(self, variables, rgb, mx):
        return rgb @ W1 + mx @ W2 + jnp.cumsum(rgb[..., :1], axis=1) * V


def torch_linear(rgb, mx):
    t = torch.from_numpy
    return rgb @ t(W1) + mx @ t(W2) + torch.cumsum(rgb[..., :1], 1) * t(V)


NYU_PROTOCOL = dict(multi_scales=(0.75, 1, 1.25), is_flip=True,
                    eval_crop_size=(40, 56), stride_rate=2 / 3,
                    window_batch=3)


def _items(rng, shapes, modal2d):
    out = []
    for i, (h, w) in enumerate(shapes):
        label = rng.integers(0, C, (h, w)).astype(np.uint8)
        label[0] = 255
        out.append(dict(
            data=rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            modal_x=rng.integers(0, 256, (h, w) if modal2d else (h, w, 3),
                                 dtype=np.uint8),
            label=label, fn=f"i{i}", n=len(shapes)))
    return out


def _hist(preds, items):
    hist = np.zeros((C, C), np.int64)
    for it in items:
        gt, p = it["label"].astype(np.int64), preds[it["fn"]]
        keep = gt < C
        np.add.at(hist, (gt[keep], p[keep]), 1)
    return hist


@pytest.mark.parametrize("modal2d", [False, True])
def test_evaluator_nyu_protocol_matches_jax_without_cv2(modal2d, no_cv2):
    """Scales (0.75, 1, 1.25) with flip: the grid, the whole-image branch
    and the collapsed windows, the input resized on the device by
    resize_u8 (nearest for a 2-D modal-x) against JAX's cv2 resize."""
    items = _items(np.random.default_rng(4), [(60, 83), (47, 61)], modal2d)
    jev = JaxEvaluator(JaxLinear(), C, MEAN, STD, **NYU_PROTOCOL)
    tev = SlidingEvaluator(torch_linear, C, MEAN, STD, device="cpu",
                           **NYU_PROTOCOL)
    preds = {}
    for it in items:
        got = tev.sliding_eval(it["data"], it["modal_x"])
        want = jev.sliding_eval(None, it["data"], it["modal_x"])
        assert got.shape == want.shape and got.dtype == np.int32
        assert (got == want).mean() >= 0.995
        preds[it["fn"]] = (got, want)
    h_port = _hist({k: v[0] for k, v in preds.items()}, items)
    h_jax = _hist({k: v[1] for k, v in preds.items()}, items)
    assert np.abs(h_port - h_jax).sum() / 2 <= 0.005 * h_jax.sum()


def test_image_batch_matches_jax_and_batch_one(no_cv2):
    """image_batch 3 over 5 images of two shapes (a group flushed at the
    shape change, two padded tails): the predictions of image_batch 1,
    and JAX's image_batch run's mIoU and per-class IoU."""
    items = _items(np.random.default_rng(5),
                   [(50, 70)] * 4 + [(47, 61)], modal2d=False)
    preds = {}
    for ib in (1, 3):
        got = {}
        ev = SlidingEvaluator(torch_linear, C, MEAN, STD, device="cpu",
                              image_batch=ib, **NYU_PROTOCOL)
        miou, det = ev.run(items, save_fn=lambda fn, p: got.__setitem__(
            fn, p))
        preds[ib] = (got, miou, det)
    assert all(np.array_equal(preds[1][0][k], preds[3][0][k])
               for k in preds[1][0])
    jgot = {}
    jmiou, jdet = JaxEvaluator(JaxLinear(), C, MEAN, STD, image_batch=3,
                               **NYU_PROTOCOL).run(
        None, items, save_fn=lambda fn, p: jgot.__setitem__(fn, p),
        shard_across_processes=False)
    for k, p in preds[3][0].items():
        assert (p == jgot[k]).mean() >= 0.995
    assert preds[3][1] == pytest.approx(jmiou, abs=0.5)
    h_port, h_jax = _hist(preds[3][0], items), _hist(jgot, items)
    assert np.abs(h_port - h_jax).sum() / 2 <= 0.005 * h_jax.sum()


@pytest.fixture(scope="module")
def cv2_tree(tmp_path_factory):
    """MFNet layout at odd sizes, written by cv2 with libpng's adaptive
    filters (Average / Paeth rows)."""
    root = tmp_path_factory.mktemp("mfnet_cv2")
    for sub in ("RGB", "Label", "Modal"):
        (root / sub).mkdir()
    rng = np.random.default_rng(6)
    names = [f"c{i:02d}" for i in range(6)]
    flt = CV2_FILTERS["all"]
    for i, n in enumerate(names):
        h, w = (37, 53) if i % 2 else (47, 61)
        cv2.imwrite(str(root / "RGB" / f"{n}.png"), _image(rng, h, w, 3), flt)
        label = rng.integers(0, 9, (h, w)).astype(np.uint8)
        label[0] = 255
        cv2.imwrite(str(root / "Label" / f"{n}.png"), label, flt)
        cv2.imwrite(str(root / "Modal" / f"{n}.png"), _image(rng, h, w, 1),
                    flt)
    (root / "train2.txt").write_text("\n".join(names) + "\n")
    (root / "test.txt").write_text("\n".join(names[:2]) + "\n")
    return str(root)


@pytest.mark.parametrize("device_norm", [True, False])
def test_dataset_and_train_pre_match_jax_without_cv2(cv2_tree, device_norm,
                                                     no_cv2):
    """The port's reader and TrainPre with cv2 blocked against the JAX
    package's (cv2.imread, cv2.resize), every train scale drawn."""
    cfg = configs.get_config("mfnet", dataset_path=cv2_tree)
    jcfg = jax_configs.get_config("mfnet", dataset_path=cv2_tree)
    for c in (cfg, jcfg):
        object.__setattr__(c, "image_height", 32)
        object.__setattr__(c, "image_width", 48)
    port = RGBXDataset(cfg.data_setting(), "train",
                       TrainPre(cfg.norm_mean, cfg.norm_std, cfg,
                                device_norm=device_norm),
                       file_length=24, seed=2)
    ref = JaxDataset(jcfg.data_setting(), "train",
                     JaxTrainPre(jcfg.norm_mean, jcfg.norm_std, jcfg,
                                 use_native=False, device_norm=device_norm),
                     file_length=24, seed=2)
    drawn = set()
    for i in range(len(ref)):
        a = port.__getitem__(i, rng=np.random.default_rng(i))
        b = ref.__getitem__(i, rng=np.random.default_rng(i))
        drawn.add(TrainPre(cfg.norm_mean, cfg.norm_std, cfg)._draws(
            np.random.default_rng(i))[1])
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                assert np.array_equal(a[k], b[k]), k
    assert drawn == set(TRAIN_SCALES)


def test_no_cv2_on_the_port_path(cv2_tree, tmp_path, no_cv2):
    """The reader on PNG, TrainPre, SlidingEvaluator at (0.75, 1, 1.25)
    with flip and save_prediction run with cv2 blocked; no module of the
    port binds cv2, and its source imports cv2 nowhere."""
    cfg = configs.get_config("mfnet", dataset_path=cv2_tree)
    object.__setattr__(cfg, "image_height", 32)
    object.__setattr__(cfg, "image_width", 48)
    item = RGBXDataset(cfg.data_setting(), "train",
                       TrainPre(cfg.norm_mean, cfg.norm_std, cfg))[0]
    assert item["data"].shape == (32, 48, 3)
    val = RGBXDataset(cfg.data_setting(), "val")[0]
    pred = SlidingEvaluator(torch_linear, C, MEAN, STD, device="cpu",
                            **NYU_PROTOCOL).sliding_eval(val["data"],
                                                         val["modal_x"])
    save_prediction(str(tmp_path / "pred"), "x", pred,
                    RGBXDataset.get_class_colors(41))
    assert np.array_equal(read_png(tmp_path / "pred" / "x.png", gray=True),
                          pred.astype(np.uint8))
    assert read_png(tmp_path / "pred_color" / "x.png").shape == \
        pred.shape + (3,)
    bound = [name for name, m in list(sys.modules.items())
             if name.startswith("sigma_tpu_torch") and m is not None
             and "cv2" in vars(m)]
    assert not bound, bound
    importers = []
    for path in sorted((ROOT / "sigma_tpu_torch").rglob("*.py")):
        importers += [(path.name, fn) for fn in
                      _cv2_imports(ast.parse(path.read_text()), None)]
    assert importers == [], importers


def _cv2_imports(node, fn):
    """Names of the functions (None: module level) that import cv2."""
    found = []
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in child.names]
                     if isinstance(child, ast.Import)
                     else [child.module or ""])
            if any(n.split(".")[0] == "cv2" for n in names):
                found.append(fn)
        inner = (child.name if isinstance(
            child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)
        found += _cv2_imports(child, inner)
    return found
