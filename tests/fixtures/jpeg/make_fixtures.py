"""Write the JPEG fixtures of `tests/test_torch_port_jpeg.py` and their
digests (needs cv2):

    python tests/fixtures/jpeg/make_fixtures.py

Each file is written by `cv2.imwrite` from a seeded image; `digests.json`
holds the sha256 of `cv2.imread`'s array for each file, colour (in RGB
order, as the readers return it) and gray, so that a host without cv2 can
hold the port's decoder to cv2's.
"""

import hashlib
import json
import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
_SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
}


def scene(h, w, seed):
    """A smooth synthetic street-like scene: gradients, a few shapes, mild
    noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([60 + 120 * y / h, 90 + 60 * np.sin(x / 97.0),
                    140 + 80 * np.cos((x + y) / 151.0)], -1)
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.05, 0.2) * min(h, w)
        inside = (y - cy) ** 2 + (x - cx) ** 2 < r * r
        img[inside] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 2.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# name: (height, width, sampling or None for 1 component, quality,
# restart interval, seed)
CASES = {
    "s444_q95_37x53": (37, 53, "444", 95, 0, 1),
    "s422_q50_47x61": (47, 61, "422", 50, 0, 2),
    "s420_q95_47x61": (47, 61, "420", 95, 0, 3),
    "s420_q50_37x53_rst1": (37, 53, "420", 50, 1, 4),
    "gray_q95_37x53": (37, 53, None, 95, 0, 5),
    "scene_420_q95_480x640_a": (480, 640, "420", 95, 0, 6),
    "scene_420_q95_480x640_b": (480, 640, "420", 95, 0, 7),
}


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    out = {}
    for name, (h, w, sampling, q, rst, seed) in CASES.items():
        img = scene(h, w, seed)
        params = [cv2.IMWRITE_JPEG_QUALITY, q,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
        if sampling is None:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        else:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[sampling]]
        path = os.path.join(HERE, name + ".jpg")
        assert cv2.imwrite(path, img, params)
        color = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
        gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        out[name + ".jpg"] = {"shape": list(color.shape),
                              "color": digest(color), "gray": digest(gray)}
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
