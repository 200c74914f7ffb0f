"""Make the photometric augmentations' fixture, ``tests/golden_torch/augment_fixture.npz``.

Needs OpenCV, so it runs where OpenCV is installed (the card's machine has
none): ``python tests/golden_torch/make_augment_fixtures.py`` from the
repository root. It holds (see ``chip_smoke.AUGMENT_FIXTURE``):

- ``crops``: six 256 x 192 crops of the golden JPEGs as the JAX train
  pipeline cuts them (``cv2.imread``, ``cv2.warpAffine`` of a rotated,
  scaled box);
- the parameters of ``chip_smoke.augment_fixture_params`` for a batch of
  ``chip_smoke.AUGMENT_B`` samples over those crops;
- ``digests`` (B, 4, 32): the SHA-256 of each sample's uint8 result after
  each op, the ops as the JAX transforms run them
  (``probpose_code_tpu/datasets/transforms/common.py:490-510, 792-871``):
  ``cv2.cvtColor`` to HSV, the gains, back to BGR; ``cv2.blur``;
  ``cv2.medianBlur``; the hole set to 0;
- ``photometric``: ``chip_smoke.photometric_fixture_params``'s rows of
  ``PhotometricDistortion``, one a sample; ``photometric_after_hsv`` and
  ``photometric_first`` (B, 32): the SHA-256 of each sample's result of the
  distortion as the JAX transform computes it (``common.py:384-406``, NumPy
  and ``cv2.cvtColor``) after the HSV jitter (the body8 recipes' order) and
  on the crop (the halpe26 recipes');
- ``bgr_to_hsv``, ``hsv_to_bgr``, ``hsv_to_bgr_180``: the SHA-256 of
  ``cv2.cvtColor`` over every colour, every HSV triple with a hue below
  180, and those of hue 180; ``blur_<k>``, ``median_<k>``: of ``cv2.blur``
  and ``cv2.medianBlur`` over the window-sum tiles.
"""

import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[2]
OUT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    AUGMENT_B,
    AUGMENT_FIXTURE,
    AUGMENT_KSIZES,
    all_bgr_colours,
    all_hsv_triples,
    augment_fixture_params,
    photometric_fixture_params,
    sha256,
    window_sum_tiles,
)

# (golden image id, box centre x, y, box height, rotation in degrees) of each crop
CROPS = ((1, 150, 180, 260, 0.0), (4, 210, 200, 300, 35.0), (7, 160, 150, 180, -60.0),
         (12, 200, 240, 420, 12.0), (18, 120, 200, 240, 80.0), (23, 230, 160, 200, -25.0))


def crop(image_id, cx, cy, height, angle):
    img = cv2.imread(str(OUT / "golden" / f"{image_id}.jpg"))
    mat = cv2.getRotationMatrix2D((cx, cy), angle, 256 / height)
    mat[:, 2] += (96 - cx, 128 - cy)
    return cv2.warpAffine(img, mat, (192, 256), flags=cv2.INTER_LINEAR)


def cv2_ops(img, gains, blur_k, median_k, rects):
    """Each op's result in turn, as the JAX transforms compute it."""
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + gains[0]) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + gains[1], 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + gains[2], 0, 255)
    out = [cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)]
    out.append(cv2.blur(out[-1], (blur_k, blur_k)) if blur_k else out[-1])
    out.append(cv2.medianBlur(np.ascontiguousarray(out[-1]), median_k) if median_k else out[-1])
    dropped = out[-1].copy()
    for y, x, h, w in rects:
        dropped[y:y + h, x:x + w] = 0
    return out + [dropped]


def cv2_photometric(img, row):
    """``PhotometricDistortion`` of the JAX package (``probpose_code_tpu/
    datasets/transforms/common.py:384-406``) with the draws of ``row``
    (``datasets/transforms/common.py:PhotometricDistortion``'s record)
    instead of its own; a neutral value does what a step that does not
    fire does."""
    brightness, contrast, saturation, hue, contrast_after = (float(v) for v in row[:5])
    img = img.astype(np.float32)
    img += brightness
    img *= contrast
    hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_BGR2HSV).astype(np.float32)
    hsv[..., 1] *= saturation
    hsv[..., 0] = (hsv[..., 0] + hue) % 180
    img = cv2.cvtColor(np.clip(hsv, 0, 255).astype(np.uint8), cv2.COLOR_HSV2BGR).astype(np.float32)
    img *= contrast_after
    return np.clip(img[..., row[5:].astype(int)], 0, 255).astype(np.uint8)


def main():
    crops = np.stack([crop(*c) for c in CROPS])
    params = augment_fixture_params(AUGMENT_B, len(crops))
    digests = np.stack([
        [np.frombuffer(sha256(o), np.uint8) for o in cv2_ops(crops[i], *(params[k][j] for k in (
            "hsv_gains", "blur_ksize", "median_ksize", "dropout_rects")))]
        for j, i in enumerate(params["index"])])
    arrays = dict(crops=crops, digests=digests, **params)
    rows = photometric_fixture_params(AUGMENT_B)
    arrays["photometric"] = rows
    for name, stage in (("photometric_after_hsv", 0), ("photometric_first", None)):
        arrays[name] = np.stack([np.frombuffer(sha256(cv2_photometric(
            crops[i] if stage is None else cv2_ops(crops[i], params["hsv_gains"][j], 0, 0, ())[stage], rows[j])),
            np.uint8) for j, i in enumerate(params["index"])])
    arrays["bgr_to_hsv"] = np.frombuffer(sha256(cv2.cvtColor(all_bgr_colours(), cv2.COLOR_BGR2HSV)), np.uint8)
    arrays["hsv_to_bgr"] = np.frombuffer(sha256(cv2.cvtColor(all_hsv_triples(), cv2.COLOR_HSV2BGR)), np.uint8)
    arrays["hsv_to_bgr_180"] = np.frombuffer(sha256(cv2.cvtColor(all_hsv_triples([180]), cv2.COLOR_HSV2BGR)),
                                             np.uint8)
    for k in AUGMENT_KSIZES:
        tiles = window_sum_tiles(k)
        arrays[f"blur_{k}"] = np.frombuffer(sha256(cv2.blur(tiles, (k, k))), np.uint8)
        arrays[f"median_{k}"] = np.frombuffer(sha256(cv2.medianBlur(tiles, k)), np.uint8)
    np.savez_compressed(AUGMENT_FIXTURE, **arrays)
    print(f"wrote {AUGMENT_FIXTURE} ({AUGMENT_FIXTURE.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
