"""Image loading transform without OpenCV.

The port's own ``LoadImage`` (``probpose_code_tpu/datasets/transforms/
loading.py:45``, reference ``datasets/transforms/loading.py:12``): an ``img``
already in the results is kept, as in the JAX package (``:125-134``); a file
is read as ``cv2.imread(path, IMREAD_COLOR)`` reads it, BGR uint8, by the
port's PNG decoder (``datasets/png.py``). Any other format raises an error
that names the missing decoder: JPEG decoding (and the JAX package's
``lazy`` native path) comes with a later slice.
"""

from __future__ import annotations

from typing import Optional

from probpose_code_torch.datasets.png import decode_png, is_png
from probpose_code_torch.registry import TRANSFORMS


def imread(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8 BGR."""
    with open(path, "rb") as f:
        data = f.read()
    if is_png(data):
        return decode_png(data)
    kind = "JPEG" if data[:3] == b"\xff\xd8\xff" else "this format"
    raise ValueError(f"{path}: the port has no {kind} decoder yet (it reads PNG files; OpenCV is not used)")


@TRANSFORMS.register_module()
class LoadImage:
    """The JAX transform's options (``to_float32``, ``color_type``,
    ``pad_to_aspect_ratio``, ``lazy``) are set by no config and are not
    ported: the port loads color images as uint8."""

    def __call__(self, results: dict) -> Optional[dict]:
        try:
            if "img" not in results:
                path = results["img_path"]
                if not isinstance(path, str):
                    raise NotImplementedError("LoadImage: multi-frame samples are not ported yet")
                results["img"] = imread(path)
            else:
                results.setdefault("img_path", None)
            results["img_shape"] = results["img"].shape[:2]
            results["ori_shape"] = results["img"].shape[:2]
        except Exception as e:
            raise type(e)(f"{e} occurs when loading {results.get('img_path')}") from e
        return results
