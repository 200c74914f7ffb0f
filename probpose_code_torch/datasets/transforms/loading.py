"""Image loading transform without OpenCV.

The port's own ``LoadImage`` (``probpose_code_tpu/datasets/transforms/
loading.py:45``, reference ``datasets/transforms/loading.py:12``): an ``img``
already in the results is kept, as in the JAX package (``:125-134``); a file
is read by its signature:

- a JPEG is never decoded here. As the JAX package's ``lazy`` path
  (``_try_lazy``, ``:60-89``) does, only its header is read
  (``datasets/jpeg.py:probe``, which also walks the stream to its end and
  raises on a truncated or unsupported one, naming the file): ``img_bytes``
  holds the file, ``jpeg_info`` the header, and ``img`` is a zero-stride
  dummy of the image's shape as ``cv2.imread`` returns it (EXIF orientation
  applied). ``RandomFlip`` records its flip on such a sample and
  ``TopdownAffine`` folds it into the warp; the bytes go through the loader
  to the model's device, where ``PoseModel.device_preprocess_batch``
  decodes the batch (on the card by ``ops/kernels/jpeg.py``, on the CPU by
  ``datasets/jpeg.py``)
  and crops it. So the port's JPEG path is always the deferred one, and the
  JAX ``lazy`` key changes nothing;
- a PNG is decoded as ``cv2.imread(path, IMREAD_COLOR)`` decodes it, BGR
  uint8, by the port's PNG decoder (``datasets/png.py``);
- anything else raises.

``read_image_bytes`` is the one place that picks a decoder by the
signature: ``imread``, ``apis.inference_topdown`` and ``tools.serve`` call
it; ``LoadImage`` only keeps its deferred JPEG branch ahead of it.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from probpose_code_torch.datasets.jpeg import decode as decode_jpeg
from probpose_code_torch.datasets.jpeg import is_jpeg, probe
from probpose_code_torch.datasets.png import decode_png, is_png
from probpose_code_torch.registry import TRANSFORMS


def read_image_bytes(data: bytes, name: str, device=None) -> Union[np.ndarray, torch.Tensor]:
    """An encoded image as (H, W, 3) uint8 BGR, as ``cv2.imread`` and
    ``cv2.imdecode`` read it: a PNG decoded on the host (an array); a JPEG
    decoded on ``device`` (a tensor there, ``ops/kernels/jpeg.py``), or on
    the host by the plain decoder (an array) when no device is given.
    ``name`` names the image (its file) in errors."""
    if is_png(data):
        return decode_png(data)
    if is_jpeg(data):
        if device is None:
            return decode_jpeg(data, name)
        # imported here: ops.kernels.jpeg imports datasets.jpeg, whose package imports this module
        from probpose_code_torch.ops.kernels.jpeg import decode_bytes

        return decode_bytes(data, device, name)
    raise ValueError(f"{name} is not a decodable image: the port reads PNG and JPEG files only "
                     "(OpenCV is not used)")


def imread(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8 BGR, as ``cv2.imread`` reads it."""
    with open(path, "rb") as f:
        return read_image_bytes(f.read(), path)


@TRANSFORMS.register_module()
class LoadImage:
    """The JAX transform's options: ``lazy`` is accepted and changes nothing
    (see the module); ``to_float32``, ``color_type`` and
    ``pad_to_aspect_ratio`` are set by no config and are ported only at
    their defaults (uint8 colour images, no padding)."""

    def __init__(self, to_float32: bool = False, color_type: str = "color", pad_to_aspect_ratio: bool = False,
                 lazy: bool = False):
        if to_float32 or color_type != "color" or pad_to_aspect_ratio:
            raise NotImplementedError("LoadImage: to_float32, color_type other than 'color' and "
                                      "pad_to_aspect_ratio are not ported")

    def __call__(self, results: dict) -> Optional[dict]:
        try:
            if "img" not in results:
                path = results["img_path"]
                if not isinstance(path, str):
                    raise NotImplementedError("LoadImage: multi-frame samples are not ported yet")
                with open(path, "rb") as f:
                    data = f.read()
                if is_jpeg(data):
                    info = probe(data, path)
                    results["img_bytes"] = data
                    results["jpeg_info"] = info
                    results["img"] = np.broadcast_to(np.zeros(3, np.uint8), (*info.shape, 3))
                else:
                    results["img"] = read_image_bytes(data, path)
            else:
                results.setdefault("img_path", None)
            results["img_shape"] = results["img"].shape[:2]
            results["ori_shape"] = results["img"].shape[:2]
        except Exception as e:
            raise type(e)(f"{e} occurs when loading {results.get('img_path')}") from e
        return results
