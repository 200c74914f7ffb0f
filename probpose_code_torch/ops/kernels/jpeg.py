"""JPEG decode on the card, and its plain twin.

No TPU kernel is replaced: the JAX package decodes JPEG on the host with
libjpeg-turbo through OpenCV (``probpose_code_tpu/datasets/transforms/
loading.py``; ``csrc/image_pipeline.cpp`` on its opt-in ``lazy`` path), and
the card's machine has neither. ``decode_batch`` decodes a batch of JPEG
streams into one zeroed ``(B, Hmax, Wmax, 3)`` uint8 BGR tensor, image ``i``
at the top left of slot ``i`` as ``cv2.imread`` returns it (EXIF orientation
applied), the rest of the slot zero, so that the crop gather
(``ops/warp.py``) reads the same pixels and the same zero border as
``cv2.warpAffine`` over the image alone.

On the card (``probpose_code_torch/csrc/jpeg_decode.cu`` with
``jpeg_exact.cuh``), on torch's current stream: the Huffman data decoded on
``HOST_THREADS`` host threads into DCT coefficients (C++), copied to the
card from pinned memory, then two kernels written for this port:
libjpeg-turbo's integer IDCT, and its fancy upsampling, integer colour
tables and the EXIF orientation. Bit for bit the plain decoder's pixels, so
``cv2.imread``'s. nvJPEG is not a route: its IDCT and interpolation are not
libjpeg-turbo's (up to 5 grey levels off ``cv2.imread``), which moved the
golden val set's keypoints far from the JAX package's (p99 156 px on an
H100 80GB HBM3 at 700 W); its batched decode (``csrc/nvjpeg_batched.cu``)
is only the yardstick that ``chip_smoke.py`` times. On the CPU: the NumPy
decoder ``datasets/jpeg.py``.

Every stream is first walked by ``datasets.jpeg.probe`` on the host (the
loader's workers do it, and ship the result as ``infos``): a stream that is
truncated or of a kind the plain decoder refuses raises ``ValueError``
naming its file on either device. A CPU tensor goes to the plain decoder,
a CUDA tensor to the card; there is no fallback from one to the other, and
a failure on the card raises with the file's name and the CUDA error.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from probpose_code_torch.datasets.jpeg import JpegInfo, probe
from probpose_code_torch.datasets.jpeg import decode as decode_plain

from . import _build

_int_p = ctypes.POINTER(ctypes.c_int)
_i64_p = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "jpeg_exact_decode_host": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_void_p), _i64_p, _int_p, ctypes.c_char_p, ctypes.c_int],
    "jpeg_exact_fill": [ctypes.c_void_p] * 5,
    "jpeg_exact_render": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                                                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p],
    "jpeg_decode_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
# jpeg_exact.cuh's descriptor widths (int64 fields a plane, an image)
PLANE_FIELDS, IMAGE_FIELDS = 7, 10
# host threads for the Huffman decode
HOST_THREADS = min(8, os.cpu_count() or 1)


def _library() -> ctypes.CDLL:
    return _build.load("jpeg_decode", _SIGNATURES)


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: JPEG decode on the card failed: CUDA error {code - 1000} "
                           f"({_library().jpeg_decode_error_string(code - 1000).decode()})")


def entropy_decode(datas: Sequence[bytes], names: Sequence[str],
                   threads: int = HOST_THREADS) -> Tuple[Dict[str, torch.Tensor], Tuple[int, int, int, int]]:
    """The host half: the streams' Huffman data decoded on ``threads`` host
    threads into pinned buffers (``coef``, ``quant``, ``pd``, ``im``: the
    coefficients, quantization tables and descriptors of ``jpeg_exact.cuh``);
    returns them and the totals (coefficients, plane bytes, planes, blocks).
    A stream it refuses raises ``ValueError`` naming its file."""
    lib = _library()
    n = len(datas)
    batch, totals = ctypes.c_void_p(), (ctypes.c_int64 * 4)()
    bad, msg = ctypes.c_int(-1), ctypes.create_string_buffer(512)
    if lib.jpeg_exact_decode_host(n, (ctypes.c_char_p * n)(*datas), (ctypes.c_size_t * n)(*[len(d) for d in datas]),
                                  threads, ctypes.byref(batch), totals, ctypes.byref(bad), msg, len(msg)):
        raise ValueError(f"{names[bad.value]}: {msg.value.decode()}")
    coefs, pix, planes, blocks = totals
    host = dict(coef=torch.empty(coefs, dtype=torch.int16, pin_memory=True),
                quant=torch.empty((planes, 64), dtype=torch.int32, pin_memory=True),
                pd=torch.empty((planes, PLANE_FIELDS), dtype=torch.int64, pin_memory=True),
                im=torch.empty((n, IMAGE_FIELDS), dtype=torch.int64, pin_memory=True))
    lib.jpeg_exact_fill(batch, *[_build.ptr(t) for t in host.values()])
    return host, (coefs, pix, planes, blocks)


def _card_decode(datas: Sequence[bytes], names: Sequence[str], out: torch.Tensor) -> None:
    """The host half, the coefficients to the card from pinned memory, then
    the IDCT and pixel kernels into ``out``."""
    host, (_, pix, planes, blocks) = entropy_decode(datas, names)
    dev = {k: t.to(out.device, non_blocking=True) for k, t in host.items()}
    pixels = torch.empty(pix, dtype=torch.uint8, device=out.device)
    with torch.cuda.device(out.device):
        code = _library().jpeg_exact_render(
            _build.ptr(dev["coef"]), _build.ptr(dev["quant"]), _build.ptr(dev["pd"]), planes, blocks,
            _build.ptr(pixels), _build.ptr(dev["im"]), len(datas), _build.ptr(out), out.shape[1], out.shape[2],
            _build.stream_of(out))
    _check(code, ", ".join(names))


def decode_batch(datas: Sequence[bytes], device, names: Optional[Sequence[str]] = None,
                 infos: Optional[Sequence[JpegInfo]] = None) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """Decode JPEG streams on ``device`` into a new zeroed (B, Hmax, Wmax, 3)
    uint8 BGR tensor; returns it and each image's (h, w). ``names`` name
    the streams in errors (their files); ``infos`` are their ``probe``
    results where the caller has them (else they are probed here)."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_batch: unsupported device {device}")
    datas = [bytes(d) for d in datas]
    names = list(names) if names is not None else [f"JPEG stream {i}" for i in range(len(datas))]
    if infos is None:
        infos = [probe(d, n) for d, n in zip(datas, names)]
    shapes = [info.shape for info in infos]
    out = torch.zeros((len(datas), max(h for h, _ in shapes), max(w for _, w in shapes), 3), dtype=torch.uint8,
                      device=device)
    if device.type == "cpu":
        for i, (d, n) in enumerate(zip(datas, names)):
            img = decode_plain(d, n)
            out[i, :img.shape[0], :img.shape[1]] = torch.from_numpy(img)
        return out, shapes
    _card_decode(datas, names, out)
    decode_batch.launches += 1
    return out, shapes


decode_batch.launches = 0


def decode_bytes(data: bytes, device, name: str = "request body") -> torch.Tensor:
    """One JPEG stream as an (H, W, 3) uint8 BGR tensor on ``device``."""
    img, ((h, w),) = decode_batch([data], device, [name])
    return img[0, :h, :w]
