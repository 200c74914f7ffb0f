"""The port's JPEG probe and plain decoder against OpenCV and the JAX
package's native probe, and the decode wrapper on the CPU.

Fixtures: ``tests/golden_torch/`` (made by ``make_jpeg_fixtures.py`` with
``cv2.imencode``): eight small format fixtures (4:4:4, 4:2:2, 4:4:0,
grayscale, progressive, restart intervals, EXIF orientations 6 and 8), a
truncated stream, and the golden fixture's 24 images as 4:2:0 baseline.

- ``datasets/jpeg.py:decode`` equals ``cv2.imread`` (and ``cv2.imdecode``,
  which applies EXIF orientation in this OpenCV too) bit for bit on every
  format fixture and on three golden JPEGs, and on streams made here at
  other qualities and sizes;
- ``probe`` gives ``native_decode.probe``'s (width, height, orientation)
  where the JAX package's native library builds, else ``cv2.imread``'s
  shape;
- what the decoder refuses raises ``ValueError`` naming the file;
- ``ops/kernels/jpeg.py:decode_batch`` on the CPU fills a zeroed buffer,
  one image a slot at its top left.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from probpose_code_torch.datasets import jpeg
from probpose_code_torch.models.builder import StageClock
from probpose_code_torch.ops.kernels.jpeg import decode_batch, decode_bytes

FIXTURES = Path(__file__).resolve().parent / "golden_torch"
FORMATS = ["444", "422", "440", "gray", "progressive", "restart", "exif6", "exif8"]
GOLDEN = ["1", "12", "24"]


def fixture(name: str) -> Path:
    return FIXTURES / ("formats" if name in FORMATS + ["truncated"] else "golden") / f"{name}.jpg"


@pytest.mark.parametrize("name", FORMATS + GOLDEN)
def test_decoder_equals_cv2(name):
    path = fixture(name)
    data = path.read_bytes()
    ours = jpeg.decode(data, str(path))
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))


@pytest.mark.parametrize("quality", [30, 75, 100])
@pytest.mark.parametrize("sampling", ["420", "422", "440", "444"])
def test_decoder_equals_cv2_at_other_qualities(quality, sampling):
    """Streams made here from a noisy image of an odd size (edge blocks and
    half chroma columns), baseline and progressive."""
    rng = np.random.RandomState(quality)
    img = cv2.GaussianBlur(rng.randint(0, 256, (37, 45, 3)).astype(np.uint8), (3, 3), 0)
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    for progressive in (0, 1):
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                             factor, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
        np.testing.assert_array_equal(jpeg.decode(buf.tobytes()), cv2.imdecode(buf, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("name", FORMATS + GOLDEN)
def test_probe_equals_jax_probe(name):
    from probpose_code_tpu.datasets import native_decode

    data = fixture(name).read_bytes()
    info = jpeg.probe(data)
    assert info.shape == cv2.imread(str(fixture(name)), cv2.IMREAD_COLOR).shape[:2]
    assert info.progressive == (name == "progressive")
    assert info.components == (1 if name == "gray" else 3)
    ref = native_decode.probe(data)
    if ref is not None:  # where the JAX package's native library builds
        assert (info.width, info.height, info.orientation) == ref


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` past the first ``marker`` set."""
    pos = data.index(bytes([0xFF, marker]))
    return data[:pos + offset] + bytes([value]) + data[pos + offset + 1:]


@pytest.mark.parametrize("case, match", [
    ("truncated", "truncated"),
    ("arithmetic", "arithmetic coding"),
    ("lossless", "lossless"),
    ("12-bit", "12-bit"),
    ("cmyk", "4 components"),
    ("not a jpeg", "not a JPEG"),
    ("headers only", "no EOI"),
])
def test_refused_streams_raise_naming_the_file(case, match):
    data = fixture("restart").read_bytes()
    if case == "truncated":
        data = fixture("truncated").read_bytes()
    elif case == "arithmetic":
        data = data.replace(b"\xff\xc0", b"\xff\xc9", 1)
    elif case == "lossless":
        data = data.replace(b"\xff\xc0", b"\xff\xc3", 1)
    elif case == "12-bit":
        data = _patched(data, 0xC0, 4, 12)
    elif case == "cmyk":
        data = _patched(data, 0xC0, 9, 4)
    elif case == "not a jpeg":
        data = b"GIF89a" + data
    else:
        data = data[:data.index(b"\xff\xda")]
    for call in (jpeg.probe, jpeg.decode):
        with pytest.raises(ValueError, match=match) as err:
            call(data, "some/file.jpg")
        assert "some/file.jpg" in str(err.value)
    with pytest.raises(ValueError, match=match):
        decode_batch([data], "cpu", ["some/file.jpg"])


def test_decode_batch_fills_zeroed_slots():
    names = ["exif6", "1", "gray"]
    datas = [fixture(n).read_bytes() for n in names]
    out, shapes = decode_batch(datas, "cpu", names)
    assert shapes == [(120, 90), (295, 304), (87, 113)]
    assert out.shape == (3, 295, 304, 3) and out.dtype == torch.uint8
    for i, (h, w) in enumerate(shapes):
        np.testing.assert_array_equal(out[i, :h, :w].numpy(), jpeg.decode(datas[i]))
        assert not out[i, h:].any() and not out[i, :, w:].any()
    np.testing.assert_array_equal(decode_bytes(datas[0], "cpu").numpy(), jpeg.decode(datas[0]))
    clock = StageClock("decode")
    with clock.span(torch.device("cpu")):
        decode_bytes(datas[2], "cpu")
    first = clock.take()
    assert first["decode"] > 0 and first["decode_host"] == first["decode"]  # one clock on the CPU
    assert clock.take() == dict(decode=0.0, decode_host=0.0)


def test_decode_batch_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        decode_batch([fixture("1").read_bytes()], "meta")
