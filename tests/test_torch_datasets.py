"""The port's top-down datasets, PNG reader, val pipeline and loader against
the JAX package and OpenCV.

- ``CocoDataset``, ``CocoCropDataset`` and ``CombinedDataset`` build the JAX
  package's data lists, key by key, from ``tests/golden/e2e_coco.json``
  (and from a detector ``bbox_file``);
- the PNG reader returns ``cv2.imread``'s array bit for bit for gray, RGB and
  RGBA files written by cv2, and for gray + alpha and palette files (which
  cv2 does not write) and files with every row filter, written here;
  16-bit and non-PNG files raise;
- the val pipeline's samples carry the JAX pipeline's metainfo and GT
  instances, and the canvases and warp matrices of its canvas form;
- the canvas crop (the port's canvases, and the JAX pipeline's), warped by
  ``device_preprocess_batch``, equals the JAX val pipeline's
  ``cv2.warpAffine`` crop within one intensity unit;
- ``resize_linear`` (the canvas's downscale) equals ``cv2.resize`` within one
  unit, and a region larger than the canvas gives the JAX canvas;
- the loader yields the JAX loader's batches in the same order, in process
  and from spawned workers.
"""

import copy
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import TINY_CFG, VAL_PIPELINE, golden_png_set, write_png
from probpose_code_torch.datasets.loader import DataLoader, keep_workers, stop_workers
from probpose_code_torch.datasets.png import decode_png
from probpose_code_torch.datasets.transforms.loading import imread
from probpose_code_torch.datasets.transforms.topdown import TopdownAffine, resize_linear
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.registry import DATASETS

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def png_set(tmp_path_factory):
    return golden_png_set(tmp_path_factory.mktemp("golden_png"))[1]


def jax_build(cfg):
    import probpose_code_tpu.datasets  # noqa: F401  (registers)
    from probpose_code_tpu.registry import DATASETS as JAX_DATASETS

    return JAX_DATASETS.build(copy.deepcopy(cfg))


def assert_same(a, b, where):
    assert type(a) is type(b) or isinstance(a, np.ndarray), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def coco_cfg(kind, root, **kw):
    return dict(type=kind, data_root=str(root), ann_file="ann.json", data_prefix=dict(img="imgs/"), test_mode=True,
                **kw)


@pytest.mark.parametrize("kind", ["CocoDataset", "CocoCropDataset"])
def test_data_lists_equal_jax(png_set, kind):
    cfg = coco_cfg(kind, png_set.parent)
    ours, ref = DATASETS.build(cfg), jax_build(cfg)
    assert len(ours) == len(ref) == 62
    assert ours.metainfo["dataset_name"] == ref.metainfo["dataset_name"]
    assert_same(ours.data_list, ref.data_list, "data_list")
    for i in (0, 17, 61):
        assert_same(ours.get_data_info(i), ref.get_data_info(i), f"info {i}")


def test_detection_boxes_and_combined_dataset_equal_jax(png_set):
    rng = np.random.RandomState(0)
    dets = [dict(image_id=int(im), category_id=c, bbox=list(rng.uniform(5, 120, 4)), score=float(rng.rand()))
            for im, c in zip(rng.randint(1, 25, 30), [1] * 28 + [2, 1])]
    (png_set.parent / "dets.json").write_text(__import__("json").dumps(dets))
    det_cfg = coco_cfg("CocoDataset", png_set.parent, bbox_file=str(png_set.parent / "dets.json"))
    ours, ref = DATASETS.build(det_cfg), jax_build(det_cfg)
    assert len(ours) == 29
    assert_same(ours.data_list, ref.data_list, "detections")

    cfg = dict(type="CombinedDataset", metainfo=dict(dataset_name="coco"), test_mode=True, pipeline=[],
               datasets=[coco_cfg("CocoCropDataset", png_set.parent), coco_cfg("CocoDataset", png_set.parent)])
    ours, ref = DATASETS.build(cfg), jax_build(cfg)
    assert len(ours) == len(ref) == 124
    for i in (0, 61, 62, 123):
        assert_same(ours.get_data_info(i), ref.get_data_info(i), f"combined {i}")


def png_bytes(pixels, color, palette=None, filters=(0, 1, 2, 3, 4)):
    """An 8-bit PNG of (H, W, C) ``pixels`` in color type ``color``, row r
    filtered with ``filters[r % len(filters)]`` (the filters of the PNG
    specification, section 9)."""
    h, w, bpp = pixels.shape
    raw = pixels.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    for r in range(h):
        kind = filters[r % len(filters)]
        x, up = raw[r], raw[r - 1] if r else np.zeros_like(raw[r])
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 3:
            pred = (left + up) // 2
        elif kind == 4:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        else:
            pred = [np.zeros_like(x), left, up][kind]
        out += bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.tobytes()) + chunk(b"tRNS", bytes(range(len(palette))))
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")


def smooth_image(h, w, c, seed):
    """Gradients with noise: libpng's adaptive filtering picks every filter."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    img = (yy[..., None] * rng.uniform(1, 3, c) + xx[..., None] * rng.uniform(1, 3, c)
           + rng.randint(0, 6, (h, w, c)))
    return (img % 256).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_equals_cv2_on_cv2_files(tmp_path, channels):
    img = smooth_image(37, 53, channels, seed=channels)
    path = tmp_path / "img.png"
    assert cv2.imwrite(str(path), img[..., 0] if channels == 1 else img)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    got = imread(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("color", [0, 2, 3, 4, 6])
def test_png_reader_equals_cv2_for_every_filter(tmp_path, color):
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    rng = np.random.RandomState(color)
    pixels = smooth_image(23, 19, channels, seed=color + 10)
    palette = None
    if color == 3:
        palette = rng.randint(0, 256, (40, 3)).astype(np.uint8)
        pixels = rng.randint(0, 40, (23, 19, 1)).astype(np.uint8)
    path = tmp_path / "img.png"
    path.write_bytes(png_bytes(pixels, color, palette))
    np.testing.assert_array_equal(decode_png(path.read_bytes()), cv2.imread(str(path), cv2.IMREAD_COLOR))


def test_unread_formats_raise(tmp_path):
    bmp = tmp_path / "img.bmp"
    cv2.imwrite(str(bmp), smooth_image(8, 8, 3, 0))
    with pytest.raises(ValueError, match="PNG and JPEG files only"):
        imread(str(bmp))
    jpg = tmp_path / "img.jpg"  # read since JPEG decoding was ported (tests/test_torch_jpeg.py)
    cv2.imwrite(str(jpg), smooth_image(8, 8, 3, 0))
    np.testing.assert_array_equal(imread(str(jpg)), cv2.imread(str(jpg), cv2.IMREAD_COLOR))
    deep = tmp_path / "deep.png"
    cv2.imwrite(str(deep), smooth_image(8, 8, 3, 0).astype(np.uint16) * 200)
    with pytest.raises(ValueError, match="bit depth 16"):
        imread(str(deep))
    bad = bytearray(png_bytes(smooth_image(8, 8, 3, 0), 2))
    bad[40] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad))


def test_png_writer_round_trips(tmp_path):
    img = smooth_image(11, 7, 3, seed=5)
    write_png(tmp_path / "w.png", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "w.png")), img)


def pipeline_samples(png_set, jax, device_warp=False):
    pipeline = copy.deepcopy(VAL_PIPELINE)
    if device_warp:
        pipeline[2]["device_warp"] = True
    cfg = coco_cfg("CocoDataset", png_set.parent, pipeline=pipeline)
    ds = jax_build(cfg) if jax else DATASETS.build(cfg)
    return [ds[i] for i in range(len(ds))]


@pytest.fixture(scope="module")
def samples(png_set):
    return dict(ours=pipeline_samples(png_set, False), cv2=pipeline_samples(png_set, True),
                canvas=pipeline_samples(png_set, True, device_warp=True))


def test_pipeline_metainfo_and_canvas_equal_jax(samples):
    for ours, ref, canvas in zip(samples["ours"], samples["cv2"], samples["canvas"]):
        assert_same(ours["data_samples"].metainfo, ref["data_samples"].metainfo, "metainfo")
        gt = ref["data_samples"].gt_instances
        assert_same(dict(ours["data_samples"].gt_instances.items()),
                    {k: v for k, v in gt.items() if k != "bbox_mask"}, "gt_instances")
        for key in ("canvas", "warp_mat"):
            assert_same(ours[key], canvas[key], key)
        assert ours["inputs"] is None and "warp_separable" not in ours


@pytest.mark.parametrize("source", ["port", "jax"])
def test_canvas_crop_equals_cv2_crop(samples, source):
    """The port's canvas batch, and the JAX pipeline's (whose rotation-free
    ``canvas_sep`` the JAX builder warps by banded products), both warped by
    the port's gather, give the JAX val pipeline's cv2 crops within a unit."""
    import probpose_code_tpu.datasets.loader as jax_loader
    from probpose_code_torch.datasets.loader import collate_pose_samples

    if source == "port":
        batch = collate_pose_samples(samples["ours"])
    else:
        batch = {k.replace("_sep", ""): v for k, v in jax_loader.collate_pose_samples(samples["canvas"]).items()}
    want = jax_loader.collate_pose_samples(samples["cv2"])["inputs"]
    arrays = {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    model = PoseModel(TINY_CFG["model"], device="cpu")
    crops = model.device_preprocess_batch(arrays)["inputs"]
    assert crops.shape == want.shape == (62, 256, 192, 3)
    diff = (crops.numpy() - want.astype(np.float32)).__abs__()
    assert diff.max() <= 1.0, diff.max()


@pytest.mark.parametrize("src,dst", [((97, 131), (61, 40)), ((640, 480), (320, 240)), ((50, 70), (33, 21)),
                                     ((30, 20), (45, 31))])
def test_resize_linear_equals_cv2(src, dst):
    img = np.random.RandomState(sum(src)).randint(0, 256, (*src, 3)).astype(np.uint8)
    want = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
    got = resize_linear(img, dst)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("box", [(20.0, 30.0, 700.0, 880.0), (-50.0, 100.0, 1100.0, 400.0), (300, 10, 420, 60)])
@pytest.mark.parametrize("use_udp", [True, False])
def test_region_larger_than_canvas_gives_the_jax_canvas(box, use_udp):
    """A region beyond the 640 x 640 canvas is downscaled (and a small one
    pasted as it is), as in the JAX canvas form."""
    from probpose_code_tpu.datasets.transforms.topdown import TopdownAffine as JaxTopdownAffine

    kw = dict(input_size=(192, 256), use_udp=use_udp)
    results = dict(img=smooth_image(900, 1000, 3, seed=1), bbox_xyxy_wrt_input=np.array([box], np.float32))
    ours = TopdownAffine(**kw)(dict(results))
    ref = JaxTopdownAffine(device_warp=True, **kw)(dict(results))
    assert np.abs(ours["canvas"].astype(int) - ref["canvas"]).max() <= 1
    np.testing.assert_allclose(ours["warp_mat"], ref["warp_mat"], rtol=1e-6, atol=1e-4)
    for key in ("input_center", "input_scale", "input_size"):
        np.testing.assert_array_equal(ours[key], ref[key])


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_equal_jax(png_set, num_workers):
    import probpose_code_tpu.datasets.loader as jax_loader

    jax_pipeline = copy.deepcopy(VAL_PIPELINE)
    jax_pipeline[2]["device_warp"] = True
    ours = DataLoader(DATASETS.build(coco_cfg("CocoDataset", png_set.parent, pipeline=VAL_PIPELINE)), 24,
                      num_workers=num_workers)
    ref = list(jax_loader.DataLoader(jax_build(coco_cfg("CocoDataset", png_set.parent, pipeline=jax_pipeline)), 24,
                                     drop_last=False, num_workers=0))
    assert len(ours) == 3
    ours = list(ours)
    assert [len(b["data_samples"]) for b in ours] == [24, 24, 14]
    for a, b in zip(ours, ref):
        assert sorted(a) == ["canvas", "data_samples", "warp_mat"]
        assert {"canvas_sep", "warp_mat_sep"} <= set(b)
        assert [s.metainfo["id"] for s in a["data_samples"]] == [s.metainfo["id"] for s in b["data_samples"]]
        for k in ("canvas", "warp_mat"):
            assert_same(a[k], b[k + "_sep"], k)


def running(pid):
    try:
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_stop_workers_ends_the_servers(png_set):
    """A worker pass leaves the fork server and the resource tracker running
    for the next one; ``stop_workers`` ends and reaps both."""
    from multiprocessing import forkserver, resource_tracker

    loader = DataLoader(DATASETS.build(coco_cfg("CocoDataset", png_set.parent, pipeline=VAL_PIPELINE)), 24,
                        num_workers=2)
    assert [len(b["data_samples"]) for b in loader] == [24, 24, 14]
    servers = [forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid]
    assert all(map(running, servers))
    stop_workers()
    assert not any(map(running, servers))


def test_keep_workers_keeps_the_servers_to_its_end(png_set):
    """Inside ``keep_workers`` (nested too) a pass and its ``stop_workers``
    leave the fork server and the resource tracker running, and the next
    pass forks its workers from the same server; the outer block's end
    stops and reaps both, and a later ``stop_workers`` stops again."""
    from multiprocessing import forkserver, resource_tracker

    dataset = DATASETS.build(coco_cfg("CocoDataset", png_set.parent, pipeline=VAL_PIPELINE))
    with keep_workers():
        passes = []
        for _ in range(2):
            with keep_workers():
                loader = DataLoader(dataset, 24, num_workers=2)
                assert [len(b["data_samples"]) for b in loader] == [24, 24, 14]
                stop_workers()
            passes.append([forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid])
            assert all(map(running, passes[-1]))
        assert passes[0] == passes[1]
    assert not any(map(running, passes[0]))
    loader = DataLoader(dataset, 24, num_workers=2)
    assert [len(b["data_samples"]) for b in loader] == [24, 24, 14]
    servers = [forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid]
    assert servers != passes[0] and all(map(running, servers))
    stop_workers()
    assert not any(map(running, servers))
