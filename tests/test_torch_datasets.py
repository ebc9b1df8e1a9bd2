"""The port's readers against the JAX package's, on the same files: twins of
tests/test_datasets.py and of the reader halves of
tests/test_reader_roundtrip.py, plus ScanNet (PNG colour, float TIFF depth,
crop 10) and ScanNet++ (a small transforms_undistorted.json, JPEG colour,
16-bit PNG depth, test_frames).

Tolerances: colour after undistortion, depth and the crop are exact (the
same numpy arithmetic on the same decoded bytes); poses to 1e-12 (the same
float64 formulas); timestamps exact. The port's `frame` / `frame_u8` on
the CPU equal its host frames exactly. The preloader: out-of-order reads,
an evicted frame read again from a second thread, close() while it
runs, and a frame the preloader cannot decode (JPEG without Pillow, a
palette PNG) raising to the reader, naming the file, within a time limit.
These tests hold the Python preloader: the native decode pool, which
`start_prefetch` takes first for these formats where its library loads,
is kept out of them (`python_preloader`) and tested in
tests/test_torch_native_loader.py.
"""
import json
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from eags_slam_tpu import datasets as J
from eags_slam_torch import datasets as T
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.utils.layouts import (write_replica, write_scannet,
                                           write_tum)

H, W = 48, 64


@pytest.fixture(autouse=True)
def python_preloader(monkeypatch):
    """start_prefetch finds no native pool: the Python preloader runs."""
    from eags_slam_torch.utils import native_loader

    monkeypatch.setattr(native_loader, "try_create", lambda *a, **k: None)
FR1_DIST = np.array([0.262383, -0.953104, -0.005358, 0.002628, 1.163314])


def _frames(n, seed=0, h=H, w=W):
    """Seeded smooth colour with texture, depth in 0.5-4.5 m with holes,
    and poses on a small arc."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    colors, depths, poses = [], [], []
    for i in range(n):
        c = np.stack([0.5 + 0.35 * np.sin(u / (5 + k) + i + 2 * k)
                      * np.cos(v / (7 - k)) for k in range(3)], -1)
        c = c + rng.normal(0, 0.03, c.shape)
        colors.append(np.clip(c * 255 + 0.5, 0, 255).astype(np.uint8))
        d = 0.5 + 4.0 * rng.random((h, w))
        d[rng.random((h, w)) < 0.05] = 0.0
        depths.append(d.astype(np.float32))
        a = 0.05 * i
        p = np.eye(4)
        p[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        p[:3, 3] = [0.1 * i, 0.02 * i, -0.05 * i]
        poses.append(p)
    return np.stack(colors), np.stack(depths), np.stack(poses)


def _cfg(root, **cam):
    c = {"H": H, "W": W, "fx": 50.0, "fy": 52.0, "cx": 31.3, "cy": 23.8,
         "depth_scale": 1000.0, "crop_edge": 0}
    c.update(cam)
    return {"cam": c, "data": {"input_path": str(root), "prefetch": 2,
                               "frame_rate": 32},
            "frame_limit": -1, "device": "cpu"}


def _assert_same(jds, tds):
    """Length, camera, crop, poses (1e-12), timestamps, and every frame:
    the cropped float frame, the uncropped uint8 origin frame, and the
    port's device frames equal to its host frames."""
    assert len(jds) == len(tds) > 0
    assert tuple(jds.camera) == tuple(tds.camera)
    assert tuple(jds.full_camera) == tuple(tds.full_camera)
    assert jds.crop_edge == tds.crop_edge
    assert jds.timestamps == tds.timestamps
    for i in range(len(jds)):
        np.testing.assert_allclose(np.asarray(tds.poses[i]),
                                   np.asarray(jds.poses[i]), atol=1e-12,
                                   rtol=0)
        ji, jc, jd, jp = jds[i]
        ti, tc, td, tp = tds[i]
        assert ji == ti and tc.dtype == np.float32 and td.dtype == np.float32
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_allclose(tp, jp, atol=1e-12, rtol=0)
        jr, jdd = jds.get_origin_image(i)
        tr, tdd = tds.get_origin_image(i)
        assert tr.dtype == np.uint8 and tr.shape == (H, W, 3)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tdd, jdd)
        color, depth = tds.frame(i)
        np.testing.assert_array_equal(color.numpy(), tc)
        np.testing.assert_array_equal(depth.numpy(), td)
        rgb8, depth_full = tds.frame_u8(i)
        assert rgb8.dtype == torch.uint8 and depth_full.dtype == torch.float32
        np.testing.assert_array_equal(rgb8.numpy(), tr)
        np.testing.assert_array_equal(depth_full.numpy(), tdd)


@pytest.fixture(scope="module")
def seq():
    return _frames(5)


@pytest.mark.parametrize("crop", [0, 3])
def test_replica_matches_jax(tmp_path, seq, crop):
    colors, depths, poses = seq
    write_replica(tmp_path, colors, depths, poses, depth_scale=6553.5)
    cfg = _cfg(tmp_path, depth_scale=6553.5, crop_edge=crop)
    _assert_same(J.Replica(cfg), T.Replica(cfg))
    tds = T.Replica(cfg)
    assert tds.camera == Camera(50.0, 52.0, 31.3 - crop, 23.8 - crop,
                                W - 2 * crop, H - 2 * crop)
    # 16-bit depth at 6553.5: a quantisation step of 0.15 mm.
    np.testing.assert_allclose(tds.get_origin_image(2)[1], depths[2],
                               atol=1.0 / 6553.5)


def _write_tum(root, seq, **kw):
    colors, depths, poses = seq
    write_tum(root, colors, depths, poses, depth_dt=0.012, gt_dt=0.004,
              filters=np.arange(H) % 5, orphan_after=5.0, **kw)
    # A frame 10 ms after frame 1: under the 1/32 s gap, it is skipped.
    t = 100.0 + 1 / 30.0 + 0.01
    Image.fromarray(colors[0]).save(root / "rgb" / f"{t:.6f}.png")
    with open(root / "rgb.txt", "a") as f:
        f.write(f"{t:.6f} rgb/{t:.6f}.png\n")


@pytest.mark.parametrize("crop,dist", [
    (0, None), (4, [0.04, -0.02, 0.0, 0.0, 0.0]), (6, FR1_DIST.tolist())])
def test_tum_matches_jax(tmp_path, seq, crop, dist):
    _write_tum(tmp_path, seq)
    cfg = _cfg(tmp_path, depth_scale=5000.0, crop_edge=crop)
    if dist is not None:
        cfg["cam"]["distortion"] = dist
    jds, tds = J.TUM_RGBD(cfg), T.TUM_RGBD(cfg)
    # The orphan (no ground truth within 0.08 s) and the frame under the
    # frame-rate gap are both rejected.
    assert len(tds) == len(seq[0])
    _assert_same(jds, tds)
    # Poses are relative to the first frame.
    np.testing.assert_allclose(tds.poses[0], np.eye(4), atol=1e-9)
    np.testing.assert_allclose(
        tds.poses[3], np.linalg.inv(seq[2][0]) @ seq[2][3], atol=1e-8)
    if dist is None:
        np.testing.assert_array_equal(tds.get_origin_image(1)[0], seq[0][1])


def test_scannet_matches_jax(tmp_path):
    seq = _frames(4, seed=3)
    write_scannet(tmp_path, *seq)
    cfg = _cfg(tmp_path, crop_edge=10)
    jds, tds = J.ScanNet(cfg), T.ScanNet(cfg)
    _assert_same(jds, tds)
    assert tds.camera.width == W - 20 and tds.camera.height == H - 20
    # Float TIFF depth is metric and exact.
    np.testing.assert_array_equal(tds.get_origin_image(1)[1], seq[1][1])
    np.testing.assert_array_equal(tds.get_origin_image(1)[0], seq[0][1])


def _write_scannetpp(root, n=4, w=160, h=120):
    seq = _frames(n, seed=5, h=h, w=w)
    nerf = root / "dslr" / "nerfstudio"
    img = root / "dslr" / "undistorted_images"
    dep = root / "dslr" / "undistorted_depths"
    for d in (nerf, img, dep):
        d.mkdir(parents=True)
    frames = []
    for i in range(n):
        name = f"DSC{i:05d}.JPG"
        Image.fromarray(seq[0][i]).save(img / name, quality=95)
        Image.fromarray(np.clip(seq[1][i] * 1000 + 0.5, 0, 65535).astype(
            np.uint16)).save(dep / name.replace(".JPG", ".png"))
        frames.append({"file_path": f"images/{name}",
                       "transform_matrix": seq[2][i].tolist()})
    # Listed out of order: the reader sorts by file path.
    meta = {"w": w, "h": h, "fl_x": 150.0, "fl_y": 151.0, "cx": 79.2,
            "cy": 60.1, "frames": frames[::-1], "test_frames": [1, 3]}
    (nerf / "transforms_undistorted.json").write_text(json.dumps(meta))
    return seq


def test_scannetpp_matches_jax(tmp_path):
    seq = _write_scannetpp(tmp_path)
    cfg = _cfg(tmp_path)
    cfg["cam"].update({"H": 480, "W": 640})
    jds, tds = J.ScanNetPP(cfg), T.ScanNetPP(cfg)
    assert tds.test_ids == jds.test_ids == {1, 3}
    assert tds.full_camera == Camera(150.0 * 4, 151.0 * 4, 79.2 * 4,
                                     60.1 * 4, 640, 480)
    assert len(tds) == len(jds) == 4
    assert tuple(jds.camera) == tuple(tds.camera)
    for i in range(4):
        # OpenGL -> OpenCV: the y and z axes flip.
        np.testing.assert_allclose(
            tds.poses[i], seq[2][i] @ np.diag([1.0, -1, -1, 1]), atol=1e-12)
        np.testing.assert_allclose(tds.poses[i], jds.poses[i], atol=1e-12)
        jr, jd = jds._load_raw(i)
        tr, td = tds.get_origin_image(i)
        assert tr.shape == (480, 640, 3) and td.shape == (480, 640)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(td, jd)


def test_get_dataset_names():
    assert T.get_dataset("replica") is T.Replica
    assert T.get_dataset("TUM_RGBD".lower()) is T.TUM_RGBD
    assert T.get_dataset("scannet") is T.ScanNet
    assert T.get_dataset("scannetpp") is T.ScanNetPP
    assert T.get_dataset("synthetic") is T.Synthetic
    assert T.get_dataset("synthetic_hard").__name__ == "SyntheticHard"
    with pytest.raises(KeyError):
        T.get_dataset("nope")


def test_undistort_helpers_match_jax():
    rng = np.random.default_rng(0)
    xy = rng.normal(0, 0.4, (200, 2))
    np.testing.assert_array_equal(T.distort_points(xy, FR1_DIST),
                                  J.distort_points(xy, FR1_DIST))
    cam = Camera(130.0, 131.0, 79.5, 59.5, 160, 120)
    tm = T.undistort_maps(cam, FR1_DIST)
    jm = J.undistort_maps(cam, FR1_DIST)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    np.testing.assert_array_equal(T.remap_bilinear(img, *tm),
                                  J.remap_bilinear(img, *jm))


def test_synthetic_crop(tmp_path):
    """crop_edge applies to the synthetic scenes too: frame() is the
    uncropped device frame cropped, the camera the cropped camera."""
    from eags_slam_torch.config import load_config

    cfg = load_config("configs/synthetic/tiny.yaml")
    cfg["device"] = "cpu"
    cfg["data"].update({"dataset_name": "synthetic_hard", "n_frames": 2})
    full = T.get_dataset("synthetic_hard")(cfg)
    cfg["cam"]["crop_edge"] = 5
    cropped = T.get_dataset("synthetic_hard")(cfg)
    assert cropped.camera == full.camera.crop(5)
    c_full, d_full = full.frame(1)
    c, d = cropped.frame(1)
    torch.testing.assert_close(c, c_full[5:-5, 5:-5], rtol=0, atol=0)
    torch.testing.assert_close(d, d_full[5:-5, 5:-5], rtol=0, atol=0)
    rgb8, depth = cropped.frame_u8(1)
    assert tuple(rgb8.shape) == (full.full_camera.height,
                                 full.full_camera.width, 3)
    _, hc, hd, _ = cropped[1]
    np.testing.assert_array_equal(hc, c.numpy())
    np.testing.assert_array_equal(hd, d.numpy())


@pytest.fixture
def tum_ds(tmp_path):
    seq = _frames(12, seed=7)
    write_tum(tmp_path, *seq)
    cfg = _cfg(tmp_path, depth_scale=5000.0, crop_edge=2)
    ds = T.TUM_RGBD(cfg)
    yield ds, T.TUM_RGBD(cfg)
    ds.close()


def test_preloader_out_of_order_and_evicted(tum_ds):
    """Reads in any order through the running preloader equal direct
    decodes; an evicted frame is decoded again, here from a second thread
    while the first reads on."""
    ds, ref = tum_ds
    ds.start_prefetch()
    want = {i: ref[i] for i in range(len(ref))}
    for i in (0, 5, 3, 11, 7):
        got = ds[i]
        np.testing.assert_array_equal(got[1], want[i][1])
        np.testing.assert_array_equal(got[2], want[i][2])
    assert 0 not in ds._cache and ds._loaded_until >= 10
    errors, seen = [], []

    def reader(ids):
        try:
            for i in ids:
                _, c, d, _ = ds[i]
                assert np.array_equal(c, want[i][1])
                assert np.array_equal(d, want[i][2])
                seen.append(i)
        except AssertionError as e:          # reported in the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        th = threading.Thread(target=reader, args=([0, 1, 2, 0],))
        th.start()
        reader([8, 9, 10, 11])
        th.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not th.is_alive() and not errors
    assert sorted(seen) == [0, 0, 1, 2, 8, 9, 10, 11]
    rep = ds.report()
    assert rep["decoded"] >= len(ds) and rep["decode_ms_avg"] > 0


def test_preloader_close_while_running(tmp_path):
    """close() cancels a preloader that is blocked on its bound (nothing
    reads) and leaves no thread; reads after it decode directly."""
    seq = _frames(30, seed=8)
    write_tum(tmp_path, *seq)
    ds = T.TUM_RGBD(_cfg(tmp_path, depth_scale=5000.0))
    ds.start_prefetch()
    th = ds._thread
    for _ in range(200):
        if ds._loaded_until >= 4:
            break
        threading.Event().wait(0.05)
    ds.close()
    assert ds._thread is None and not th.is_alive()
    assert ds._loaded_until < len(ds) - 1
    _, c, _, _ = ds[len(ds) - 1]
    np.testing.assert_array_equal(
        np.clip(c * 255 + 0.5, 0, 255).astype(np.uint8), seq[0][-1])


REPO = pathlib.Path(__file__).resolve().parents[1]

_NO_PIL_PRELOAD = """
import importlib.abc, json, sys
class _NoPil(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("Pillow hidden")
sys.meta_path.insert(0, _NoPil())
from eags_slam_torch import datasets as T
from eags_slam_torch.utils import native_loader
native_loader.try_create = lambda *a, **k: None   # the Python preloader
ds = T.Replica(json.loads(sys.argv[1]))
ds.start_prefetch()
try:
    ds.frame(0)
except ImportError as e:
    print("RAISED", e)
ds.close()
"""


def test_preloader_raises_jpeg_without_pillow(tmp_path, seq):
    """A Replica run on a host without Pillow: the preloader's JPEG decode
    fails, and the first read raises the ImportError naming the .jpg (it
    used to wait for the dead thread forever)."""
    colors, depths, poses = seq
    write_replica(tmp_path, colors, depths, poses, depth_scale=6553.5)
    cfg = _cfg(tmp_path, depth_scale=6553.5)
    res = subprocess.run([sys.executable, "-c", _NO_PIL_PRELOAD,
                          json.dumps(cfg)], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    jpg = tmp_path / "results" / "frame000000.jpg"
    assert "RAISED" in res.stdout and str(jpg) in res.stdout
    assert "JPEG needs Pillow" in res.stdout


def _within(fn, timeout=60.0):
    """fn() in a thread: its result or its exception, failing the test if it
    has not returned within `timeout` seconds."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:           # handed to the test thread
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"no answer within {timeout} s"
    return out


def test_preloader_raises_on_palette_png(tmp_path):
    """A TUM sequence whose third colour frame is a palette PNG: the frames
    before it read, and that frame and every later one raise the decoder's
    ValueError naming the file instead of waiting on the stopped
    preloader."""
    seq = _frames(6, seed=9)
    write_tum(tmp_path, *seq)
    ds = T.TUM_RGBD(_cfg(tmp_path, depth_scale=5000.0))
    bad = ds.color_paths[2]
    Image.fromarray(seq[0][2]).convert("P").save(bad)
    ds.start_prefetch()
    try:
        for i in (0, 1):
            got = _within(lambda: ds.frame(i))
            assert "error" not in got, got.get("error")
        for i in (2, 4):
            got = _within(lambda: ds.frame(i))
            assert isinstance(got.get("error"), ValueError), got
            assert str(bad) in str(got["error"])
            assert "palette" in str(got["error"])
    finally:
        ds.close()
