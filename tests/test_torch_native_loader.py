"""The port's binding of the native decode pool (`utils/native_loader.py`)
and the native branch of `FileDataset`, against the JAX package's binding
and the port's Python reader, on files the tests write.

Exact throughout: PNG is lossless and both bindings call the same library,
so a frame is the same bytes whichever decodes it; undistortion follows on
the same numpy arithmetic. JPEG: the pool's frames equal the JAX package's
native frames (the same libjpeg), not Pillow's, which may round otherwise.
ScanNet (float TIFF depth) and ScanNet++ (its own resizing `_load_raw`)
keep the Python reader. The library: the tracked `native/libloader.so`, or
`native/loader.cpp` built into the port's build directory when that does
not load (skipped without g++ or the libjpeg / libpng headers), or none.
"""
import os
import shutil

import numpy as np
import pytest
from PIL import Image
from test_torch_datasets import FR1_DIST, _cfg, _frames, _write_scannetpp

from eags_slam_tpu import datasets as J
from eags_slam_tpu.utils import native_loader as jn
from eags_slam_torch import datasets as T
from eags_slam_torch.utils import native_loader as tn
from eags_slam_torch.utils.layouts import (write_replica, write_scannet,
                                           write_tum)


@pytest.fixture(autouse=True)
def native_library():
    """Skip where the library neither loads nor builds (decided when a test
    runs, not when the module is imported)."""
    if tn.status()["native"] is None:
        pytest.skip("native loader neither loads nor builds on this host")


class Python(T.TUM_RGBD):
    """The TUM reader on the Python preloader (its own `_load_raw`)."""

    def _load_raw(self, idx):
        return T.FileDataset._load_raw(self, idx)


def _frames_of(ds):
    ds.start_prefetch()
    try:
        return [ds.get_origin_image(i) for i in range(len(ds))], ds.report()
    finally:
        ds.close()


@pytest.mark.parametrize("dist", [None, FR1_DIST], ids=["plain", "fr1_lens"])
def test_png_frames_equal_python_reader_and_jax(tmp_path, dist):
    seq = _frames(6, seed=11)
    write_tum(tmp_path, *seq, filters=np.arange(seq[0].shape[1]) % 5)
    cfg = _cfg(tmp_path, depth_scale=5000.0, crop_edge=2)
    if dist is not None:
        cfg["cam"]["distortion"] = list(dist)
    native, rep = _frames_of(T.TUM_RGBD(cfg))
    python, rep_py = _frames_of(Python(cfg))
    assert rep["reader"] == "native" and rep["decode_ms_avg"] is None
    assert rep["native"]["native"] == tn.status()["native"]
    assert rep_py["reader"] == "python" and rep_py["decoded"] >= 6
    jds = J.TUM_RGBD(cfg)
    jds.start_prefetch()
    try:
        assert jds._native is not None   # the JAX reader's native path
        for i, ((c, d), (cp, dp)) in enumerate(zip(native, python)):
            np.testing.assert_array_equal(c, cp)
            np.testing.assert_array_equal(d, dp)
            jc, jd = jds.get_origin_image(i)
            np.testing.assert_array_equal(c, jc)
            np.testing.assert_array_equal(d, jd)
    finally:
        jds.close()


def test_binding_equals_jax_binding(tmp_path):
    """Both bindings on the same files, read out of order (an evicted
    frame is decoded again)."""
    seq = _frames(5, seed=12)
    write_tum(tmp_path, *seq)
    ds = T.TUM_RGBD(_cfg(tmp_path, depth_scale=5000.0))
    cp, dp = ds.color_paths, ds.depth_paths
    t = tn.try_create(cp, dp, 5000.0, readahead=2)
    j = jn.try_create(cp, dp, 5000.0, readahead=2)
    assert t is not None and j is not None
    try:
        assert (t.width, t.height) == (j.width, j.height) == (64, 48)
        for i in (0, 3, 1, 4, 0):
            for a, b in zip(t.get(i), j.get(i)):
                np.testing.assert_array_equal(a, b)
    finally:
        t.close()
        j.close()


def test_jpeg_frames_equal_jax_native(tmp_path):
    seq = _frames(4, seed=13)
    write_replica(tmp_path, *seq, depth_scale=6553.5, quality=90)
    cfg = _cfg(tmp_path, depth_scale=6553.5)
    native, rep = _frames_of(T.Replica(cfg))
    assert rep["reader"] == "native"
    jds = J.Replica(cfg)
    jds.start_prefetch()
    try:
        assert jds._native is not None
        for i, (c, d) in enumerate(native):
            jc, jd = jds.get_origin_image(i)
            np.testing.assert_array_equal(c, jc)
            np.testing.assert_array_equal(d, jd)
            # JPEG decoders may round a few values otherwise.
            ref = np.asarray(Image.open(jds.color_paths[i]))
            assert np.abs(c.astype(int) - ref.astype(int)).mean() < 2.0
    finally:
        jds.close()


def test_tiff_and_scannetpp_take_python_reader(tmp_path):
    seq = _frames(3, seed=14)
    write_scannet(tmp_path / "scannet", *seq)
    _, rep = _frames_of(T.ScanNet(_cfg(tmp_path / "scannet")))
    assert rep["reader"] == "python" and rep["native"] is None
    assert rep["decoded"] >= 3
    _write_scannetpp(tmp_path / "pp")
    cfg = _cfg(tmp_path / "pp")
    cfg["cam"].update({"H": 480, "W": 640})
    _, rep = _frames_of(T.ScanNetPP(cfg))
    assert rep["reader"] == "python" and rep["native"] is None


@pytest.fixture
def fresh_status(monkeypatch, tmp_path):
    """A binding that has not loaded yet, whose tracked library is an
    unloadable file and whose build directory is the test's."""
    bogus = tmp_path / "libloader.so"
    bogus.write_bytes(b"not an ELF file")
    monkeypatch.setattr(tn, "TRACKED", bogus)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tn, "_status", {})
    monkeypatch.setattr(tn, "_lib", None)
    return tmp_path


def test_builds_when_tracked_library_does_not_load(fresh_status):
    if shutil.which("g++") is None or not (
            os.path.exists("/usr/include/jpeglib.h")
            and os.path.exists("/usr/include/png.h")):
        pytest.skip("no g++ or no libjpeg / libpng headers")
    st = tn.status()
    assert st["native"] == "built" and "tracked" in st["errors"]
    built = list((fresh_status / "build").glob("libloader_*.so"))
    assert len(built) == 1
    seq = _frames(2, seed=15)
    write_tum(fresh_status / "seq", *seq)
    frames, rep = _frames_of(T.TUM_RGBD(_cfg(fresh_status / "seq",
                                             depth_scale=5000.0)))
    assert rep["reader"] == "native" and rep["native"]["native"] == "built"
    python, _ = _frames_of(Python(_cfg(fresh_status / "seq",
                                       depth_scale=5000.0)))
    for (c, d), (cp, dp) in zip(frames, python):
        np.testing.assert_array_equal(c, cp)
        np.testing.assert_array_equal(d, dp)


def test_python_reader_when_nothing_loads(fresh_status, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    st = tn.status()
    assert st["native"] is None and set(st["errors"]) == {"tracked", "built"}
    seq = _frames(2, seed=16)
    write_tum(fresh_status / "seq", *seq)
    cfg = _cfg(fresh_status / "seq", depth_scale=5000.0)
    assert tn.try_create(T.TUM_RGBD(cfg).color_paths,
                         T.TUM_RGBD(cfg).depth_paths, 5000.0) is None
    _, rep = _frames_of(T.TUM_RGBD(cfg))
    assert rep["reader"] == "python" and rep["native"]["native"] is None
    assert rep["decoded"] >= 2
