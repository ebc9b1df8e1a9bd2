"""The benchmark's frozen copies against the originals they were copied
from, at small sizes on the CPU: the scene against the program's
`synthetic_hard`, the operation count against `chip_smoke.py`'s, and the
layout writers against the program's readers."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import layouts, reference, scene, traffic, yardstick

CAM = {"fx": 60.0, "fy": 60.0, "cx": 47.5, "cy": 31.5, "W": 96, "H": 64}
NOISE = {"depth_noise": 0.002, "depth_dropout": 0.003, "exposure_amp": 0.08}


@pytest.mark.parametrize("seed", [0, 3_000_000_019])
def test_scene_equals_synthetic_hard(seed):
    from eags_slam_torch.synthetic_hard import SyntheticHard

    n = 5
    cfg = {"cam": {"fx": CAM["fx"], "fy": CAM["fy"], "cx": CAM["cx"],
                   "cy": CAM["cy"], "W": CAM["W"], "H": CAM["H"]},
           "data": {"n_frames": n, "orbit_speed": 1.0 / 48.0, **NOISE},
           "seed": seed}
    ds = SyntheticHard(cfg, device="cpu")
    poses = scene.orbit_poses(n, 1.0 / 48.0)
    for i in range(n):
        rgb, depth = scene.render_frame(i, poses[i], CAM, n, seed, NOISE,
                                        "cpu")
        want_rgb, want_depth = ds.frame_u8(i)
        assert np.array_equal(rgb, want_rgb.numpy())
        assert np.array_equal(depth, want_depth.numpy())
        assert np.array_equal(poses[i], ds.poses[i])


def _smoke():
    import importlib.util

    from perfbench.tests.tiny import ROOT

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dense,block", [(False, 256), (True, 7)])
def test_work_ops_bound_equal_chip_smoke(dense, block, monkeypatch):
    """The count from K1's inputs equals `chip_smoke.py`'s count from the
    K1 twin's outputs: sparse tiles that run every chunk, and dense opaque
    ones that stop early, counted in blocks of tiles."""
    from eags_slam_torch.core.camera import Camera
    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.ops.rasterizer import (RasterConfig, _sorted_attrs,
                                                _v2_radius_cap,
                                                project_gaussians)

    monkeypatch.setattr(yardstick, "BLOCK_TILES", block)
    smoke = _smoke()
    gen = torch.Generator().manual_seed(5)
    cam = Camera(60.0, 60.0, 47.5, 31.5, 96, 64)
    cfg = RasterConfig(tile=16, dup_side=3, seg_cap=256, bands=3)
    n = 6000 if dense else 3000
    xyz = torch.rand((n, 3), generator=gen) * torch.tensor([2.0, 1.4, 1.0]) \
        - torch.tensor([1.0, 0.7, -1.5])
    q = torch.randn((n, 4), generator=gen)
    size = (0.02, 0.08) if dense else (0.005, 0.03)
    ls = torch.log(size[0] + size[1] * torch.rand((n, 3), generator=gen))
    op = torch.randn((n, 1), generator=gen) + (4.0 if dense else 0.0)
    col = torch.rand((n, 3), generator=gen)
    proj = project_gaussians(xyz, q, ls, op, torch.eye(4), cam, cfg,
                             radius_cap=_v2_radius_cap(cfg))
    attrs, seg_start, seg_cnt = _sorted_attrs(proj, col, cam, cfg)
    tiles_x = 6
    tile_ids = torch.arange(24, dtype=torch.int32)
    out, cols = cs.composite_sorted_fwd(attrs, seg_start, seg_cnt, tile_ids,
                                        16, tiles_x, 3, 256)
    n_chunks = (out[:, 7, 0].long() + 127) // 128
    stopped = bool((out[:, 6, 0].long() < n_chunks).any())
    assert stopped == dense
    got = yardstick.work(attrs, seg_start, seg_cnt, tile_ids, 16, tiles_x,
                         3, 256)
    want = smoke._work(attrs, tile_ids, out, cols, 16, tiles_x)
    assert got == want and got["contrib"] > 0
    nb = yardstick.nbytes(attrs, seg_start, seg_cnt, tile_ids, out, cols)
    assert nb == smoke._nbytes(attrs, seg_start, seg_cnt, tile_ids, out,
                               cols)
    for kid in ("K1", "K2", "K4"):
        n_ops = yardstick.ops(kid, got)
        assert n_ops == smoke._ops(kid, want)
        assert yardstick.bound_s(nb, n_ops) == pytest.approx(
            smoke._bound(nb, n_ops)["bound_ms"] / 1e3, rel=1e-12)
    assert (yardstick.HBM_BYTES_PER_S, yardstick.FP32_OPS_PER_S) == (
        smoke.HBM_BYTES_PER_S, smoke.FP32_OPS_PER_S)


@pytest.mark.parametrize("kind", ["replica", "tum"])
def test_writers_read_back_by_the_program(kind, tmp_path):
    """Frames written in a layout come back through the program's reader as
    the reference decodes them, with the generated poses."""
    from eags_slam_torch.datasets import get_dataset

    if kind == "replica":
        pytest.importorskip("PIL")
        layout = {"kind": "replica", "quality": 95, "depth_scale": 6553.5}
        cam = dict(CAM)
        config = {"data": {"dataset_name": "replica"},
                  "cam": {**cam, "depth_scale": 6553.5, "crop_edge": 0}}
    else:
        layout = {"kind": "tum", "t0": 100.0, "fps": 30.0,
                  "depth_scale": 5000.0, "depth_dt": 0.012, "gt_dt": 0.004,
                  "orphan_after": 5.0, "paeth_mix": True}
        cam = {**CAM, "distortion": [0.262383, -0.953104, -0.005358,
                                     0.002628, 1.163314]}
        config = {"data": {"dataset_name": "tum_rgbd", "frame_rate": 32},
                  "cam": {**cam, "depth_scale": 5000.0, "crop_edge": 4}}
    mix = {"frames": 4, "orbit_speed": 1.0 / 48.0, **NOISE}
    root = str(tmp_path / "seq")
    gen = traffic.generate({"cam": cam, "layout": layout}, mix, 11, root,
                           "cpu")
    config["data"]["input_path"] = root
    ds = get_dataset(config["data"]["dataset_name"])(config, device="cpu")
    assert len(ds) == 4
    rcam = {**cam, "depth_scale": config["cam"]["depth_scale"],
            "crop_edge": config["cam"]["crop_edge"]}
    g0 = np.linalg.inv(gen["poses"][0])
    p0 = np.linalg.inv(ds.poses[0])
    for i in range(4):
        color, depth = ds.frame(i)
        rc, rd = reference.frame(*gen["paths"][i], rcam)
        assert np.array_equal(color.numpy(), rc)
        assert np.array_equal(depth.numpy(), rd)
        np.testing.assert_allclose(p0 @ ds.poses[i], g0 @ gen["poses"][i],
                                   atol=1e-6)
    ds.close()


def test_predistortion_inverts_the_lens():
    dist = [0.262383, -0.953104, -0.005358, 0.002628, 1.163314]
    cam = {"fx": 517.306408, "fy": 516.469215, "cx": 318.64304,
           "cy": 255.313989, "W": 640, "H": 480}
    mu, mv = layouts.predistort_maps(cam, dist)
    # Undistorting the capture's sample points gives the pixel grid back
    # inside the 50-pixel crop.
    u, v = reference.undistort_maps(cam, dist)
    back_u = np.interp(u[240], np.arange(640), mu[240])
    assert np.abs(back_u[50:-50] - np.arange(640)[50:-50]).max() < 1e-2
    assert np.isfinite(mv).all()
