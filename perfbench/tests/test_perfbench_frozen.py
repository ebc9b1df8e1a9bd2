"""The benchmark's frozen copies against the originals they were copied
from, at small sizes on the CPU: the scene against the program's
`synthetic_hard`, the operation count against `chip_smoke.py`'s, the
layout writers against the program's readers and against their own files
as they were frozen, and the reference's nearest resize against
Pillow's."""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from perfbench import check, layouts, reference, scene, traffic, yardstick
from perfbench.tests.tiny import ROOT

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


TUM_DIST = [0.262383, -0.953104, -0.005358, 0.002628, 1.163314]
# ScanNet++'s DSLR frames at a tiny size: 144 x 96, the published 1752 x
# 1168's aspect, which the reader resizes to 640 x 480.
DSLR = {"fx": 135.0, "fy": 120.0, "cx": 71.5, "cy": 47.5, "W": 144, "H": 96}


def _stream(kind):
    """(cam, layout, the reader's config) of a tiny stream in `kind`."""
    if kind == "replica":
        layout = {"kind": "replica", "quality": 95, "depth_scale": 6553.5}
        cam = dict(CAM)
        config = {"data": {"dataset_name": "replica"},
                  "cam": {**cam, "depth_scale": 6553.5, "crop_edge": 0}}
    elif kind == "tum":
        layout = {"kind": "tum", "t0": 100.0, "fps": 30.0,
                  "depth_scale": 5000.0, "depth_dt": 0.012, "gt_dt": 0.004,
                  "orphan_after": 5.0, "paeth_mix": True}
        cam = {**CAM, "distortion": TUM_DIST}
        config = {"data": {"dataset_name": "tum_rgbd", "frame_rate": 32},
                  "cam": {**cam, "depth_scale": 5000.0, "crop_edge": 4}}
    else:
        layout = {"kind": "scannetpp", "quality": 95, "depth_scale": 1000.0}
        cam = dict(DSLR)
        config = {"data": {"dataset_name": "scannetpp"},
                  "cam": {**cam, "depth_scale": 1000.0, "crop_edge": 4}}
    return cam, layout, config


def _generate(kind, root, seed=11):
    if kind != "tum":
        pytest.importorskip("PIL")
    cam, layout, config = _stream(kind)
    mix = {"frames": 4, "orbit_speed": 1.0 / 48.0, **NOISE}
    gen = traffic.generate({"cam": cam, "layout": layout}, mix, seed,
                           str(root), "cpu")
    rcam = {**cam, "depth_scale": config["cam"]["depth_scale"],
            "crop_edge": config["cam"]["crop_edge"]}
    return gen, layout, config, rcam


def _reader(config, root):
    from eags_slam_torch.datasets import get_dataset

    config["data"]["input_path"] = str(root)
    return get_dataset(config["data"]["dataset_name"])(config, device="cpu")


@pytest.mark.parametrize("kind", ["replica", "tum", "scannetpp"])
def test_writers_read_back_by_the_program(kind, tmp_path):
    """Frames written in a layout come back through the program's reader as
    the layout's reference reader decodes them, with the generated poses."""
    gen, layout, config, rcam = _generate(kind, tmp_path / "seq")
    ds = _reader(config, tmp_path / "seq")
    assert len(ds) == 4
    read = layouts.entry(layout).read_reference
    g0 = np.linalg.inv(gen["poses"][0])
    p0 = np.linalg.inv(ds.poses[0])
    for i in range(4):
        color, depth = ds.frame(i)
        rc, rd = read(*gen["paths"][i], rcam)
        assert np.array_equal(color.numpy(), rc)
        assert np.array_equal(depth.numpy(), rd)
        assert (depth > 0).float().mean() > 0.9
        np.testing.assert_allclose(p0 @ ds.poses[i], g0 @ gen["poses"][i],
                                   atol=1e-6)
    if kind == "scannetpp":
        # The DSLR intrinsics scaled to the reader's 640 x 480, then
        # cropped by crop_edge.
        e, sx, sy = 4, 640 / DSLR["W"], 480 / DSLR["H"]
        want = (DSLR["fx"] * sx, DSLR["fy"] * sy, DSLR["cx"] * sx - e,
                DSLR["cy"] * sy - e, 640 - 2 * e, 480 - 2 * e)
        np.testing.assert_allclose(tuple(ds.camera), want, rtol=1e-12)
        assert color.shape == (480 - 2 * e, 640 - 2 * e, 3)
    ds.close()


def test_altered_scannetpp_frame_fails_the_check(tmp_path):
    """The frames check reads a ScanNet++ frame's files anew: a frame
    whose depth or colour changed on disk after the reader returned it
    fails its limit, and the frames as read pass."""
    from PIL import Image

    gen, layout, config, rcam = _generate("scannetpp", tmp_path / "seq")
    ds = _reader(config, tmp_path / "seq")
    kept = {i: ds.frame(i) for i in (1, 2)}
    ds.close()
    read = layouts.entry(layout).read_reference
    limits = json.loads((ROOT / "perfbench" / "configs"
                         / "tum_fr1_desk.json").read_text())["limits"]
    sound = check.frames(kept, gen["paths"], rcam, read, "cpu")
    assert sound == {"frame_color_mae": 0.0, "frame_depth_mae_m": 0.0}
    color_path, depth_path = gen["paths"][1]
    raw = reference.read_depth_png(depth_path)
    layouts.write_png(depth_path, np.where(raw > 0, raw + 10, 0)
                      .astype(np.uint16))
    deeper = check.frames(kept, gen["paths"], rcam, read, "cpu")
    assert deeper["frame_depth_mae_m"] > limits["frame_depth_mae_m"]
    assert deeper["frame_color_mae"] <= limits["frame_color_mae"]
    with Image.open(color_path) as im:
        rgb = np.asarray(im.convert("RGB"), np.int16)
    Image.fromarray(np.clip(rgb + 2, 0, 255).astype(np.uint8)).save(
        color_path, format="JPEG", quality=95)
    brighter = check.frames(kept, gen["paths"], rcam, read, "cpu")
    assert brighter["frame_color_mae"] > limits["frame_color_mae"]


def test_scannetpp_layout_refuses_a_lens(tmp_path):
    cam, layout, _ = _stream("scannetpp")
    mix = {"frames": 2, "orbit_speed": 1.0 / 48.0, **NOISE}
    with pytest.raises(ValueError, match="no lens"):
        traffic.generate({"cam": {**cam, "distortion": TUM_DIST},
                          "layout": layout}, mix, 11, str(tmp_path), "cpu")


# sha256 of every file `traffic.generate` writes for 4 frames at 96 x 64,
# seed 3_000_000_019, frozen from the writers as the two cells were first
# measured with them: the cells' frames do not move with the table.
FROZEN = {
    "tum": {
        "depth.txt":
            "57eb1e5766444561374c30cde245a57ca8a785b79c77b8888bdfa2395332a317",
        "depth/100.012000.png":
            "d9213dbddf96501eb0d6470f73d04ff354fda94aca6b3d1e4ceb5f99ec315781",
        "depth/100.045333.png":
            "9741b265739e26993239c7e9c790f45d7f88169906be41fb878154c013f38176",
        "depth/100.078667.png":
            "005f8fc4ed3c4c861614dc55d3fdf2f7b0e8096b16564408840e5f6336f643e6",
        "depth/100.112000.png":
            "6af538b2273de604526c56ab882342871b4bf11e5fc436fa13a2e38be71eef42",
        "depth/105.112000.png":
            "acebc405dce219fefc15eadee47cea11f701f73f561d88be175eee4e4cea885a",
        "groundtruth.txt":
            "940c7cb2bed449a3a914cab0c0e6516c70de6006ebafb97a08a0037eb991dfba",
        "rgb.txt":
            "ae9d016ba9db957dee03f1c370eee2d5b7d1a22cea119a5f756d32e1b5f7a091",
        "rgb/100.000000.png":
            "48b72457f7645a5524e61f0db4279a64b61de35a0efeaf473440bf153278938a",
        "rgb/100.033333.png":
            "b4876a752a27e210923fd24788f6d7d6aa216f8946b9c0f0f0e689b05d73b366",
        "rgb/100.066667.png":
            "29f148110321017408f111e57bb1725785226dd50b2b35a23fbb7d5bbab069b5",
        "rgb/100.100000.png":
            "ba4b424b4cc0fe08052c8561484e1c15d4f4634255928fee275a855d97fd31cd",
        "rgb/105.100000.png":
            "12d3493c6dfaf64ab98aecc0b161d2d66cd1fc6ecf1affbfd798365db65af7ed",
    },
    "replica": {
        "results/depth000000.png":
            "f39a5facbf83eb29fd497ad501489d703a6f5a089f479bae347d69d65e320b35",
        "results/depth000001.png":
            "55f8f3c7a9b9b22cef3b794ae0f740c6b24d8c18fe2766115c83ef0cf59c6b7e",
        "results/depth000002.png":
            "93e2f1282353f93c80b10365b106282caf904fac112782de56e124bf246a2e42",
        "results/depth000003.png":
            "ed6212f990843870ada10a330a2cad3f1e75c4af20dfd863ca6abec3ec1dae3e",
        "results/frame000000.jpg":
            "0376ac9d79bb2ab788305c42590765a909a5a254a8e815040ef0d99baf9f69c8",
        "results/frame000001.jpg":
            "3ba6de91d0618668a6251409bcc8614da18d6b9c3912358f280349ee3c08bac6",
        "results/frame000002.jpg":
            "c1a4544b57addc01319ca2916d8893b313132c46fefc055dfad3a4218e87f476",
        "results/frame000003.jpg":
            "89578f880ac2a0359a3df83d326e5716066f8777778620b2ea8244d897aceff5",
        "traj.txt":
            "c6c347549c5f397d0329e7a674c6af0531e69adb75d112e3da8aa1c10c74f7cc",
    },
}


@pytest.mark.parametrize("kind", ["tum", "replica"])
def test_layout_files_equal_the_frozen_ones(kind, tmp_path):
    root = tmp_path / "seq"
    _generate(kind, root, seed=3_000_000_019)
    got = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                got[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    assert got == FROZEN[kind]


@pytest.mark.parametrize("wh", [(144, 96), (1752, 1168), (7008, 4672),
                                (1280, 960), (640, 480), (320, 240),
                                (641, 479)])
def test_nearest_resize_equals_pillows(wh):
    """`reference.resize_nearest` to the reader's 640 x 480 equals Pillow's
    NEAREST on 16-bit depth, down and up, at whole and odd ratios."""
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(wh[0]).integers(0, 65536, wh[::-1],
                                                dtype=np.uint16)
    want = np.asarray(Image.fromarray(img).resize(reference.SCANNETPP_WH,
                                                  Image.NEAREST))
    assert np.array_equal(reference.resize_nearest(img,
                                                   reference.SCANNETPP_WH),
                          want)


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
