"""The real-data slice on disk, both packages: synthetic_hard frames at the
tiny size (96x64) written in the TUM RGB-D layout (colour pre-distorted
with `cam.distortion` [0.04, -0.02, 0, 0, 0] and written with every PNG
filter type, 16-bit depth at 5000 with 12 ms stamp offsets, ground truth
4 ms off), read back by each package's TUM_RGBD reader with `crop_edge` 4
(the map camera 88x56, the VO on the uncropped 96x64 frames), the JAX
GaussianSLAM (sorted backend in Pallas interpret mode) and the port's on
device="cpu", 4 frames with the edge VO as the odometer, the same random
draws (tests/test_torch_slice.py's JaxDraws). The orbit is the scene's
default 1/300 a frame (about 1 cm): at the c2f test's 1/120 the tracker
leaves the basin on the cropped 88x56 map at frame 3 in both packages
alike (ATE 5.0 cm in each, positions still within 1 mm of each other).

The seeding edges of every mapped frame equal the JAX package's exactly:
the VO's edge map depends only on the decoded, undistorted colour, which
both readers return bit for bit, and both crop it by `crop_edge` before
seeding (uncropped, its shape would differ from the map camera's and every
mapped frame would fall back to Canny).

Tolerance on the per-frame camera positions: 1 cm (as the const-speed and
c2f slice tests; here the JAX loop also rounds depth to float16 on upload,
the port keeps float32). Both runs must also pass the ATE bound of
tests/test_e2e_hard.py (3.3 cm).
"""
import numpy as np
import pytest
import torch

from eags_slam_tpu.config import load_config as j_load_config
from eags_slam_tpu.slam.gaussian_slam import GaussianSLAM as JSLAM
from eags_slam_torch.config import load_config
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.datasets import distort_points, remap_bilinear
from eags_slam_torch.evaluation.trajectory import evaluate_trajectory
from eags_slam_torch.slam.gaussian_slam import GaussianSLAM
from eags_slam_torch.synthetic_hard import SyntheticHard
from eags_slam_torch.utils.layouts import write_tum
from test_torch_cli import _assert_reader_ran
from test_torch_slice import JaxDraws

N_FRAMES = 4
CROP = 4
DIST = [0.04, -0.02, 0.0, 0.0, 0.0]
OVERRIDES = {
    "tracking": {"odometry_type": "odometer", "enable_exposure": True,
                 "iterations": 20},
    "mapping": {"iterations": 10, "new_submap_iterations": 20},
    "vo": {"pyramid_levels": 2, "canny_low": 40.0, "canny_high": 120.0,
           "dt_window": 16, "max_edge_points": 2048},
}


def predistort(rgb: np.ndarray, cam: Camera, dist) -> np.ndarray:
    """The image a lens with `dist` would capture of `rgb`: D(x_d) =
    I(undistort(x_d)), the forward model inverted by fixed-point iteration
    (tests/test_reader_roundtrip.py)."""
    u, v = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                       np.arange(cam.height, dtype=np.float64))
    xyd = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy], -1)
    xy = xyd.copy()
    for _ in range(25):
        xy = xy + (xyd - distort_points(xy, np.asarray(dist)))
    map_u = (cam.fx * xy[..., 0] + cam.cx).astype(np.float32)
    map_v = (cam.fy * xy[..., 1] + cam.cy).astype(np.float32)
    return remap_bilinear(rgb, map_u, map_v)


def _write_sequence(root):
    cfg = load_config("configs/synthetic/tiny.yaml")
    cfg["device"] = "cpu"
    cfg["data"].update({"dataset_name": "synthetic_hard", "n_frames": 72})
    cfg["frame_limit"] = N_FRAMES
    ds = SyntheticHard(cfg)
    colors, depths = [], []
    for i in range(N_FRAMES):
        rgb8, depth = ds.frame_u8(i)
        colors.append(predistort(rgb8.numpy(), ds.full_camera, DIST))
        depths.append(depth.numpy())
    write_tum(root, colors, depths, ds.poses[:N_FRAMES], depth_dt=0.012,
              gt_dt=0.004, filters=np.arange(cfg["cam"]["H"]) % 5,
              orphan_after=5.0)
    # TUM poses are relative to the first frame.
    first_inv = np.linalg.inv(ds.poses[0])
    return np.stack([first_inv @ p for p in ds.poses[:N_FRAMES]])


def _config(load, root, out):
    cfg = load("configs/synthetic/tiny.yaml")
    for sec, d in OVERRIDES.items():
        cfg[sec].update(d)
    cfg["data"].update({"dataset_name": "tum_rgbd", "input_path": str(root),
                        "output_path": str(out), "frame_rate": 32})
    cfg["cam"].update({"depth_scale": 5000.0, "crop_edge": CROP,
                       "distortion": DIST})
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # Two intra-op threads: the suite runs in several processes at once.
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        return _runs(tmp_path_factory.mktemp("reader"))
    finally:
        torch.set_num_threads(threads)


def _runs(out):
    gt = _write_sequence(out / "seq")
    mp = pytest.MonkeyPatch()
    mp.setenv("EAGS_RCFG", "backend=sorted")
    jslam = JSLAM(_config(j_load_config, out / "seq", out / "jax"))
    j_edges = {}
    j_edge_bits = jslam._edge_bits

    def record_jax(frame_id):
        bits = j_edge_bits(frame_id)
        j_edges[frame_id] = None if bits is None else np.unpackbits(
            np.asarray(bits), axis=1)[:, :jslam.cam.width].astype(bool)
        return bits

    jslam._edge_bits = record_jax
    try:
        j_report = jslam.run()
        j_c2w = jslam.estimated_c2ws.copy()
        j_len = len(jslam.dataset)
    finally:
        jslam.cleanup()
        mp.undo()

    tcfg = _config(load_config, out / "seq", out / "port")
    tcfg["device"] = "cpu"
    tslam = GaussianSLAM(tcfg, draws=JaxDraws())
    t_edges = {}
    t_vo_edges = tslam._vo_edges

    def record_port(frame_id):
        e = t_vo_edges(frame_id)
        t_edges[frame_id] = None if e is None else e.cpu().numpy()
        return e

    tslam._vo_edges = record_port
    try:
        t_report = tslam.run()
        cam = tslam.cam
    finally:
        tslam.cleanup()
    return dict(out=out, gt=gt, j_len=j_len, cam=cam,
                c2w={"jax": j_c2w, "port": tslam.estimated_c2ws},
                report={"jax": j_report, "port": t_report},
                edges={"jax": j_edges, "port": t_edges})


def test_reader_slice_reads_the_sequence(runs):
    """Both readers take the 4 frames (the orphan pair is rejected); the
    map camera is the cropped one."""
    assert runs["j_len"] == N_FRAMES
    assert runs["report"]["port"]["frames"] == N_FRAMES
    assert (runs["cam"].width, runs["cam"].height) == (96 - 2 * CROP,
                                                       64 - 2 * CROP)
    _assert_reader_ran(runs["report"]["port"]["data"], N_FRAMES)


def test_reader_slice_seeding_edges_match_jax(runs):
    j, t = runs["edges"]["jax"], runs["edges"]["port"]
    assert sorted(t) == sorted(j) and len(t) >= 2
    for fid in sorted(j):
        assert j[fid] is not None, f"JAX fell back to Canny at {fid}"
        assert t[fid] is not None, f"the port fell back to Canny at {fid}"
        assert t[fid].shape == (64 - 2 * CROP, 96 - 2 * CROP)
        np.testing.assert_array_equal(t[fid], j[fid])
    assert runs["report"]["port"]["seed_edges"] == {"vo": len(t),
                                                    "canny": 0}


def test_reader_slice_positions_match_jax(runs):
    d = np.linalg.norm(runs["c2w"]["port"][:, :3, 3]
                       - runs["c2w"]["jax"][:, :3, 3], axis=-1)
    assert d.max() < 0.01, d


@pytest.mark.parametrize("side", ["jax", "port"])
def test_reader_slice_within_e2e_bound(runs, side):
    traj = evaluate_trajectory(runs["c2w"][side], runs["gt"])
    assert traj["ate"]["rmse"] < 0.033, traj["ate"]
    assert runs["report"][side]["vo"]["n_keyframes"] >= 1
