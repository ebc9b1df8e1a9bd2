"""The coarse-to-fine tracking slice: the JAX GaussianSLAM (sorted backend
in Pallas interpret mode, EAGS_RCFG=backend=sorted, the pose-contraction
backward K4 on, EAGS_POSE_KERNEL=1) and the port's GaussianSLAM on
device="cpu", both with the edge VO as the odometer on synthetic_hard, on
the same frames (the JAX dataset's) and the same random draws (the JAX
keys', as in tests/test_torch_slice.py). The port's K4 path runs through
its plain twin here.

Settings: configs/synthetic/tiny.yaml (96x64), the first 4 frames (frame
3 is the first with an odometer candidate) of a 72-frame synthetic_hard
sequence (bench.py's exposure drift rate) at 1/120 orbit a frame, exposure
estimation on, 20 tracking iterations, 20 mapping iterations for the first
submap and 10 for the last frame, and the VO settings of
tests/test_vo.py (2 levels, Canny 40/120): at 96x64 the default 3-level
VO with Canny 100/200 finds too few edges to help.

Tolerance on the per-frame camera positions: 1 cm (as the const-speed
slice test: the packages round float32 differently, and a seed or an edge
on a tile or pixel boundary can go either way). Both runs must also pass
the ATE bound of tests/test_e2e_hard.py (3.3 cm), and the odometer
candidate must win at least one frame in both.
"""
import numpy as np
import pytest
import torch

from eags_slam_tpu.config import load_config as j_load_config
from eags_slam_tpu.slam.gaussian_slam import GaussianSLAM as JSLAM
from eags_slam_torch.config import load_config
from eags_slam_torch.datasets import ArrayDataset
from eags_slam_torch.evaluation.trajectory import evaluate_trajectory
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.slam.gaussian_slam import GaussianSLAM
from test_torch_slice import JaxDraws

N_FRAMES = 4
OVERRIDES = {
    "data": {"dataset_name": "synthetic_hard", "n_frames": 72,
             "orbit_speed": 1.0 / 120},
    "tracking": {"odometry_type": "odometer", "pose_grad_kernel": True,
                 "enable_exposure": True, "iterations": 20},
    "mapping": {"iterations": 10, "new_submap_iterations": 20},
    "vo": {"pyramid_levels": 2, "canny_low": 40.0, "canny_high": 120.0,
           "dt_window": 16, "max_edge_points": 2048},
}


def _config(load, out):
    cfg = load("configs/synthetic/tiny.yaml")
    cfg["frame_limit"] = N_FRAMES
    for sec, d in OVERRIDES.items():
        cfg[sec].update(d)
    cfg["data"]["output_path"] = str(out)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # Two intra-op threads: the suite runs in several processes at once.
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        return _runs(tmp_path_factory.mktemp("c2f"))
    finally:
        torch.set_num_threads(threads)


def _runs(out):
    mp = pytest.MonkeyPatch()
    mp.setenv("EAGS_RCFG", "backend=sorted")
    mp.setenv("EAGS_POSE_KERNEL", "1")
    jslam = JSLAM(_config(j_load_config, out / "jax"))
    try:
        j_report = jslam.run()
        ds = jslam.dataset
        n = len(ds)
        colors = np.stack([ds._frame_cache[i][0] for i in range(n)])
        # The float16 depth the JAX SLAM loop reads (device_frame).
        depths = np.stack([np.asarray(ds._dev_cache[i][1]).astype(np.float32)
                           for i in range(n)])
        poses = np.stack([ds.poses[i] for i in range(n)])
        j_c2w = jslam.estimated_c2ws.copy()
    finally:
        jslam.cleanup()
        mp.undo()

    tcfg = _config(load_config, out / "port")
    tcfg["device"] = "cpu"
    tslam = GaussianSLAM(tcfg, dataset=ArrayDataset(tcfg, colors, depths,
                                                    poses),
                         draws=JaxDraws())
    try:
        cs.reset_counts()
        t_report = tslam.run()
        counts = cs.counts()
    finally:
        tslam.cleanup()
    return dict(out=out, poses=poses, c2w={"jax": j_c2w,
                                           "port": tslam.estimated_c2ws},
                report={"jax": j_report, "port": t_report}, counts=counts)


def test_c2f_positions_match_jax(runs):
    d = np.linalg.norm(runs["c2w"]["port"][:, :3, 3]
                       - runs["c2w"]["jax"][:, :3, 3], axis=-1)
    assert d.max() < 0.01, d
    assert runs["report"]["port"]["frames"] == N_FRAMES


@pytest.mark.parametrize("side", ["jax", "port"])
def test_c2f_within_e2e_bound(runs, side):
    traj = evaluate_trajectory(runs["c2w"][side], runs["poses"])
    assert traj["ate"]["rmse"] < 0.033, traj["ate"]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_c2f_odometer_candidate_wins(runs, side):
    rep = runs["report"][side]
    assert rep["tracker"]["init_pose_cnt"]["odometer"] >= 1, rep["tracker"]
    assert rep["vo"]["n_keyframes"] >= 1
    assert (runs["out"] / side / "vo_traj_tum.txt").exists()


def test_c2f_port_runs_k4_path(runs):
    """On the CPU the pose gradient comes from K4's twin (the tracker never
    takes the K2-twin chain), and no kernel launches."""
    c = runs["counts"]
    assert c["pose_twin_calls"] > 0 and c["fwd_twin_calls"] > 0
    assert c["fwd_launches"] == c["bwd_launches"] == c["pose_launches"] == 0
    assert c["bwd_twin_calls"] > 0          # mapping's backward
    tum = (runs["out"] / "port" / "vo_traj_tum.txt").read_text().splitlines()
    assert len(tum) == N_FRAMES + 1 and tum[0].startswith("#")
