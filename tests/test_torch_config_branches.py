"""The config branches of the port that used to raise, each run as a
tiny GaussianSLAM on the CPU (4 frames of configs/synthetic/tiny.yaml at
`_CHEAP` iterations, through the kernels' twins)."""
import json

import numpy as np
import pytest
import torch

from eags_slam_torch.ops import composite_entries as ce
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.ops import rasterizer as R
from eags_slam_torch.slam import mapper as M
from eags_slam_torch.slam.gaussian_slam import GaussianSLAM
from test_torch_guards import _CHEAP, _tiny


def _write_replica(root, cfg):
    """The tiny config's synthetic frames in Replica's layout."""
    from eags_slam_torch.datasets import Synthetic
    from eags_slam_torch.utils.layouts import write_replica

    ds = Synthetic(cfg, device="cpu")
    frames = [ds.frame_u8(i) for i in range(len(ds))]
    write_replica(root, [c.numpy() for c, _ in frames],
                  [d.numpy() for _, d in frames], ds.poses)


@pytest.mark.parametrize("case", [
    "odometer", "odometer_coupled", "help_camera_initialization",
    "synthetic_hard", "synthetic_hard.crop_edge", "replica",
    "pose_grad_kernel", "rmw_window", "backend_pallas", "lc"])
def test_ported_config_branches_run(tmp_path, monkeypatch, case):
    """The branches that used to raise now run: the edge VO (as the
    odometer, decoupled or coupled, or only scoring its candidate), the
    synthetic_hard scene, an edge crop of its frames (`cam.crop_edge` 8,
    the VO on the uncropped frames), the Replica reader (the tiny config's
    frames written as JPEG colour and 16-bit PNG depth), the
    pose-contraction backward, the windowed backward
    (`mapping.rmw_window`), the entry-binned backend
    (`EAGS_RCFG=backend=pallas`) and loop closure (`lc.enabled`, its
    worker thread submitting the run's one submap), each through its twins
    on the CPU. (The map and track options' runs:
    tests/test_torch_config_options.py.)"""
    _run_branch(tmp_path, monkeypatch, case)


def _run_branch(tmp_path, monkeypatch, case):
    """A 4-frame tiny GaussianSLAM run of the config branch `case`, with
    the checks every case shares and its own."""
    sections = {
        "odometer": {"tracking": {"odometry_type": "odometer"}},
        "odometer_coupled": {"tracking": {"odometry_type": "odometer"},
                             "vo": {"decoupled": False}},
        "help_camera_initialization": {
            "tracking": {"help_camera_initialization": True}},
        "synthetic_hard": {"data": {"dataset_name": "synthetic_hard",
                                    "n_frames": 4}},
        "synthetic_hard.crop_edge": {
            "data": {"dataset_name": "synthetic_hard", "n_frames": 4},
            "tracking": {"odometry_type": "odometer"},
            "cam": {"crop_edge": 8}},
        "replica": {"data": {"dataset_name": "replica",
                             "input_path": str(tmp_path / "replica")},
                    "cam": {"depth_scale": 6553.5}},
        "pose_grad_kernel": {"tracking": {"pose_grad_kernel": True}},
        "rmw_window": {"mapping": {"rmw_window": True}},
        "backend_pallas": {},
        "lc": {"lc": {"enabled": True, "parallel": True}},
        "kernel_bf16": {"mapping": {"kernel_bf16": True}},
        "kernel_quadform": {"mapping": {"kernel_quadform": True}},
        "tile_subset": {"mapping": {"tile_subset": 8}},
        "init_halfres_frac": {"mapping": {"init_halfres_frac": 0.5}},
        "debug_per_iter": {"tracking": {"debug_per_iter": True}},
    }[case]
    monkeypatch.delenv("EAGS_RMW_WINDOW", raising=False)
    monkeypatch.delenv("EAGS_RCFG", raising=False)
    if case == "backend_pallas":
        monkeypatch.setenv("EAGS_RCFG", "backend=pallas")
    cfg = _tiny(tmp_path, frames=4, **_CHEAP)
    if case == "replica":
        _write_replica(tmp_path / "replica", cfg)
    for sec, d in sections.items():
        cfg[sec].update(d)
    subset_tiles = []
    if case == "tile_subset":
        def render_tiles(*args, **kw):
            subset_tiles.append(int(args[6].shape[0]))
            return R.render_tiles(*args, **kw)
        monkeypatch.setattr(M, "render_tiles", render_tiles)
    # Two intra-op threads: the suite runs in several processes at once.
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    gslam = GaussianSLAM(cfg)
    try:
        cs.reset_counts()
        ce.reset_counts()
        report = gslam.run()
        backend = gslam.rcfg.backend
    finally:
        gslam.cleanup()
        torch.set_num_threads(threads)
    assert report["frames"] == 4
    assert gslam.cam == gslam.dataset.full_camera.crop(
        cfg["cam"]["crop_edge"])
    if case == "synthetic_hard.crop_edge":
        # Every mapped frame seeded from the VO's (cropped) edges.
        assert report["seed_edges"] == {"vo": report["map_frames"],
                                        "canny": 0}
    if case == "replica":
        assert report["data"]["decoded"] >= 4
    cands = report["tracker"]["init_pose_cnt"]
    assert sum(cands.values()) == 2
    if "odometer" in case or case in ("help_camera_initialization",
                                      "synthetic_hard.crop_edge"):
        assert report["vo"]["n_keyframes"] >= 1
        assert (tmp_path / "out" / "vo_traj_tum.txt").exists()
    else:
        assert "vo" not in report
    assert ("lc" in report) == (case == "lc")
    if case == "lc":
        assert report["lc"]["n_submits"] == 1
        assert report["lc"]["n_closures"] == 0
    c = {**cs.counts(), **ce.counts()}
    twin = {"pose_grad_kernel": "pose_twin_calls",
            "rmw_window": "window_twin_calls",
            "backend_pallas": "entries_bwd_twin_calls"}.get(case)
    for key in ("pose_twin_calls", "window_twin_calls",
                "entries_bwd_twin_calls"):
        assert (c[key] > 0) == (key == twin), (key, c)
    # On the entry-binned backend no render is sorted: no tile subset ran.
    assert (backend == "pallas") == (case == "backend_pallas"), backend
    if case == "backend_pallas":
        assert c["fwd_twin_calls"] == c["bwd_twin_calls"] == 0
    if case.startswith("kernel_"):
        assert getattr(gslam.rcfg, case) and c["bwd_twin_calls"] > 0
    assert (len(subset_tiles) > 0) == (case == "tile_subset")
    assert set(subset_tiles) <= {8}
    with open(tmp_path / "out" / "log.jsonl") as f:
        log = [json.loads(r) for r in f]
    halfres = [r["halfres_iters"] for r in log if r["kind"] == "mapping"]
    assert halfres[0] == (4 if case == "init_halfres_frac" else 0)
    assert not any(halfres[1:])
    track = {r["frame"]: r for r in log if r["kind"] == "tracking"}
    iters = {r["frame_id"]: r for r in log if r["kind"] == "track_iters"}
    assert set(iters) == (set(track) if case == "debug_per_iter" else set())
    for f, rec in iters.items():
        per = np.asarray(rec["iters"])
        assert rec["names"][4] == "active" and per.shape == (8, 12)
        assert int(per[:, 4].sum()) == int(track[f]["iters"])
