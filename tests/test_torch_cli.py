"""The port's command lines on the CPU (`python -m eags_slam_torch.run_slam`
on the tiny config and on a TUM RGB-D scene config given its files, then
`run_evaluation`) and bench.py's cooperative deadline in GaussianSLAM.run."""
import json
import os
import subprocess
import sys

import numpy as np

from eags_slam_torch.slam.gaussian_slam import GaussianSLAM
from test_torch_guards import _CHEAP, REPO, _tiny


def test_bench_deadline_stops_between_frames(tmp_path, monkeypatch):
    """`bench_deadline_ts` (bench.py's cooperative deadline) ends the run
    cleanly between frames: here after 2 of 4 frames."""
    import time as _time

    from eags_slam_torch.slam import gaussian_slam as GS

    clock = iter([0.0, 0.0, 5.0])     # the check before frames 0, 1, 2

    class _Clock:
        perf_counter = staticmethod(_time.perf_counter)

        @staticmethod
        def time():
            return next(clock)

    cfg = _tiny(tmp_path, frames=4, **_CHEAP)
    cfg["bench_deadline_ts"] = 1.0
    gslam = GaussianSLAM(cfg)
    monkeypatch.setattr(GS, "time", _Clock)
    try:
        report = gslam.run()
    finally:
        gslam.cleanup()
    assert report["frames"] == 2
    assert len(gslam.track_times) == 2


def test_cli_runs_slice_on_cpu(tmp_path):
    """`python -m eags_slam_torch.run_slam` on 2 frames of the tiny config:
    the JAX CLI's report lines and artifacts."""
    out = tmp_path / "run"
    # Two threads: the suite runs in several processes at once, and more
    # threads than cores slow all of them down.
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "eags_slam_torch.run_slam",
         "configs/synthetic/tiny.yaml", "--frame_limit", "2", "--device",
         "cpu", "--output_path", str(out)], cwd=REPO, capture_output=True,
        text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    for prefix in ("FPS:", "Track avg:", "ATE-RMSE:"):
        assert any(line.startswith(prefix) for line in lines), res.stdout
    for name in ("estimated_c2w.npz", "config.yaml", "log.jsonl",
                 "ate.json", "rendering_metrics.json", "evaluation.json"):
        assert (out / name).exists(), name
    assert sorted(os.listdir(out / "submaps"))
    c2w = np.load(out / "estimated_c2w.npz")["c2ws"]
    assert c2w.shape == (2, 4, 4) and np.all(np.isfinite(c2w))


def test_cli_runs_reader_config_on_cpu(tmp_path):
    """`python -m eags_slam_torch.run_slam` on a TUM RGB-D scene config
    (configs/TUM_RGBD/fr1_desk.yaml, as inherited, at the tiny size: crop
    6, the distortion of configs/TUM_RGBD, the odometer, loop closure on)
    given its files with --input_path, then `python -m
    eags_slam_torch.run_evaluation` on the run's directory."""
    from eags_slam_torch.run_evaluation import main as run_evaluation
    from eags_slam_torch.synthetic_hard import SyntheticHard
    from eags_slam_torch.utils.layouts import write_tum

    cfg = _tiny(tmp_path, frames=3)
    cfg["data"].update({"dataset_name": "synthetic_hard", "n_frames": 3})
    ds = SyntheticHard(cfg, device="cpu")
    frames = [ds.frame_u8(i) for i in range(len(ds))]
    write_tum(tmp_path / "seq", [c.numpy() for c, _ in frames],
              [d.numpy() for _, d in frames], ds.poses, filters=4)
    c = cfg["cam"]
    (tmp_path / "scene.yaml").write_text(
        f"inherit_from: {REPO / 'configs/TUM_RGBD/fr1_desk.yaml'}\n"
        f"cam: {{H: {c['H']}, W: {c['W']}, fx: {c['fx']}, fy: {c['fy']}, "
        f"cx: {c['cx']}, cy: {c['cy']}, crop_edge: 6}}\n"
        "mapping: {new_submap_points_num: 2000, "
        "new_submap_gradient_points_num: 500, new_frame_sample_size: 500, "
        "max_gaussians: 8192}\n"
        "vo: {pyramid_levels: 2, canny_low: 40.0, canny_high: 120.0}\n")
    out = tmp_path / "run"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "eags_slam_torch.run_slam",
         str(tmp_path / "scene.yaml"), "--input_path", str(tmp_path / "seq"),
         "--output_path", str(out), "--device", "cpu",
         "--mapping_iterations", "4", "--tracking_iterations", "4"],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    for prefix in ("FPS:", "Track avg:", "ATE-RMSE:"):
        assert any(line.startswith(prefix) for line in lines), res.stdout
    with open(out / "log.jsonl") as f:
        report = [json.loads(r) for r in f if '"report"' in r][-1]
    assert report["frames"] == 3 and report["data"]["decoded"] >= 3
    assert report["stage_totals_s"]["data_wait"] >= 0.0
    assert "lc" in report and report["vo"]["n_keyframes"] >= 1
    run_evaluation(["--checkpoint_path", str(out), "--device", "cpu"])
    with open(out / "evaluation.json") as f:
        results = json.load(f)
    assert np.isfinite(results["rendering"]["mean_psnr"])
    assert results["trajectory"]["ate"]["rmse"] < 0.05
