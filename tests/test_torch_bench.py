"""The port's bench entry (`python -m eags_slam_torch.bench`): its config is
bench.py's `make_config`, setting by setting (loop closure on, the same
deadline), its lines carry bench.py's `emit` keys, and without a card it
exits non-zero before printing any result."""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from eags_slam_torch import bench as tbench

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_frames,gt_camera", [(24, False), (72, False),
                                                (72, True)])
def test_make_config_is_bench_py(monkeypatch, n_frames, gt_camera):
    monkeypatch.setenv("EAGS_BENCH_T0", "1000.0")
    monkeypatch.setenv("EAGS_BENCH_DEADLINE_S", "2700")
    monkeypatch.delenv("EAGS_BENCH_MESH", raising=False)
    if gt_camera:
        monkeypatch.setenv("EAGS_GT_CAMERA", "1")
    else:
        monkeypatch.delenv("EAGS_GT_CAMERA", raising=False)
    j = _jax_bench().make_config(n_frames, "out_j")
    t = tbench.make_config(n_frames, "out_t")
    assert t.pop("device") == "cuda"
    j.pop("device")                     # the JAX config's device index
    for cfg in (j, t):
        cfg.pop("project_name")
        cfg["data"].pop("output_path")
    assert t == j
    assert t["lc"]["enabled"] is (not gt_camera)
    assert t["bench_deadline_ts"] == 1000.0 + 2700 - 180.0


def test_emit_keys(capsys):
    report = {"fps": 0.5, "frames": 72, "stage_totals_s": {"track": 1.0},
              "lc": {"n_closures": 3, "submit_ms_mean": 1234.56}}
    q = {"ate_rmse_cm": 1.2345, "rpe_trans_cm": 0.5, "psnr_db": 25.0,
         "ssim": 0.5, "ms_ssim": None, "depth_l1_cm": float("nan")}
    line = tbench.emit(report, q, "NVIDIA H100 80GB HBM3, 700.00 W", "full")
    printed = json.loads(capsys.readouterr().out.strip())
    assert printed == line
    for key in ("metric", "value", "unit", "vs_baseline", "ate_cm", "rpe_cm",
                "psnr_db", "ssim", "n_closures", "lc_submit_ms_mean",
                "stages_s", "card", "phase"):
        assert key in line, key
    assert "ms_ssim" not in line and "depth_l1_cm" not in line
    assert line["vs_baseline"] == round(0.5 / tbench.BASELINE_FPS, 3)
    assert line["n_closures"] == 3 and line["phase"] == "full"
    assert line["lc"] == "on"
    assert tbench.make_config(72, "o", lc=False)["lc"]["enabled"] is False


def test_bench_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {k: v for k, v in os.environ.items() if k != "EAGS_BENCH_T0"}
    res = subprocess.run([sys.executable, "-m", "eags_slam_torch.bench",
                          "--quick", "--out", str(tmp_path / "b")], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode != 0
    assert '"metric"' not in res.stdout
