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
import types

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


def test_make_config_bench_mesh(monkeypatch):
    """EAGS_BENCH_MESH sets force_mesh in both packages' configs."""
    monkeypatch.setenv("EAGS_BENCH_T0", "1000.0")
    monkeypatch.setenv("EAGS_BENCH_MESH", "1")
    monkeypatch.delenv("EAGS_GT_CAMERA", raising=False)
    j = _jax_bench().make_config(24, "out_j")
    t = tbench.make_config(24, "out_t")
    assert t["force_mesh"] is True and j["force_mesh"] is True
    for cfg in (j, t):
        cfg.pop("device")
        cfg.pop("project_name")
        cfg["data"].pop("output_path")
    assert t == j


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


def test_heavy_eval_settings_are_bench_py(monkeypatch, tmp_path):
    """bench.py's heavy evaluation, setting by setting: the mesh stage runs
    with the unseen-view depth-L1 off, the global stage with 2000 refine
    iterations, each through its evaluator's own stage; the deadline
    thresholds are bench.py's 900 s and 600 s."""
    import inspect

    from eags_slam_tpu.evaluation import evaluator as jev
    from eags_slam_torch.evaluation import evaluator as tev

    seen = {}

    def fake(tag):
        class _Ev:
            def __init__(self, out, dataset, config):
                self.config = config

            def run_reconstruction_eval(self):
                seen[(tag, "recon")] = dict(self.config["evaluation"])
                return {"f1": 0.5}

            def run_global_map_eval(self):
                seen[(tag, "global")] = dict(self.config["evaluation"])
                return {"mean_psnr": 25.0}
        return _Ev

    monkeypatch.setattr(jev, "Evaluator", fake("jax"))
    monkeypatch.setattr(tev, "Evaluator", fake("port"))
    jb = _jax_bench()
    gslam = types.SimpleNamespace(dataset=None)
    j = {**jb._evaluate_recon(gslam, {}, "o"),
         **jb._evaluate_global(gslam, {}, "o")}
    t = {**tbench.evaluate_recon(gslam, {}, "o"),
         **tbench.evaluate_global(gslam, {}, "o")}
    assert t == j == {"mesh_f1": 0.5, "global_psnr_db": 25.0}
    for stage in ("recon", "global"):
        assert seen[("port", stage)] == seen[("jax", stage)]
    assert seen[("port", "recon")] == {"unseen_views": 0}
    assert seen[("port", "global")] == {"global_refine_iters": 2000}
    src = inspect.getsource(jb.run_once)
    assert f"_deadline_left() > {tbench.RECON_MIN_LEFT_S}" in src
    assert f"_deadline_left() > {tbench.GLOBAL_MIN_LEFT_S}" in src
    assert (tbench.RECON_MIN_LEFT_S, tbench.GLOBAL_MIN_LEFT_S) == (900, 600)


def test_heavy_eval_errors_are_reported(monkeypatch):
    """A heavy stage that raises leaves bench.py's error key in place of
    its number."""
    from eags_slam_torch.evaluation import evaluator as tev

    class _Broken:
        def __init__(self, *a):
            pass

        def run_reconstruction_eval(self):
            raise RuntimeError("no mesh")

        run_global_map_eval = run_reconstruction_eval

    monkeypatch.setattr(tev, "Evaluator", _Broken)
    gslam = types.SimpleNamespace(dataset=None)
    assert tbench.evaluate_recon(gslam, {}, "o") == {
        "mesh_error": "RuntimeError('no mesh')"}
    assert tbench.evaluate_global(gslam, {}, "o") == {
        "global_error": "RuntimeError('no mesh')"}


@pytest.mark.parametrize("left,stages", [
    ((2000.0, 1500.0), ("recon", "global")), ((1000.0, 500.0), ("recon",)),
    ((700.0,), ())])
def test_heavy_eval_lines(monkeypatch, capsys, left, stages):
    """run_once with the heavy evaluation: the FPS line, the cheap-eval
    line, the mesh stage's line as soon as mesh_f1 exists, then the final
    unphased line with mesh_f1 and global_psnr_db; each stage only with
    its deadline budget left (bench.py's 900 / 600 s)."""
    from eags_slam_torch.slam import gaussian_slam as GS

    class _SLAM:
        def __init__(self, config):
            self.dataset = None

        def run(self):
            return {"fps": 0.5, "frames": 72, "stage_totals_s": {}}

        def cleanup(self):
            pass

    ran = []
    monkeypatch.setattr(GS, "GaussianSLAM", _SLAM)
    budget = iter(left)
    monkeypatch.setattr(tbench, "_deadline_left", lambda: next(budget))
    monkeypatch.setattr(tbench, "evaluate_cheap",
                        lambda *a: {"psnr_db": 30.0})
    monkeypatch.setattr(tbench, "evaluate_recon",
                        lambda *a: ran.append("recon") or {"mesh_f1": 0.6})
    monkeypatch.setattr(tbench, "evaluate_global",
                        lambda *a: ran.append("global")
                        or {"global_psnr_db": 27.5})
    _, line = tbench.run_once(72, "o", "full", "card", lc=False,
                              heavy_eval=True)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert tuple(ran) == stages
    assert [x.get("phase") for x in lines] == \
        ["full", "full"] + [None] * (2 if stages else 1)
    assert lines[-1] == line and "phase" not in line
    assert ("mesh_f1" in line) == ("recon" in stages)
    assert ("global_psnr_db" in line) == ("global" in stages)
    if stages:
        assert lines[2]["mesh_f1"] == 0.6 and "global_psnr_db" not in \
            lines[2]
