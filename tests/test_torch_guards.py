"""Guards of the PyTorch port: it never imports JAX or the JAX package, it
refuses a CUDA request without CUDA (no silent fallback to the CPU), every
branch that is not ported raises NotImplementedError, the CLI runs the slice
on the CPU, and chip_smoke.py refuses to run without a card."""
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from eags_slam_torch.config import load_config
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops import composite_entries as ce
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.ops import rasterizer as TR
from eags_slam_torch.slam import tracker as TT
from eags_slam_torch.slam.gaussian_slam import GaussianSLAM

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "eags_slam_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_package_never_imports_jax(path):
    """No module of the port imports jax, jaxlib or eags_slam_tpu, and none
    names them in an import-like string."""
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "eags_slam_tpu"), \
            f"{path}: imports {mod}"
    text = path.read_text()
    assert "import jax" not in text and "from jax" not in text


def test_chip_smoke_never_imports_jax():
    for mod in _imports(REPO / "chip_smoke.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "eags_slam_tpu")


def _tiny(tmp_path, frames=1, **sections):
    cfg = load_config(str(REPO / "configs/synthetic/tiny.yaml"))
    cfg["device"] = "cpu"
    cfg["frame_limit"] = frames
    cfg["data"]["output_path"] = str(tmp_path / "out")
    for sec, d in sections.items():
        if isinstance(d, dict):
            cfg.setdefault(sec, {}).update(d)
        else:
            cfg[sec] = d
    return cfg


def test_gaussian_slam_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = _tiny(tmp_path)
    cfg["device"] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GaussianSLAM(cfg)


def test_kernel_wrappers_raise_without_cuda():
    """A non-CPU tensor never takes the plain twin: without CUDA the
    wrappers raise, and neither the kernels' nor the twins' counters
    move."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.load_kernels()
    meta = dict(device="meta")
    attrs = torch.empty((16, 384), **meta)
    ss = torch.empty((6, 3), dtype=torch.int32, **meta)
    ids = torch.empty(6, dtype=torch.int32, **meta)
    out = torch.empty((6, 8, 256), **meta)
    cs.reset_counts()
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cs.composite_sorted_fwd(attrs, ss, ss, ids, 16, 3, 3, 128)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cs.composite_sorted_bwd(attrs, ids, out, ss, out, 16, 3)
    jac = torch.empty((48, 384), **meta)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cs.pose_grad_sorted(attrs, jac, ids, out, ss, out, 16, 3)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cs.composite_sorted_bwd_window(attrs, ss, ids, out, ss, out, 16, 3,
                                       3, 128, 2)
    ce.reset_counts()
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ce.composite_entries_fwd(attrs, ids, ids, 16, 3)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ce.composite_entries_bwd(attrs, ids, ids, out, out, 16, 3)
    assert all(v == 0 for v in cs.counts().values())
    assert all(v == 0 for v in ce.counts().values())
    assert len(cs.counts()) == 8 and len(ce.counts()) == 4


@pytest.mark.parametrize("field,value", [
    ("backend", "jnp"), ("kernel_bf16", True), ("kernel_quadform", True)])
def test_unported_raster_options_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TR.check_config(TR.RasterConfig(**{field: value}))


@pytest.mark.parametrize("field,value", [("backend", "pallas"),
                                         ("rmw_window", True)])
def test_ported_raster_options_render(field, value):
    """The entry-binned backend (K5 / K6) and the windowed backward (K3)
    are ported: check_config accepts them, and a tiny render with its
    backward runs through their twins on the CPU."""
    cfg = TR.RasterConfig(**{field: value})
    TR.check_config(cfg)
    rng = np.random.default_rng(0)
    n = 40
    means = torch.as_tensor(np.stack(
        [rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
         rng.uniform(1.5, 2.5, n)], -1).astype(np.float32))
    means.requires_grad_(True)
    quats = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(n, 1)
    out = TR.render(means, quats, torch.full((n, 3), -3.0),
                    torch.ones((n, 1)), torch.rand((n, 3)), torch.eye(4),
                    Camera(50.0, 50.0, 15.5, 15.5, 32, 32), cfg)
    cs.reset_counts()
    ce.reset_counts()
    out.color.sum().backward()
    assert float(means.grad.abs().max()) > 0
    if field == "backend":
        assert ce.counts()["entries_bwd_twin_calls"] == 1
        assert cs.counts()["bwd_twin_calls"] == 0
    else:
        assert cs.counts()["window_twin_calls"] == 1
        assert cs.counts()["bwd_twin_calls"] == 0


@pytest.mark.parametrize("field", ["pose_grad_kernel", "debug_per_iter"])
def test_unported_tracker_options_raise(field):
    """debug_per_iter is not ported. The pose-contraction backward (K4) is,
    but not K1's bf16 option under it."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if field == "pose_grad_kernel":
            cam = Camera(50.0, 50.0, 15.5, 15.5, 32, 32)
            fs = TR.FrozenSorted(torch.zeros((16, 1152)),
                                 torch.zeros((4, 3), dtype=torch.int32),
                                 torch.zeros((4, 3), dtype=torch.int32))
            TR.render_frozen_sorted_pose(
                fs, torch.tensor([1.0, 0, 0, 0, 0, 0, 0]), torch.eye(4), cam,
                TR.RasterConfig(kernel_bf16=True))
        else:
            TT.check_config(TT.TrackerConfig(**{field: True}))


# Sections whose first entry is now ported keep their case with an added
# entry that still raises: the VO pinned to another device. Of the
# rasterizer's options only the K1 kernel options raise. The ported
# branches run in test_ported_config_branches_run (an edge crop of the
# synthetic_hard frames and the Replica reader among them).
@pytest.mark.parametrize("sections", [
    {"tracking": {"odometry_type": "odometer"}, "vo": {"device": "cpu"}},
    {"tracking": {"help_camera_initialization": True},
     "vo": {"device": "cuda:1"}},
    {"use_mesh": True},
    {"force_mesh": True},
    {"tracking": {"sp_track": True}},
    {"mapping": {"init_halfres_frac": 0.5}},
    {"mapping": {"kernel_bf16": True}},
    {"mapping": {"kernel_quadform": True}},
    {"mapping": {"tile_subset": 4}},
], ids=lambda s: next(iter(s)) + "." + str(next(iter(s.values()))))
def test_unported_config_branches_raise(tmp_path, sections):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GaussianSLAM(_tiny(tmp_path, **sections))


# A short, cheap run: 4 frames (frame 3 is the first with an odometer
# candidate), few iterations.
_CHEAP = {"mapping": {"iterations": 4, "new_submap_iterations": 8},
          "tracking": {"iterations": 4}}


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
    on the CPU."""
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


# The heavy stages at small settings (the tiny config's grid, GT cloud,
# samples, views and refine).
_SMALL_HEAVY = {"mesh_max_dim": 48, "gt_samples_per_frame": 1000,
                "mesh_samples": 2000, "unseen_views": 10, "unseen_res": 32,
                "global_refine_iters": 2}


@pytest.mark.parametrize("key", ["save_render", "eval_mesh", "eval_global"])
def test_ported_evaluation_runs(tmp_path, key, capsys):
    """Evaluation options that are ported run. `save_render`: the
    evaluator writes each keyframe's clipped render as
    eval_render/<frame>.png. `eval_mesh` / `eval_global` (the heavy
    stages, which raised before they were ported): `python -m
    eags_slam_torch.run_evaluation --checkpoint_path DIR --device cpu` on
    the run's saved files writes the stage's metrics and mesh files and
    prints the results."""
    from eags_slam_torch import run_evaluation
    from eags_slam_torch.evaluation.evaluator import Evaluator

    cfg = _tiny(tmp_path, frames=2, **_CHEAP)
    cfg["evaluation"] = {key: True, **_SMALL_HEAVY}
    gslam = GaussianSLAM(cfg)
    try:
        gslam.run()
        if key == "save_render":
            rend = Evaluator(str(tmp_path / "out"), gslam.dataset,
                             cfg).run_rendering_eval()
    finally:
        gslam.cleanup()
    out = tmp_path / "out"
    if key == "save_render":
        pngs = sorted(os.listdir(out / "eval_render"))
        assert len(pngs) == rend["num_views"] > 0
        with open(out / "eval_render" / pngs[0], "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        return
    run_evaluation.main(["--checkpoint_path", str(out), "--device", "cpu"])
    printed = capsys.readouterr().out
    with open(out / "evaluation.json") as f:
        results = json.load(f)
    stage, files = {
        "eval_mesh": ("reconstruction", ("reconstruction_metrics.json",
                                         "mesh/cleaned_mesh.ply")),
        "eval_global": ("global", ("rendering_metrics_global.json",
                                   "mesh/global_splats.ply"))}[key]
    assert set(results) == {"trajectory", "rendering", stage}
    assert repr(results[stage]["stage_s"]) in printed
    for name in files:
        assert (out / name).stat().st_size > 0, name
    if key == "eval_mesh":
        assert results[stage]["n_faces"] > 0
        assert 0.0 <= results[stage]["f1"] <= 1.0
    else:
        assert results[stage]["n_alive"] == results[stage]["n_gaussians"]
        assert np.isfinite(results[stage]["mean_psnr"])


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


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card(tmp_path, alone):
    """Without CUDA, and in a directory that holds chip_smoke.py and nothing
    else of the repo, the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


SCENE_CONFIGS = sorted(p for p in (REPO / "configs").glob("*/*.yaml")
                       if "scene_name:" in p.read_text())


@pytest.mark.parametrize("path", SCENE_CONFIGS,
                         ids=lambda p: str(p.relative_to(REPO / "configs")))
def test_scene_configs_pass_port_guards(path, monkeypatch):
    """Every scene configuration the repo ships passes every guard of the
    port's GaussianSLAM (its dataset name has a reader, no branch it selects
    raises NotImplementedError)."""
    from eags_slam_torch.slam.gaussian_slam import check_run_config

    monkeypatch.delenv("EAGS_RMW_WINDOW", raising=False)
    monkeypatch.delenv("EAGS_RCFG", raising=False)
    cfg = load_config(str(path))
    assert cfg["data"]["dataset_name"] in ("replica", "tum_rgbd", "scannet",
                                           "scannetpp")
    check_run_config(cfg)
    assert len(SCENE_CONFIGS) == 21


_NO_PIL = """
import importlib.abc, sys
class _NoPil(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("Pillow hidden")
sys.meta_path.insert(0, _NoPil())
import eags_slam_torch.datasets as D
from eags_slam_torch.utils import image_io
assert "PIL" not in sys.modules
try:
    image_io.read_jpeg(sys.argv[1])
except ImportError as e:
    print("RAISED", e)
"""


def test_datasets_import_without_pillow(tmp_path):
    """On a host without Pillow the port's datasets import, and a JPEG read
    raises ImportError naming the file (no quiet fallback)."""
    jpg = tmp_path / "frame000000.jpg"
    jpg.write_bytes(b"\xff\xd8\xff")
    res = subprocess.run([sys.executable, "-c", _NO_PIL, str(jpg)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "RAISED" in res.stdout and str(jpg) in res.stdout
    assert "JPEG needs Pillow" in res.stdout


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
