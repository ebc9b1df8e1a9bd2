"""Guards of the PyTorch port: it never imports JAX or the JAX package, it
refuses a CUDA request without CUDA (no silent fallback to the CPU), every
branch that is not ported raises NotImplementedError, the CLI runs the slice
on the CPU, and chip_smoke.py refuses to run without a card."""
import ast
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
# entry that still raises: the VO pinned to another device, and an edge
# crop of the synthetic_hard frames (the readers that crop are not
# ported). Of the rasterizer's options only the K1 kernel options raise.
# The ported branches run in test_ported_config_branches_run.
@pytest.mark.parametrize("sections", [
    {"tracking": {"odometry_type": "odometer"}, "vo": {"device": "cpu"}},
    {"tracking": {"help_camera_initialization": True},
     "vo": {"device": "cuda:1"}},
    {"lc": {"enabled": True}},
    {"use_mesh": True},
    {"force_mesh": True},
    {"tracking": {"sp_track": True}},
    {"mapping": {"init_halfres_frac": 0.5}},
    {"mapping": {"kernel_bf16": True}},
    {"mapping": {"kernel_quadform": True}},
    {"mapping": {"tile_subset": 4}},
    {"data": {"dataset_name": "synthetic_hard"}, "cam": {"crop_edge": 8}},
    {"data": {"dataset_name": "replica"}},
], ids=lambda s: next(iter(s)) + "." + str(next(iter(s.values()))))
def test_unported_config_branches_raise(tmp_path, sections):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GaussianSLAM(_tiny(tmp_path, **sections))


# A short, cheap run: 4 frames (frame 3 is the first with an odometer
# candidate), few iterations.
_CHEAP = {"mapping": {"iterations": 4, "new_submap_iterations": 8},
          "tracking": {"iterations": 4}}


@pytest.mark.parametrize("case", [
    "odometer", "odometer_coupled", "help_camera_initialization",
    "synthetic_hard", "pose_grad_kernel", "rmw_window", "backend_pallas"])
def test_ported_config_branches_run(tmp_path, monkeypatch, case):
    """The branches that used to raise now run: the edge VO (as the
    odometer, decoupled or coupled, or only scoring its candidate), the
    synthetic_hard scene, the pose-contraction backward, the windowed
    backward (`mapping.rmw_window`) and the entry-binned backend
    (`EAGS_RCFG=backend=pallas`), each through its twins on the CPU."""
    sections = {
        "odometer": {"tracking": {"odometry_type": "odometer"}},
        "odometer_coupled": {"tracking": {"odometry_type": "odometer"},
                             "vo": {"decoupled": False}},
        "help_camera_initialization": {
            "tracking": {"help_camera_initialization": True}},
        "synthetic_hard": {"data": {"dataset_name": "synthetic_hard",
                                    "n_frames": 4}},
        "pose_grad_kernel": {"tracking": {"pose_grad_kernel": True}},
        "rmw_window": {"mapping": {"rmw_window": True}},
        "backend_pallas": {},
    }[case]
    monkeypatch.delenv("EAGS_RMW_WINDOW", raising=False)
    monkeypatch.delenv("EAGS_RCFG", raising=False)
    if case == "backend_pallas":
        monkeypatch.setenv("EAGS_RCFG", "backend=pallas")
    cfg = _tiny(tmp_path, frames=4, **_CHEAP)
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
    cands = report["tracker"]["init_pose_cnt"]
    assert sum(cands.values()) == 2
    if "odometer" in case or case == "help_camera_initialization":
        assert report["vo"]["n_keyframes"] >= 1
        assert (tmp_path / "out" / "vo_traj_tum.txt").exists()
    else:
        assert "vo" not in report
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


@pytest.mark.parametrize("key", ["eval_mesh", "eval_global", "save_render"])
def test_unported_evaluation_raises(key):
    from eags_slam_torch.evaluation.evaluator import check_config

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_config({"evaluation": {key: True}})
    check_config(load_config(str(REPO / "configs/synthetic/tiny.yaml")))


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
