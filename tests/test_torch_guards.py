"""Guards of the PyTorch port: it never imports JAX or the JAX package, it
refuses a CUDA request without CUDA (no silent fallback to the CPU), every
rasterizer option renders (the dense `jnp` backend among them) and every
`vo.device` builds, and chip_smoke.py refuses to run without a card. The
runs of the ported config branches, the CLI and the evaluation options are
in tests/test_torch_config_branches.py, test_torch_config_options.py,
test_torch_cli.py and test_torch_eval_runs.py (which take `_tiny` and
`_CHEAP` from here)."""
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


# A short, cheap run: 4 frames (frame 3 is the first with an odometer
# candidate), few iterations.
_CHEAP = {"mapping": {"iterations": 4, "new_submap_iterations": 8},
          "tracking": {"iterations": 4}}


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
        cs.composite_sorted_bwd(attrs, ids, out, ss, out, 16, 3, 3)
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
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ce.gather_entries_bwd(attrs, ids.long(), 7)
    assert all(v == 0 for v in cs.counts().values())
    assert all(v == 0 for v in ce.counts().values())
    assert len(cs.counts()) == 8 and len(ce.counts()) == 6


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="not one of"):
        TR.check_config(TR.RasterConfig(backend="dense"))


@pytest.mark.parametrize("field,value", [
    ("backend", "pallas"), ("rmw_window", True), ("kernel_bf16", True),
    ("kernel_quadform", True), ("pose_grad_kernel", "kernel_bf16"),
    ("backend", "jnp")])
def test_ported_raster_options_render(field, value):
    """The entry-binned backend (K5 / K6), the windowed backward (K3), the
    K1-K4 variants kernel_bf16 / kernel_quadform and the dense `jnp`
    backend are ported: check_config accepts them, and a tiny render with
    its backward runs through their twins on the CPU (the `jnp` backend
    through plain PyTorch: no kernel, no twin); so does the
    pose-contraction path (K1 + K4) under kernel_bf16
    (`pose_grad_kernel`)."""
    cfg = TR.RasterConfig(**({field: value} if field != "pose_grad_kernel"
                             else {value: True}))
    TR.check_config(cfg)
    rng = np.random.default_rng(0)
    n = 40
    means = torch.as_tensor(np.stack(
        [rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
         rng.uniform(1.5, 2.5, n)], -1).astype(np.float32))
    means.requires_grad_(True)
    quats = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(n, 1)
    cam = Camera(50.0, 50.0, 15.5, 15.5, 32, 32)
    args = (means, quats, torch.full((n, 3), -3.0), torch.ones((n, 1)),
            torch.rand((n, 3)))
    cs.reset_counts()
    ce.reset_counts()
    if field == "pose_grad_kernel":
        fs = TR.freeze_sorted(*[a.detach() for a in args], torch.eye(4),
                              cam, cfg)
        qt = torch.tensor([1.0, 0, 0, 0, 0, 0, 0], requires_grad=True)
        out = TR.render_frozen_sorted_pose(fs, qt, torch.eye(4), cam, cfg)
        (d,) = torch.autograd.grad(out.color.sum(), qt)
        assert float(d.abs().max()) > 0
        assert cs.counts()["pose_twin_calls"] == 1
        return
    out = TR.render(*args, torch.eye(4), cam, cfg)
    out.color.sum().backward()
    assert float(means.grad.abs().max()) > 0
    if value == "jnp":
        assert not any({**cs.counts(), **ce.counts()}.values())
    elif field == "backend":
        assert ce.counts()["entries_bwd_twin_calls"] == 1
        assert cs.counts()["bwd_twin_calls"] == 0
    elif field == "rmw_window":
        assert cs.counts()["window_twin_calls"] == 1
        assert cs.counts()["bwd_twin_calls"] == 0
    else:
        assert cs.counts()["bwd_twin_calls"] == 1


# Every config branch is ported: the map and track options, the mesh
# options (wired below; run over two ranks in
# tests/test_torch_parallel_e2e.py) and the VO's device. The branches run
# in tests/test_torch_config_branches.py (an edge crop of the
# synthetic_hard frames and the Replica reader among them), the map and
# track options in tests/test_torch_config_options.py, the VO on the CPU,
# pipelined, in tests/test_torch_vo_cpu.py.
@pytest.mark.parametrize("sections", [
    {"tracking": {"odometry_type": "odometer"}, "vo": {"device": "cpu"}},
    {"tracking": {"help_camera_initialization": True},
     "vo": {"device": "cuda:1"}},
], ids=lambda s: next(iter(s)) + "." + str(next(iter(s.values()))))
def test_vo_device_configs_build(tmp_path, sections):
    """`vo.device: cpu` pins the VO to the host CPU with its one-worker
    pool; any other value (here "cuda:1") inherits the SLAM device, as in
    the JAX package: no pool, the VO steps on the tensors it is given."""
    gslam = GaussianSLAM(_tiny(tmp_path, **sections))
    try:
        on_cpu = sections["vo"]["device"] == "cpu"
        assert gslam.odometer is not None
        assert gslam.odometer.on_cpu is on_cpu
        assert (gslam._vo_pool is not None) is on_cpu
        rgb, depth = gslam._vo_inputs(0)
        assert rgb.device == (torch.device("cpu") if on_cpu
                              else gslam.device)
    finally:
        gslam.cleanup()


@pytest.mark.parametrize("sections,mesh_size,sp", [
    ({"use_mesh": True}, None, False),
    ({"force_mesh": True}, 1, False),
    ({"force_mesh": True, "tracking": {"sp_track": True}}, 1, True),
    ({"tracking": {"sp_track": True}}, None, False),
], ids=["use_mesh", "force_mesh", "force_mesh.sp_track", "sp_track"])
def test_mesh_options_are_wired(tmp_path, monkeypatch, sections, mesh_size,
                                sp):
    """The mesh options select the mesh paths as in the JAX package: one
    process with no process group has one device, so `use_mesh` builds no
    mesh; `force_mesh` builds a one-rank mesh on a one-rank gloo group
    (made here, destroyed by cleanup); `sp_track` splits the refinement
    over a mesh only. The force_mesh.sp_track case tracks two frames through
    the split refinement, its collectives issued at world size 1."""
    import torch.distributed as dist

    monkeypatch.delenv("EAGS_SP_TRACK", raising=False)
    frames = 3 if sp else 1
    cfg = _tiny(tmp_path, frames, **_CHEAP)
    for sec, d in sections.items():
        if isinstance(d, dict):
            cfg[sec].update(d)
        else:
            cfg[sec] = d
    # Two intra-op threads: the suite runs in several processes at once.
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    gslam = GaussianSLAM(cfg)
    try:
        assert (gslam.mesh.size if gslam.mesh is not None else None) \
            == mesh_size
        assert dist.is_initialized() is (mesh_size is not None)
        assert (gslam.tracker._sp_refine is not None) is sp
        report = gslam.run()
    finally:
        gslam.cleanup()
        torch.set_num_threads(threads)
    assert not dist.is_initialized()
    assert report["frames"] == frames
    if mesh_size is not None:
        assert report["mesh"]["replicated"] is True
        counts = report["mesh"]["collectives"]
        # Two tracked frames: a pose broadcast each, and with sp_track the
        # candidates' broadcast and the refinement's all-gathers (beside
        # the one of the replication check).
        assert counts["broadcast"] >= (4 if sp else 0)
        assert (counts["all_gather"] > 1) is sp


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
    port's GaussianSLAM (its dataset name has a reader, its backend is
    known)."""
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


