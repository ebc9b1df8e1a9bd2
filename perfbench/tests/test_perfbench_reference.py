"""The plain reference imports nothing of the program or of JAX, agrees
with the program's rasterizer (its CPU twins) on a small map, and the run's
import check names exactly the forbidden top-level modules."""
from __future__ import annotations

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import check, reference, run
from perfbench.tests.tiny import ROOT

OPS = 2.0
PURE = ("reference.py", "check.py", "scene.py", "layouts.py", "traffic.py",
        "yardstick.py")


@pytest.mark.parametrize("name", PURE)
def test_reference_side_imports_no_program(name):
    tree = ast.parse((ROOT / "perfbench" / name).read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module.split(".")[0])
    assert not mods & {"eags_slam_torch", "eags_slam_tpu", "jax", "jaxlib",
                       "flax"}, mods


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import perfbench.reference, perfbench.check, "
            "perfbench.traffic; bad = [m for m in sys.modules if "
            "m.split('.')[0] in ('eags_slam_torch', 'eags_slam_tpu', 'jax')]"
            "; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_import_check_names_whole_top_level_modules(monkeypatch):
    for name in ("jax", "jax.numpy", "eags_slam_tpu", "eags_slam_tpu.ops",
                 "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "eags_slam_torch_extra", object())
    assert run.forbidden_modules() == ["eags_slam_tpu", "flax", "jax",
                                       "jaxlib"]


def test_import_check_accepts_the_port(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    import eags_slam_torch.slam.gaussian_slam  # noqa: F401

    assert run.forbidden_modules() == []


def _small_map(seed: int, n: int = 4000):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand((n, 3), generator=g) * torch.tensor([2.4, 1.6, 1.2]) \
        - torch.tensor([1.2, 0.8, -1.2])
    return {"xyz": xyz, "quats": torch.randn((n, 4), generator=g),
            "log_scales": torch.log(0.004 + 0.04 * torch.rand(
                (n, 3), generator=g)),
            "opacity_logits": torch.randn((n, 1), generator=g) * OPS,
            "f_dc": torch.randn((n, 3), generator=g)}


def _program(params, w2c, cam, rc, alive, cot, bf16=False):
    from eags_slam_torch.ops.rasterizer import render

    leaf = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = render(leaf["xyz"], leaf["quats"], leaf["log_scales"],
                 leaf["opacity_logits"], leaf["f_dc"] * reference.SH_C0 + 0.5,
                 w2c, cam, rc._replace(kernel_bf16=bf16), alive=alive)
    (torch.cat([out.color, out.depth[..., None], out.alpha[..., None]], -1)
     * cot).sum().backward()
    return {"color": out.color.detach(), "depth": out.depth.detach(),
            "alpha": out.alpha.detach(),
            "grads": {k: v.grad for k, v in leaf.items()}}


@pytest.mark.parametrize("tile,seed", [(16, 0), (32, 1)])
def test_reference_render_matches_the_program(tile, seed):
    from eags_slam_torch.core.camera import Camera
    from eags_slam_torch.ops.rasterizer import RasterConfig

    cam = Camera(90.0, 90.0, 79.5, 47.5, 160, 96)
    rc = RasterConfig(tile=tile, dup_side=3, seg_cap=1024, bands=3)
    params = _small_map(seed)
    alive = torch.rand(params["xyz"].shape[0],
                       generator=torch.Generator().manual_seed(9)) > 0.1
    w2c = torch.eye(4)
    cot = check.cotangent(96, 160, seed, "cpu")
    prog = _program(params, w2c, cam, rc, alive, cot)
    cam_d = {"fx": 90.0, "fy": 90.0, "cx": 79.5, "cy": 47.5, "W": 160,
             "H": 96}
    rast = {"tile": tile, "bands": 3, "seg_cap": 1024, "near": rc.near,
            "low_pass": rc.low_pass, "sigma_clip": rc.sigma_clip,
            "alpha_min": rc.alpha_min}
    ref = reference.render(params, w2c, cam_d, rast, alive=alive,
                           cotangent=cot)
    nums = check.render_numbers(prog, ref)
    assert float(ref[2].mean()) > 0.3     # the map covers the view
    assert nums["render_mae"] < 1e-6 and nums["render_depth_rel"] < 1e-6
    assert nums["grad_rel"] < 1e-4
    # The control: the program's bf16 kernels (their CPU twins) read far
    # above the sound run on the same map.
    ctl = check.render_numbers(_program(params, w2c, cam, rc, alive, cot,
                                        bf16=True), ref)
    assert ctl["render_mae"] > 30 * max(nums["render_mae"], 1e-9)
    assert ctl["grad_rel"] > 30 * nums["grad_rel"]


def test_ate():
    gt = np.tile(np.eye(4), (5, 1, 1))
    gt[:, 0, 3] = np.arange(5) * 0.01
    est = gt.copy()
    est[:, 1, 3] += np.array([0, 0, 0.01, 0.02, 0.0])
    assert check.ate_cm(est, gt) == pytest.approx(
        100 * np.sqrt((0.01 ** 2 + 0.02 ** 2) / 5))
