"""LPIPS(alex) of the port against the JAX package's, on a seeded weights
file with AlexNet's shapes written to the test's temp directory (the repo
ships no checkpoint; both modules' weight paths point at the file).

Tolerances: the same float32 convolutions summed in another order (XLA's
CPU convolution against oneDNN's): 1e-5 relative. Without the file both
return None. Both evaluators on one tiny port run's directory, each
rendering through its dense `jnp` backend (the JAX evaluator's default on
the CPU, set on the port's instance with the same tile capacity), report
`mean_lpips` within 1e-5 relative (the renders agree to ~1e-6; measured
2.5e-7).
"""
import pathlib

import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.evaluation import lpips as jl
from eags_slam_tpu.evaluation.evaluator import Evaluator as JEvaluator
from eags_slam_torch.config import load_config
from eags_slam_torch.evaluation import lpips as tl
from eags_slam_torch.evaluation.evaluator import Evaluator
from eags_slam_torch.slam.gaussian_slam import GaussianSLAM

REPO = pathlib.Path(__file__).resolve().parents[1]
# AlexNet's trunk as LPIPS uses it: (out, in, k) of conv1..conv5.
ALEX = ((64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3),
        (256, 256, 3))


def write_weights(path, seed=0):
    """A seeded npz with the checkpoint's keys and shapes (He-scaled
    convolutions, non-negative linear heads as LPIPS's)."""
    rng = np.random.default_rng(seed)
    z = {}
    for i, (o, c, k) in enumerate(ALEX, start=1):
        z[f"conv{i}_w"] = (rng.normal(size=(o, c, k, k))
                           * np.sqrt(2.0 / (c * k * k))).astype(np.float32)
        z[f"conv{i}_b"] = rng.normal(0, 0.05, o).astype(np.float32)
        z[f"lin{i}_w"] = rng.uniform(0, 0.2, (1, o, 1, 1)).astype(np.float32)
    np.savez(path, **z)
    return path


@pytest.fixture
def weights(tmp_path, monkeypatch):
    path = str(write_weights(tmp_path / "lpips_alex.npz"))
    monkeypatch.setattr(jl, "_WEIGHTS_PATH", path)
    monkeypatch.setattr(jl, "_NET", None)
    monkeypatch.setattr(tl, "WEIGHTS_PATH", path)
    monkeypatch.setattr(tl, "_NETS", {})
    return path


def _images(seed, h, w):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(64, 96), (136, 240)])
def test_lpips_matches_jax(weights, shape):
    a, b = _images(1, *shape)
    got = tl.lpips(torch.as_tensor(a), torch.as_tensor(b))
    want = jl.lpips(a, b)
    assert want is not None and want > 0
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    # The same image: zero distance.
    assert tl.lpips(torch.as_tensor(a), torch.as_tensor(a)) == 0.0


def test_lpips_none_without_weights(tmp_path, monkeypatch):
    missing = str(tmp_path / "absent.npz")
    monkeypatch.setattr(jl, "_WEIGHTS_PATH", missing)
    monkeypatch.setattr(jl, "_NET", None)
    monkeypatch.setattr(tl, "WEIGHTS_PATH", missing)
    monkeypatch.setattr(tl, "_NETS", {})
    a, b = _images(2, 64, 96)
    assert tl.lpips(torch.as_tensor(a), torch.as_tensor(b)) is None
    assert jl.lpips(a, b) is None


class _JaxView:
    """The port's dataset as the JAX evaluator reads it."""

    def __init__(self, ds):
        self._ds = ds
        self.camera = JCamera(*ds.camera)
        self.poses = ds.poses

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        return self._ds[i]


def test_evaluators_report_same_lpips(weights, tmp_path):
    cfg = load_config(str(REPO / "configs/synthetic/tiny.yaml"))
    cfg["device"] = "cpu"
    cfg["frame_limit"] = 2
    cfg["data"]["output_path"] = str(tmp_path / "run")
    cfg["mapping"].update({"iterations": 4, "new_submap_iterations": 8})
    gslam = GaussianSLAM(cfg)
    try:
        gslam.run()
        jev = JEvaluator(str(tmp_path / "run"), _JaxView(gslam.dataset),
                         cfg)
        j = jev.run_rendering_eval()
        ev = Evaluator(str(tmp_path / "run"), gslam.dataset, cfg)
        ev.rcfg = ev.rcfg._replace(backend="jnp",
                                   tile_capacity=jev.rcfg.tile_capacity,
                                   chunk=jev.rcfg.chunk)
        t = ev.run_rendering_eval()
    finally:
        gslam.cleanup()
    assert t["num_views"] == j["num_views"] > 0
    assert t["mean_lpips"] is not None and j["mean_lpips"] is not None
    assert np.isfinite(t["mean_lpips"]) and t["mean_lpips"] > 0
    assert abs(t["mean_psnr"] - j["mean_psnr"]) < 0.02, (t, j)
    assert abs(t["mean_lpips"] - j["mean_lpips"]) \
        <= 1e-5 * abs(j["mean_lpips"]), (t, j)
