"""The sorted backward through K3 (`rmw_window`) against the JAX package's
windowed backward (`_bwd_rmw_window`, Pallas interpret mode) on the hazard
scenes of tests/test_rasterizer_v2.py's test_window_rmw_*: group 2, an
unsorted tile subset, overfull bands at seg_cap 128, shuffled and repeated
tile ids, and a near-empty scene whose band windows overlap. On the CPU the
port's K3 call takes K2's twin (the same sums), so these tests hold the
routing and the sums; the kernel itself is held against the twin on the
card (tests/test_torch_kernels_cuda.py).

Tolerance: 1e-3 of each input's largest |grad|, as the sorted backend's
gradient parity test (tests/test_torch_modules.py): float32 sums in another
order through projection, gather and replay.

Also: `mapping.rmw_window`, `EAGS_RMW_WINDOW` and `EAGS_RCFG` reach the
RasterConfig of GaussianSLAM.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.ops import rasterizer as jr
from eags_slam_torch.config import load_config
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.ops import rasterizer as tr
from eags_slam_torch.slam.gaussian_slam import GaussianSLAM

REPO = pathlib.Path(__file__).resolve().parents[1]
CAM = (60.0, 60.0, 23.5, 15.5, 48, 32)
JCAM, TCAM = JCamera(*CAM), Camera(*CAM)
JCFG = jr.RasterConfig(tile=16, dup_side=4, chunk=16, backend="sorted",
                       seg_cap=256, bands=3, group=2, rmw_window=True)
TCFG = tr.RasterConfig(tile=16, dup_side=4, backend="sorted", seg_cap=256,
                       bands=3, group=2, rmw_window=True)
NUM_TILES = 6


def _scene(seed, n):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return (means, q,
            np.log(rng.uniform(0.02, 0.07, (n, 3))).astype(np.float32),
            rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32),
            np.eye(4, dtype=np.float32))


# (scene seed, gaussians, seg_cap, tile ids or None for the full frame)
CASES = {
    "unsorted_ids": (0, 48, 256, [5, 0, 3, 1]),
    "overflow": (1, 512, 128, None),
    "shuffled_repeated": (2, 300, 128, [4, 1, 5, 5, 0, 3, 2]),
    "sparse": (3, 6, 256, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_window_grads_match_jax_window(case):
    seed, n, seg_cap, ids = CASES[case]
    args = _scene(seed, n)
    jcfg = JCFG._replace(seg_cap=seg_cap)
    tcfg = TCFG._replace(seg_cap=seg_cap)

    def jloss(means, quats, ls, op, col):
        if ids is None:
            o = jr.render(means, quats, ls, op, col, jnp.asarray(args[5]),
                          JCAM, jcfg)
        else:
            o = jr.render_tiles(means, quats, ls, op, col,
                                jnp.asarray(args[5]),
                                jnp.asarray(ids, jnp.int32), JCAM, jcfg)
        return (jnp.mean(jnp.abs(o.color)) + 0.1 * jnp.mean(o.depth)
                + 0.05 * jnp.mean(o.alpha))

    jg = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in args[:5]))
    targs = [torch.as_tensor(a).requires_grad_(True) for a in args[:5]]
    w2c = torch.as_tensor(args[5])
    cs.reset_counts()
    if ids is None:
        o = tr.render(*targs, w2c, TCAM, tcfg)
    else:
        o = tr.render_tiles(*targs, w2c, torch.as_tensor(ids), TCAM, tcfg)
    loss = (torch.mean(torch.abs(o.color)) + 0.1 * torch.mean(o.depth)
            + 0.05 * torch.mean(o.alpha))
    tg = torch.autograd.grad(loss, targs)
    c = cs.counts()
    assert c["window_twin_calls"] == 1 and c["bwd_twin_calls"] == 0, c
    names = ["means", "quats", "log_scales", "opacity", "colors"]
    for name, a, b in zip(names, tg, jg):
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-3 * scale,
                                   err_msg=f"{case} {name}")
        assert np.abs(b).max() > 0, name


@pytest.mark.parametrize("source,value", [
    ("config", True), ("env", True), ("env_over_config", False),
    ("rcfg_env", True), ("default", False)])
def test_rmw_window_reaches_raster_config(tmp_path, monkeypatch, source,
                                          value):
    cfg = load_config(str(REPO / "configs/synthetic/tiny.yaml"))
    cfg["device"] = "cpu"
    cfg["frame_limit"] = 1
    cfg["data"]["output_path"] = str(tmp_path / "out")
    monkeypatch.delenv("EAGS_RMW_WINDOW", raising=False)
    monkeypatch.delenv("EAGS_RCFG", raising=False)
    if source in ("config", "env_over_config"):
        cfg["mapping"]["rmw_window"] = True
    if source in ("env", "env_over_config"):
        monkeypatch.setenv("EAGS_RMW_WINDOW", "1" if value else "0")
    if source == "rcfg_env":
        monkeypatch.setenv("EAGS_RCFG", "rmw_window=1,group=4")
    gslam = GaussianSLAM(cfg)
    try:
        assert gslam.rcfg.rmw_window is value
        assert gslam.rcfg.group == (4 if source == "rcfg_env" else 8)
    finally:
        gslam.cleanup()
