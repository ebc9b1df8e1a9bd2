"""The pose-contraction backward (K4) of the port on the CPU: its plain twin
`pose_grad_sorted_plain` and the jacobian `_pose_jacobian`, against the JAX
package's `render_frozen_sorted(_tiles)_pose` (K4 in Pallas interpret mode)
and against the port's own K2-twin chain (autograd through the
reprojection). The CUDA kernel itself is held against the twin on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Both sides render the JAX FrozenSorted layout of the same numpy scene.
Tolerances: the jacobian 1e-5 relative to each row's largest entry; pose
grads 2e-4 of the largest |g| (tests/test_rasterizer_pose.py: the same
chain-rule sum in another association order); losses 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.ops import rasterizer as jr
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.ops import rasterizer as tr
from eags_slam_torch.slam.tracker import _rel_matrix

QT0 = np.array([0.999, 0.01, -0.02, 0.015, 0.01, -0.02, 0.03], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _scene(n, h, w, seed, scale_hi=0.06, left_only=False):
    rng = np.random.default_rng(seed)
    cam = (150.0, 150.0, (w - 1) / 2, (h - 1) / 2, w, h)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n),
                      rng.uniform(0.5, 5, n)], -1).astype(np.float32)
    if left_only:
        means[:, 0] = -np.abs(means[:, 0]) - 0.5
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    ls = np.log(rng.uniform(0.01, scale_hi, (n, 3))).astype(np.float32)
    op = rng.uniform(0.5, 3.0, (n, 1)).astype(np.float32)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return cam, (means, quats, ls, op, col)


def _frozen(cam, arrs, seg_cap, last_w2c):
    jcfg = jr.RasterConfig(tile=16, group=2, backend="sorted",
                           seg_cap=seg_cap, bands=3)
    fs = jr.freeze_sorted(*(jnp.asarray(a) for a in arrs),
                          jnp.asarray(last_w2c), JCamera(*cam), jcfg)
    tfs = tr.FrozenSorted(*(torch.as_tensor(np.array(a)) for a in fs))
    tcfg = tr.RasterConfig(tile=16, seg_cap=seg_cap, bands=3)
    return fs, jcfg, tfs, tcfg


def _loss(color, depth, alpha):
    return (color.sum() + 0.3 * depth.sum() + (alpha ** 2).sum()
            + (color * color).sum())


def _jax_grad(fs, jcfg, cam, last_w2c, tile_ids):
    def f(qt):
        if tile_ids is None:
            out = jr.render_frozen_sorted_pose(fs, qt, jnp.asarray(last_w2c),
                                               JCamera(*cam), jcfg)
        else:
            out = jr.render_frozen_sorted_tiles_pose(
                fs, qt, jnp.asarray(last_w2c), jnp.asarray(tile_ids),
                JCamera(*cam), jcfg)
        return _loss(out.color, out.depth, out.alpha)
    v, g = jax.value_and_grad(f)(jnp.asarray(QT0))
    return float(v), np.asarray(g)


def _port_grad(tfs, tcfg, cam, last_w2c, tile_ids, pose_kernel: bool):
    qt = torch.as_tensor(QT0).requires_grad_(True)
    lw = torch.as_tensor(last_w2c)
    cam = Camera(*cam)
    if pose_kernel:
        if tile_ids is None:
            out = tr.render_frozen_sorted_pose(tfs, qt, lw, cam, tcfg)
        else:
            out = tr.render_frozen_sorted_tiles_pose(
                tfs, qt, lw, torch.as_tensor(tile_ids), cam, tcfg)
    else:
        w2c = lw @ _rel_matrix(qt[:4], qt[4:])
        if tile_ids is None:
            out = tr.render_frozen_sorted(tfs, w2c, cam, tcfg)
        else:
            out = tr.render_frozen_sorted_tiles(
                tfs, w2c, torch.as_tensor(tile_ids), cam, tcfg)
    v = _loss(out.color, out.depth, out.alpha)
    (g,) = torch.autograd.grad(v, qt)
    return float(v.detach()), g.numpy()


def _assert_close(a, b, rtol=2e-4):
    (v1, g1), (v2, g2) = a, b
    assert np.isfinite(g1).all() and np.isfinite(g2).all()
    np.testing.assert_allclose(v1, v2, rtol=1e-5)
    denom = max(float(np.abs(g1).max()), 1e-6)
    np.testing.assert_allclose(g1 / denom, g2 / denom, atol=rtol)


# The cases share one scene size where they can, so that the JAX layout is
# compiled once for them.
CASES = {
    # name: (n, h, w, seed, seg_cap, tile ids (None = full grid), scale_hi)
    "subset_shuffled": (1200, 48, 96, 0, 256, "shuffled", 0.06),
    "full_grid": (1200, 48, 96, 3, 256, None, 0.06),
    "overflow": (6000, 48, 96, 5, 128, "all", 0.12),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pose_twin_matches_jax_and_k2_chain(case):
    n, h, w, seed, seg_cap, ids, scale_hi = CASES[case]
    cam, arrs = _scene(n, h, w, seed, scale_hi)
    last_w2c = np.eye(4, dtype=np.float32)
    last_w2c[0, 3] = 0.05
    fs, jcfg, tfs, tcfg = _frozen(cam, arrs, seg_cap, last_w2c)
    num_tiles = (-(-w // 16)) * (-(-h // 16))
    if ids == "shuffled":
        tile_ids = np.random.default_rng(seed + 7).permutation(
            num_tiles)[: num_tiles // 3].astype(np.int32)
    elif ids == "all":
        tile_ids = np.arange(num_tiles, dtype=np.int32)
    else:
        tile_ids = None
    if case == "overflow":
        assert int((np.asarray(fs.seg_start) % 128
                    + np.asarray(fs.seg_cnt)).max()) == 128   # clipped
    cs.reset_counts()
    port_k4 = _port_grad(tfs, tcfg, cam, last_w2c, tile_ids, True)
    assert cs.counts()["pose_twin_calls"] == 1
    assert cs.counts()["bwd_twin_calls"] == 0
    _assert_close(_jax_grad(fs, jcfg, cam, last_w2c, tile_ids), port_k4)
    _assert_close(_port_grad(tfs, tcfg, cam, last_w2c, tile_ids, False),
                  port_k4)


def test_pose_twin_empty_tiles_zero():
    cam, arrs = _scene(1200, 48, 96, 6, left_only=True)
    last_w2c = np.eye(4, dtype=np.float32)
    fs, jcfg, tfs, tcfg = _frozen(cam, arrs, 256, last_w2c)
    tiles_x = 96 // 16
    right = np.array([r * tiles_x + tiles_x - 1 for r in range(3)], np.int32)
    _, g = _port_grad(tfs, tcfg, cam, last_w2c, right, True)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, 0.0, atol=1e-6)


def test_pose_jacobian_matches_jax():
    cam, arrs = _scene(1200, 48, 96, 9)
    last_w2c = np.eye(4, dtype=np.float32)
    last_w2c[:3, 3] = [0.05, -0.02, 0.1]
    fs, jcfg, tfs, tcfg = _frozen(cam, arrs, 256, last_w2c)
    j = np.asarray(jr._pose_jacobian(fs.e3d, jnp.asarray(QT0),
                                     jnp.asarray(last_w2c), JCamera(*cam),
                                     jcfg))
    t = tr._pose_jacobian(tfs.e3d, torch.as_tensor(QT0),
                          torch.as_tensor(last_w2c), Camera(*cam),
                          tcfg).numpy()
    assert t.shape == j.shape == (48, tfs.e3d.shape[1])
    scale = np.maximum(np.abs(j).max(1, keepdims=True), 1e-12)
    np.testing.assert_allclose(t / scale, j / scale, atol=1e-5)
    assert np.abs(t[42:]).max() == 0.0
