"""TSDF fusion of the port (`ops/tsdf.py`) against the JAX package on the
same numpy frames: JAX's plane scene (tests/test_reconstruction.py), and a
random depth, colour and pose fused on top of a second frame; the grid
bounds helpers exactly.

The two packages take the same float32 operations in the same order, but
XLA on the CPU contracts a multiply followed by an add into one fused
multiply-add (the voxel centres, the camera transform, the pixel
coordinates), PyTorch does not. So a voxel whose nearest pixel sits at a
half-pixel tie, or whose sdf sits at the -1 truncation test, to within
float32 rounding, can take the other decision: such voxels are found in
float64 from the same inputs (a tie matters only where the pixels on its
two sides differ), counted, and left out. Every other
voxel: weight exactly equal, colour within 1e-6, sdf within 1e-6 plus the
float32 rounding of the camera-frame depth over the truncation
(2 eps32 z_max / trunc).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.ops import tsdf as JT
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops import tsdf as TT

CAM = Camera(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=64, height=48)
EPS32 = float(np.finfo(np.float32).eps)


def _ambiguous(dims, origin, voxel, trunc, w2c, color, depth, cam,
               margin=1e-4):
    """Voxels whose update depends on float32 rounding (float64): the
    nearest pixel changes within `margin` of a half-pixel tie and the
    pixels on either side differ (in view, depth or colour), the sdf sits
    within `margin` of the -1 test, or z within `margin` of 0.05."""
    ii, jj, kk = np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")
    pts = np.asarray(origin, np.float64) + voxel * np.stack(
        [ii, jj, kk], -1).astype(np.float64)
    w2c = np.asarray(w2c, np.float64)
    p = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = p[..., 2]
    zc = np.maximum(z, 1e-6)
    u = p[..., 0] / zc * cam.fx + cam.cx
    v = p[..., 1] / zc * cam.fy + cam.cy
    looks = []
    for du in (-margin, margin):
        for dv in (-margin, margin):
            ur, vr = np.round(u + du), np.round(v + dv)
            inb = (ur >= 0) & (ur < cam.width) & (vr >= 0) & (vr < cam.height)
            ui = np.clip(ur, 0, cam.width - 1).astype(int)
            vi = np.clip(vr, 0, cam.height - 1).astype(int)
            looks.append((inb, np.asarray(depth, np.float64)[vi, ui],
                          np.asarray(color)[vi, ui]))
    amb = np.abs(z - 0.05) < margin
    for inb, d, c in looks:
        amb |= (inb != looks[0][0]) | (d != looks[0][1]) \
            | (c != looks[0][2]).any(-1)
        amb |= np.abs((d - z) / trunc + 1.0) < margin
    return amb, float(np.abs(z).max())


def _fuse_both(frames, origin, dims, voxel, trunc, slab=None, monkeypatch=None):
    jg = JT.make_grid(origin, dims, voxel, trunc)
    tg = TT.make_grid(origin, dims, voxel, trunc, device="cpu")
    if slab is not None:
        monkeypatch.setattr(TT, "SLAB_VOXELS", slab)
    amb = np.zeros(dims, bool)
    zmax = 0.0
    for color, depth, w2c in frames:
        jg = JT.integrate(jg, jnp.asarray(color), jnp.asarray(depth),
                          jnp.asarray(w2c), JCamera(*CAM))
        out = TT.integrate(tg, torch.as_tensor(color), torch.as_tensor(depth),
                           torch.as_tensor(w2c), CAM)
        assert out is tg
        a, z = _ambiguous(dims, origin, voxel, trunc, w2c, color, depth,
                          CAM)
        amb |= a
        zmax = max(zmax, z)
    return jg, tg, amb, zmax


def _check(jg, tg, amb, zmax, trunc, max_amb_frac):
    assert amb.mean() <= max_amb_frac, amb.mean()
    keep = ~amb
    jw, tw = np.asarray(jg.weight), tg.weight.numpy()
    np.testing.assert_array_equal(tw[keep], jw[keep])
    np.testing.assert_allclose(tg.color.numpy()[keep],
                               np.asarray(jg.color)[keep], atol=1e-6, rtol=0)
    np.testing.assert_allclose(tg.sdf.numpy()[keep], np.asarray(jg.sdf)[keep],
                               atol=1e-6 + 2 * EPS32 * zmax / trunc, rtol=0)
    assert jw.max() > 0 and (tw > 0).sum() > 0.05 * tw.size


def test_integrate_plane_scene_matches_jax():
    """JAX's plane scene: a flat wall at z = 2 seen from the origin."""
    depth = np.full((48, 64), 2.0, np.float32)
    color = np.full((48, 64, 3), 0.5, np.float32)
    jg, tg, amb, zmax = _fuse_both([(color, depth, np.eye(4, dtype=np.float32))],
                                   (-1.5, -1.5, 0.5), (48, 48, 48), 0.0625,
                                   0.25)
    _check(jg, tg, amb, zmax, 0.25, 0.05)
    k_wall = int(round((2.0 - 0.5) / 0.0625))
    mid = tg.sdf.numpy()[24, 24]
    assert mid[k_wall - 2] > 0.3 and mid[k_wall + 2] < 0.0


def test_integrate_random_frames_match_jax(monkeypatch):
    """Two frames of random depth (10% holes), colour and pose;
    evaluator-like voxel (8 x 5/512) and truncation (4
    voxels); slabs of 5000 voxels, so the grid is updated in 30 slabs."""
    rng = np.random.default_rng(0)
    frames = []
    for k in range(2):
        depth = (2.0 + 0.5 * rng.uniform(size=(48, 64))).astype(np.float32)
        depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
        color = rng.uniform(size=(48, 64, 3)).astype(np.float32)
        ang = (0.2, -0.13)[k]
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]]
        c2w[:3, 3] = rng.uniform(-0.2, 0.2, 3)
        frames.append((color, depth, np.linalg.inv(c2w).astype(np.float32)))
    voxel = 8 * 5.0 / 512.0
    trunc = 4 * voxel
    jg, tg, amb, zmax = _fuse_both(frames, (-1.7, -1.3, 0.3), (40, 52, 36),
                                   voxel, trunc, slab=5000,
                                   monkeypatch=monkeypatch)
    _check(jg, tg, amb, zmax, trunc, 0.01)


def test_grid_bounds_match_jax():
    rng = np.random.default_rng(3)
    depths = [(1.5 + rng.uniform(size=(48, 64))).astype(np.float32)
              for _ in range(3)]
    depths[1][:] = 0.0                      # a frame without depth
    c2ws = []
    for k in range(3):
        c2w = np.eye(4)
        c2w[:3, 3] = rng.uniform(-0.3, 0.3, 3)
        c2ws.append(c2w)
    for max_dim in (512, 40):
        a = JT.grid_bounds_from_depths(depths, c2ws, JCamera(*CAM), 0.02,
                                       max_dim=max_dim)
        b = TT.grid_bounds_from_depths(depths, c2ws, CAM, 0.02,
                                       max_dim=max_dim)
        np.testing.assert_array_equal(b[0], a[0])
        assert b[1] == a[1]
    empty = [np.zeros((48, 64), np.float32)] * 2
    a = JT.grid_bounds_from_depths(empty, c2ws[:2], JCamera(*CAM), 0.02)
    b = TT.grid_bounds_from_depths(empty, c2ws[:2], CAM, 0.02)
    np.testing.assert_array_equal(b[0], a[0])
    assert b[1] == a[1]
    a = JT.grid_bounds_from_trajectory(np.stack(c2ws), 3.0, 0.05, 64)
    b = TT.grid_bounds_from_trajectory(np.stack(c2ws), 3.0, 0.05, 64)
    np.testing.assert_array_equal(b[0], a[0])
    assert b[1] == a[1]
