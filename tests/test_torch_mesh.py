"""Mesh extraction and reconstruction metrics of the port
(`evaluation/mesh.py`) against the JAX package on the same numpy inputs made
from a seed: a TSDF of a sphere and a small blob with an unobserved slab.

Tolerances, and why:
  - `surface_nets`: faces exactly equal (the same cells in the same order);
    vertices within 1e-9 (both place them in float64 from the same float32
    crossings, in the same order of additions).
  - `clean_mesh`, `sample_surface`: host numpy in both, exactly equal.
  - `mesh_metrics`: 1e-6. Both take float32 nearest distances through the
    |q|^2 - 2 q.r + |r|^2 expansion; the sums round differently (XLA fuses
    them), by about a float32 ulp of |q|^2 at these sub-metre coordinates.
  - `_zbuffer_batch`: which pixels are filled, exactly; depths within 1e-6
    relative (the camera transform in float32, fused by XLA). Points whose
    pixel sits within 1e-4 px of a half-pixel tie in some view (float64)
    are left out of its input, since float32 rounding decides them.
  - `unseen_depth_l1` at 40 views of 64 x 64: 1e-4 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.evaluation import mesh as JM
from eags_slam_torch.evaluation import mesh as TM


def _tsdf(seed=0, n=40, voxel=0.05):
    rng = np.random.default_rng(seed)
    origin = np.array([-1.0, -1.0, -1.0], np.float32)
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    p = origin + voxel * g
    d1 = np.linalg.norm(p - np.array([0.1, -0.05, 0.0]), axis=-1) - 0.6
    d2 = np.linalg.norm(p - np.array([0.75, 0.75, 0.75]), axis=-1) - 0.09
    sdf = np.clip(np.minimum(d1, d2) / (4 * voxel)
                  + rng.normal(0, 0.01, d1.shape), -1, 1).astype(np.float32)
    weight = rng.integers(1, 4, sdf.shape).astype(np.float32)
    weight[:, :, :4] = 0.0                  # an unobserved slab
    weight[rng.uniform(size=sdf.shape) < 0.002] = 0.0
    return sdf, weight, origin, voxel


@pytest.fixture(scope="module")
def meshes():
    sdf, weight, origin, voxel = _tsdf()
    jv, jf = JM.surface_nets(sdf, weight, origin, voxel)
    tv, tf = TM.surface_nets(torch.as_tensor(sdf), torch.as_tensor(weight),
                             origin, voxel)
    return (jv, jf), (tv, tf)


def test_surface_nets_matches_jax(meshes):
    (jv, jf), (tv, tf) = meshes
    assert tf.dtype == np.int64 and tv.dtype == np.float64
    assert len(jf) > 1000
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, atol=1e-9, rtol=0)
    # numpy inputs run on the CPU too; an empty grid gives an empty mesh.
    sdf, weight, origin, voxel = _tsdf()
    v2, f2 = TM.surface_nets(sdf, weight, origin, voxel)
    np.testing.assert_array_equal(f2, jf)
    ev, ef = TM.surface_nets(np.ones((5, 5, 5), np.float32),
                             np.ones((5, 5, 5), np.float32), origin, voxel)
    assert ev.shape == (0, 3) and ef.shape == (0, 3)


def test_clean_and_sample_match_jax(meshes):
    (jv, jf), (tv, tf) = meshes
    jcv, jcf = JM.clean_mesh(jv, jf)
    tcv, tcf = TM.clean_mesh(tv, tf)
    assert len(tcf) < len(tf)               # the blob is dropped
    np.testing.assert_array_equal(tcf, jcf)
    np.testing.assert_array_equal(tcv, jcv)
    np.testing.assert_array_equal(TM.sample_surface(tcv, tcf, 3000, seed=4),
                                  JM.sample_surface(jcv, jcf, 3000, seed=4))


def test_ply_round_trip(tmp_path, meshes):
    _, (tv, tf) = meshes
    TM.save_ply(str(tmp_path / "m.ply"), tv, tf)
    JM.save_ply(str(tmp_path / "j.ply"), tv, tf)
    assert (tmp_path / "m.ply").read_bytes() == (tmp_path / "j.ply") \
        .read_bytes()
    v, f = TM.load_ply(str(tmp_path / "m.ply"))
    np.testing.assert_array_equal(f, tf)
    np.testing.assert_allclose(v, tv, atol=5e-6, rtol=0)


def test_mesh_metrics_match_jax(meshes):
    (jv, jf), _ = meshes
    jcv, jcf = JM.clean_mesh(jv, jf)
    pred = JM.sample_surface(jcv, jcf, 4000, seed=1)
    rng = np.random.default_rng(2)
    gt = JM.sample_surface(jcv, jcf, 3000, seed=2) \
        + rng.normal(0, 0.01, (3000, 3))
    j = JM.mesh_metrics(pred, gt, tau=0.01)
    t = TM.mesh_metrics(pred, gt, tau=0.01, device="cpu")
    assert set(t) == set(j)
    assert 0.05 < t["f1"] < 0.95
    for k in j:
        assert abs(t[k] - j[k]) <= 1e-6, (k, t[k], j[k])


def _views(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([
        JM._viewmatrix(rng.normal(size=3), np.array([0.0, 0.0, -1.0]),
                       rng.uniform(-0.2, 0.2, 3)) for _ in range(n)])


def test_zbuffer_batch_matches_jax():
    rng = np.random.default_rng(5)
    res, focal = 64, 0.6 * 64
    c2ws = _views(6, 12)
    dirs = rng.normal(size=(6000, 3))
    pts = dirs / np.linalg.norm(dirs, axis=1, keepdims=True) \
        * rng.uniform(0.8, 1.2, (6000, 1))
    # Leave out the points whose pixel float32 rounding decides.
    w2c = np.linalg.inv(c2ws)
    p = np.einsum("nj,vij->vni", pts, w2c[:, :3, :3]) + w2c[:, None, :3, 3]
    z = np.maximum(p[..., 2], 1e-6)
    tie = np.zeros(pts.shape[0], bool)
    for c in (p[..., 0] / z * focal + res / 2 - 0.5,
              p[..., 1] / z * focal + res / 2 - 0.5):
        tie |= (np.abs(c - np.floor(c) - 0.5) < 1e-4).any(0)
    tie |= (np.abs(p[..., 2] - 0.05) < 1e-4).any(0)
    pts = pts[~tie].astype(np.float32)
    j = JM._zbuffer_batch(pts, c2ws, res, focal)
    t = TM._zbuffer_batch(pts, c2ws, res, focal, device="cpu").numpy()
    assert t.shape == (12, res, res) and (t > 0).mean() > 0.1
    np.testing.assert_array_equal(t > 0, j > 0)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


def test_unseen_depth_l1_matches_jax(meshes):
    (jv, jf), _ = meshes
    jcv, jcf = JM.clean_mesh(jv, jf)
    gt = JM.sample_surface(jcv, jcf, 20000, seed=7)
    pred = JM.sample_surface(jcv, jcf, 20000, seed=8) + 0.01
    j = JM.unseen_depth_l1(pred, gt, n_views=40, res=64)
    t = TM.unseen_depth_l1(pred, gt, n_views=40, res=64, device="cpu")
    assert 0.1 < j < 10.0
    assert abs(t - j) <= 1e-4 * abs(j), (t, j)
