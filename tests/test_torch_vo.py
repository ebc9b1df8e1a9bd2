"""The port's edge VO against the JAX package's on the CPU: the image ops it
needs, se3_exp, the edge pyramid, one LM alignment, and EdgeVO over 6 frames
of synthetic_hard at 64x96 (the JAX dataset's frames, 1/72 orbit a frame,
the default VO settings). At bench.py's 1.5/72 the VO loses track at this
size, and where it has lost track the two packages' float32 rounding (and
PyTorch's thread count) send it to different wrong poses.

Tolerances: image ops and se3_exp 1e-5 relative to the largest |value|
(float32 rounding of the convolutions); the distance transform is exact
(integer squared distances); edge masks, edge counts and the selected edge
points are equal, their 3D coordinates to 1e-5 relative; LM R and t to 1e-4
(the same iterates; the 6x6 solves and reductions round differently);
EdgeVO poses to 1e-3 m and the same keyframe ids.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.config import load_config as j_load_config
from eags_slam_tpu.core import se3 as JS
from eags_slam_tpu.ops import image as JI
from eags_slam_tpu.synthetic_hard import SyntheticHard as JSyntheticHard
from eags_slam_tpu.vo import lm as JL
from eags_slam_tpu.vo import pyramid as JP
from eags_slam_tpu.vo.system import EdgeVO as JEdgeVO
from eags_slam_tpu.vo.system import VOConfig as JVOConfig
from eags_slam_torch.core import se3 as TS
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops import image as TI
from eags_slam_torch.vo import lm as TL
from eags_slam_torch.vo import pyramid as TP
from eags_slam_torch.vo.system import EdgeVO, VOConfig

N_FRAMES = 6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frames():
    """The JAX synthetic_hard frames at 64x96 (uint8 colour, the float16
    depth the SLAM loop reads), GT poses and the camera."""
    cfg = j_load_config("configs/synthetic/tiny.yaml")
    cfg["data"].update({"dataset_name": "synthetic_hard",
                        "n_frames": N_FRAMES, "orbit_speed": 1.0 / 72})
    ds = JSyntheticHard(cfg)
    rgb = [np.asarray(ds._dev_cache[i][0]) for i in range(N_FRAMES)]
    depth = [np.asarray(ds._dev_cache[i][1]).astype(np.float32)
             for i in range(N_FRAMES)]
    return rgb, depth, [np.asarray(p) for p in ds.poses], ds.full_camera


def _close(t, j, rtol=1e-5):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_allclose(t, j, atol=rtol * max(np.abs(j).max(), 1e-12))


@pytest.mark.parametrize("name", ["gaussian_blur5", "pyr_down", "scharr",
                                  "dt", "bilinear_sample"])
def test_image_ops_match_jax(name, frames):
    gray = np.asarray(JI.rgb_to_gray(frames[0][0].astype(np.float32)))
    tg = torch.as_tensor(gray)
    if name in ("gaussian_blur5", "pyr_down"):
        _close(getattr(TI, name)(tg), getattr(JI, name)(jnp.asarray(gray)))
    elif name == "scharr":
        for t, j in zip(TI.scharr(tg), JI.scharr(jnp.asarray(gray))):
            _close(t, j)
    elif name == "dt":
        edges = np.asarray(JI.canny(jnp.asarray(gray), 100.0, 200.0))
        assert edges.sum() > 20
        assert np.array_equal(TI.canny(tg, 100.0, 200.0).numpy(), edges)
        for window in (8, 32):
            t = TI.dt_with_gradients(torch.from_numpy(edges.copy()), window)
            j = JI.dt_with_gradients(jnp.asarray(edges), window)
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        rng = np.random.default_rng(0)
        uv = rng.uniform(-5, 100, (400, 2)).astype(np.float32)
        tv, tin = TI.bilinear_sample(tg, torch.as_tensor(uv))
        jv, jin = JI.bilinear_sample(jnp.asarray(gray), jnp.asarray(uv))
        _close(tv, jv)
        assert np.array_equal(tin.numpy(), np.asarray(jin))


def test_se3_exp_matches_jax():
    rng = np.random.default_rng(1)
    tau = rng.normal(scale=0.3, size=(16, 6)).astype(np.float32)
    tau[0, 3:] = 0.0                   # the small-angle branch
    tau[1, 3:] = 1e-5
    _close(TS.se3_exp(torch.as_tensor(tau)), JS.se3_exp(jnp.asarray(tau)))


def _pyramids(rgb, depth, cam, cfg):
    j = JP.build_pyramid(rgb, jnp.asarray(depth), cam, cfg.levels,
                         cfg.max_edge_points, cfg.canny_low, cfg.canny_high,
                         cfg.depth_min, cfg.depth_max)
    t = TP.build_pyramid(torch.as_tensor(rgb), torch.as_tensor(depth),
                         Camera(*cam), cfg.levels, cfg.max_edge_points,
                         cfg.canny_low, cfg.canny_high, cfg.depth_min,
                         cfg.depth_max)
    return j, t


def test_pyramid_matches_jax(frames):
    rgb, depth, _, cam = frames
    cfg = VOConfig()
    j, t = _pyramids(rgb[1], depth[1], cam, cfg)
    for lj, lt in zip(j.levels, t.levels):
        assert np.array_equal(lt.edges.numpy(), np.asarray(lj.edges))
        assert int(lt.edge_count) == int(lj.edge_count) > 0
        assert np.array_equal(lt.pts_valid.numpy(), np.asarray(lj.pts_valid))
        _close(lt.pts, lj.pts)
        _close(lt.depth, lj.depth)
    for kj, kt in zip(JP.make_keyframe(j, cfg.dt_window),
                      TP.make_keyframe(t, cfg.dt_window)):
        for a, b in zip(kt, kj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lm_align_matches_jax(frames):
    """Frame 1's finest edge points against frame 0's keyframe DT, from the
    GT relative pose moved by a few centimetres. (Not from the identity:
    there every edge point of the image border projects onto the border to
    within rounding, so XLA's fused and PyTorch's eager float32 put
    different points in bounds.)"""
    rgb, depth, poses, cam = frames
    cfg = VOConfig()
    j0, t0 = _pyramids(rgb[0], depth[0], cam, cfg)
    j1, t1 = _pyramids(rgb[1], depth[1], cam, cfg)
    jk = JP.make_keyframe(j0, cfg.dt_window)[0]
    tk = TP.make_keyframe(t0, cfg.dt_window)[0]
    js = JL.LMSettings(dist_filter=30.0)
    ts = TL.LMSettings(dist_filter=30.0)
    T0 = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    R0, t0 = T0[:3, :3], T0[:3, 3] + np.float32([0.02, -0.015, 0.01])
    jr = JL.lm_align(j1.levels[0].pts, j1.levels[0].pts_valid, jk.gx, jk.gy,
                     jk.dt, jnp.asarray(R0), jnp.asarray(t0), cam, js)
    tr = TL.lm_align(t1.levels[0].pts, t1.levels[0].pts_valid, tk.gx, tk.gy,
                     tk.dt, torch.as_tensor(R0), torch.as_tensor(t0),
                     Camera(*cam), ts)
    assert int(jr.iters) == tr.iters > 1
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-4)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-4)
    np.testing.assert_allclose(tr.cost, float(jr.cost), rtol=1e-4)
    assert (tr.good, tr.bad) == (int(jr.good), int(jr.bad))


def test_edge_vo_matches_jax(frames):
    rgb, depth, poses, cam = frames
    jvo = JEdgeVO(JVOConfig(), cam)
    tvo = EdgeVO(VOConfig(), Camera(*cam))
    for i in range(N_FRAMES):
        if i == 0:
            jvo.set_pose(0, poses[0])
            tvo.set_pose(0, poses[0])
        pj = jvo.step(jnp.asarray(rgb[i]), jnp.asarray(depth[i]), i / 30.0)
        pt = tvo.step(torch.as_tensor(rgb[i]), torch.as_tensor(depth[i]),
                      i / 30.0)
        np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=1e-3)
        np.testing.assert_allclose(pt[:3, :3], pj[:3, :3], atol=1e-3)
        if i < 2:                      # GaussianSLAM's GT injection
            jvo.set_pose(i, poses[i])
            tvo.set_pose(i, poses[i])
        assert np.array_equal(tvo.get_edge_image(i).numpy(),
                              np.asarray(jvo.get_edge_image(i)))
    assert [k.frame_id for k in tvo.keyframes] == \
        [k.frame_id for k in jvo.keyframes]
    assert tvo.report()["n_keyframes"] == jvo.report()["n_keyframes"]
