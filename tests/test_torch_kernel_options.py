"""The kernel_quadform / kernel_bf16 options of K1-K4 in the port against
the JAX sorted backend under the same option (Pallas interpret mode), on
the scenes of tests/test_rasterizer_v2.py (48x32, tile 16, seg_cap 256)
and, for the pose path, a 64x48 cut of tests/test_rasterizer_pose.py's.
On the CPU the port takes the kernels' plain twins under the option. (The
kernels against their twins under each option: tests/test_torch_kernels_
cuda.py, on the card.)

  - The bf16 layout and its float32 rebuild equal JAX's `to_bf16_layout`
    and `_rebuild_f32` bit for bit.
  - quadform: renders (colour, depth, alpha) and the grads of the means,
    log-scales and opacities within 2e-4 (grads: of their largest
    magnitude) of JAX's quadform render, through K1 + K2, through K3
    (`rmw_window`) and on a tile subset; the frozen-sorted pose path (K1 +
    K4) within 1e-5 relative in value and 2e-4 of the largest |dpose|
    (the atols of tests/test_rasterizer_v2.py:131-141 and
    tests/test_rasterizer_pose.py:109-118).
  - bf16: within the envelope the JAX package sets for the option
    (tests/test_rasterizer_v2.py:105-128): colour 2e-2 max and 2e-3 mean,
    alpha 2e-2, the means' grad 2e-2 of its largest magnitude. The port
    reproduces the layout exactly but keeps the transmittance and the
    backward's suffix sums in float32, where the TPU kernel also rounds
    its triangular matmuls' inputs to bf16; the envelope covers both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.ops import rasterizer as jr
from eags_slam_tpu.ops import rasterizer_pallas_v2 as jv2
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.ops import rasterizer as tr

CAM = Camera(60.0, 60.0, 23.5, 15.5, 48, 32)
JCAM = JCamera(*CAM)
JCFG = jr.RasterConfig(tile=16, dup_side=4, chunk=16, backend="sorted",
                       seg_cap=256, bands=3, group=2)
TCFG = tr.RasterConfig(tile=16, dup_side=4, seg_cap=256, bands=3, group=2)


def _scene(seed, n=48):
    """tests/test_rasterizer_v2.py's make_scene, as numpy."""
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


def test_bf16_layout_matches_jax():
    """u, v and depth as hi / lo pairs (values up to ~1e3 px and metres
    with small remainders), the rest single bf16; the rebuild hi + lo."""
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(16, 384)) * np.exp(rng.uniform(-6, 7, (16, 384)))
         ).astype(np.float32)
    a[:, :8] = np.float32([0.0, -0.0, 1.0, 1e-30, 3e38, -1.5, 65504.0,
                           1.0 + 2.0 ** -20])
    j_lay = np.asarray(jv2.to_bf16_layout(jnp.asarray(a)))
    t_lay = cs.to_bf16_layout(torch.as_tensor(a))
    assert t_lay.dtype == torch.bfloat16 and t_lay.shape == (16, 384)
    np.testing.assert_array_equal(t_lay.view(torch.int16).numpy(),
                                  j_lay.view(np.int16))
    j_f32 = np.zeros((16, 384), np.float32)
    jv2._rebuild_f32(j_f32, jnp.asarray(j_lay))
    t_f32 = cs.rebuild_f32(t_lay).numpy()
    np.testing.assert_array_equal(t_f32.view(np.int32), j_f32.view(np.int32))
    # The pairs keep ~16 bits: u, v and depth within 2^-16 relative.
    for row in (0, 1, 9):
        np.testing.assert_allclose(t_f32[row], a[row], rtol=2.0 ** -15)


def _jax_loss(cfg, target):
    def f(means, ls, op, q, col, w2c):
        out = jr.render(means, q, ls, op, col, w2c, JCAM, cfg)
        return (jnp.mean(jnp.abs(out.color - target))
                + 0.1 * jnp.mean(out.depth) + 0.05 * jnp.mean(out.alpha))
    return f


def _both_renders(seed, jcfg, tcfg):
    """Render + the grads of means, log-scales and opacities in both
    packages. Returns (jax out, jax grads, port out, port grads)."""
    args = _scene(seed)
    target = np.random.default_rng(seed + 100).uniform(
        0, 1, (CAM.height, CAM.width, 3)).astype(np.float32)
    ja = [jnp.asarray(x) for x in args]
    j_out = jr.render(*ja, JCAM, jcfg)
    j_g = jax.grad(_jax_loss(jcfg, jnp.asarray(target)), argnums=(0, 1, 2))(
        ja[0], ja[2], ja[3], ja[1], ja[4], ja[5])
    ta = [torch.as_tensor(x) for x in args]
    for i in (0, 2, 3):
        ta[i].requires_grad_(True)
    t_out = tr.render(*ta, CAM, tcfg)
    loss = ((t_out.color - torch.as_tensor(target)).abs().mean()
            + 0.1 * t_out.depth.mean() + 0.05 * t_out.alpha.mean())
    loss.backward()
    return (j_out, [np.asarray(g) for g in j_g], t_out,
            [ta[i].grad.numpy() for i in (0, 2, 3)])


@pytest.mark.parametrize("backward", ["k2", "k3_window"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quadform_render_matches_jax(seed, backward):
    window = backward == "k3_window"
    jcfg = JCFG._replace(kernel_quadform=True, rmw_window=window)
    tcfg = TCFG._replace(kernel_quadform=True, rmw_window=window)
    cs.reset_counts()
    j_out, j_g, t_out, t_g = _both_renders(seed, jcfg, tcfg)
    c = cs.counts()
    assert c["fwd_twin_calls"] == 1
    assert c["window_twin_calls" if window else "bwd_twin_calls"] == 1
    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(getattr(t_out, name).detach().numpy(),
                                   np.asarray(getattr(j_out, name)),
                                   atol=2e-4, err_msg=name)
    assert float(t_out.alpha.detach().max()) > 0.5
    for name, jg, tg in zip(("means", "log_scales", "opacity"), j_g, t_g):
        scale = max(np.abs(jg).max(), 1e-9)
        np.testing.assert_allclose(tg / scale, jg / scale, atol=2e-4,
                                   err_msg=name)


def test_quadform_tiles_match_jax():
    """render_tiles (the mapper's tile subset) on shuffled tiles."""
    args = _scene(2)
    tile_ids = np.array([4, 0, 5], np.int32)
    jcfg = JCFG._replace(kernel_quadform=True)
    j = jr.render_tiles(*[jnp.asarray(x) for x in args],
                        jnp.asarray(tile_ids), JCAM, jcfg)
    t = tr.render_tiles(*[torch.as_tensor(x) for x in args],
                        torch.as_tensor(tile_ids), CAM,
                        TCFG._replace(kernel_quadform=True))
    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), atol=2e-4,
                                   err_msg=name)


def _pose_scene(seed, n=400):
    """tests/test_rasterizer_pose.py's scene on a 64x48 camera."""
    rng = np.random.default_rng(seed)
    cam = Camera(40.0, 40.0, 31.5, 23.5, 64, 48)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(1.0, 5, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return cam, (means, q,
                 np.log(rng.uniform(0.02, 0.12, (n, 3))).astype(np.float32),
                 rng.uniform(0.5, 3.0, (n, 1)).astype(np.float32),
                 rng.uniform(0, 1, (n, 3)).astype(np.float32))


QT0 = np.array([0.999, 0.01, -0.02, 0.015, 0.01, -0.02, 0.03], np.float32)


def _pose_value_grad(seed, quadform, bf16):
    """The frozen-sorted pose path (K1 + K4) in both packages on the same
    frozen layout; loss of tests/test_rasterizer_pose.py."""
    cam, arrs = _pose_scene(seed)
    kw = dict(tile=16, group=4, seg_cap=256, bands=3,
              kernel_quadform=quadform, kernel_bf16=bf16)
    jcfg = jr.RasterConfig(backend="sorted", **kw)
    tcfg = tr.RasterConfig(**kw)
    last = np.eye(4, dtype=np.float32)
    last[0, 3] = 0.05
    jcam = JCamera(*cam)
    jfs = jr.freeze_sorted(*[jnp.asarray(x) for x in arrs],
                           jnp.asarray(last), jcam, jcfg)

    def jloss(qt):
        o = jr.render_frozen_sorted_pose(jfs, qt, jnp.asarray(last), jcam,
                                         jcfg)
        return (o.color.sum() + 0.3 * o.depth.sum() + (o.alpha ** 2).sum()
                + (o.color * o.color).sum())

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(QT0))
    tfs = tr.freeze_sorted(*[torch.as_tensor(x) for x in arrs],
                           torch.as_tensor(last), cam, tcfg)
    qt = torch.as_tensor(QT0).requires_grad_(True)
    cs.reset_counts()
    o = tr.render_frozen_sorted_pose(tfs, qt, torch.as_tensor(last), cam,
                                     tcfg)
    tv = (o.color.sum() + 0.3 * o.depth.sum() + (o.alpha ** 2).sum()
          + (o.color * o.color).sum())
    (tg,) = torch.autograd.grad(tv, qt)
    assert cs.counts()["pose_twin_calls"] == 1
    return float(jv), np.asarray(jg), float(tv), tg.numpy()


def test_quadform_pose_grad_matches_jax():
    jv, jg, tv, tg = _pose_value_grad(4, quadform=True, bf16=False)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    scale = max(np.abs(jg).max(), 1e-6)
    np.testing.assert_allclose(tg / scale, jg / scale, atol=2e-4)


def _envelope(j_out, t_out, j_g, t_g):
    c_j, c_t = np.asarray(j_out.color), t_out.color.detach().numpy()
    assert np.abs(c_t - c_j).max() < 2e-2
    assert np.abs(c_t - c_j).mean() < 2e-3
    a_j, a_t = np.asarray(j_out.alpha), t_out.alpha.detach().numpy()
    assert np.abs(a_t - a_j).max() < 2e-2
    scale = max(np.abs(j_g).max(), 1e-9)
    assert np.abs(t_g - j_g).max() < 2e-2 * scale


@pytest.mark.parametrize("quadform", [False, True],
                         ids=["bf16", "quadform_bf16"])
def test_bf16_render_within_jax_envelope(quadform):
    """The port's bf16 render (alone and with quadform) against JAX's under
    the same options, with the loss of JAX's envelope test."""
    args = _scene(0)
    jcfg = JCFG._replace(kernel_bf16=True, kernel_quadform=quadform)
    tcfg = TCFG._replace(kernel_bf16=True, kernel_quadform=quadform)

    def jl(m):
        o = jr.render(m, *[jnp.asarray(x) for x in args[1:]], JCAM, jcfg)
        return jnp.mean(jnp.abs(o.color)) + 0.1 * jnp.mean(o.depth)

    j_out = jr.render(*[jnp.asarray(x) for x in args], JCAM, jcfg)
    j_g = np.asarray(jax.grad(jl)(jnp.asarray(args[0])))
    m = torch.as_tensor(args[0]).requires_grad_(True)
    cs.reset_counts()
    t_out = tr.render(m, *[torch.as_tensor(x) for x in args[1:]], CAM, tcfg)
    (t_out.color.abs().mean() + 0.1 * t_out.depth.mean()).backward()
    assert cs.counts()["bwd_twin_calls"] == 1
    _envelope(j_out, t_out, j_g, m.grad.numpy())


def test_bf16_pose_grad_within_jax_envelope():
    """The K4 pose path under bf16: the value within 2e-3 relative and
    dpose within 2e-2 of its largest magnitude of JAX's bf16 path."""
    jv, jg, tv, tg = _pose_value_grad(5, quadform=False, bf16=True)
    np.testing.assert_allclose(tv, jv, rtol=2e-3)
    scale = max(np.abs(jg).max(), 1e-6)
    assert np.abs(tg - jg).max() < 2e-2 * scale
