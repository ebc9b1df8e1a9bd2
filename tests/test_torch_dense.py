"""The dense `jnp` backend and `render_dense` of the port against the JAX
package's (the 4-frame SLAM run on the `jnp` backend in both packages:
tests/test_torch_slice_dense.py).

Render: the seeded scenes of tests/test_rasterizer.py / test_rasterizer_v2.py
(48x32, tile 16) and their big-tile camera (128x64, tile 32), forward images
and the gradients of a loss w.r.t. every input (`w2c` included). Both sides
compute the same float32 operations in another association order (XLA
fuses and reorders the sums, PyTorch's einsum and cumsum do not): images
within 2e-5 absolute (depth 2e-4: it sums metres), gradients within 1e-3
of each input's largest |grad|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.ops import rasterizer as jr
from eags_slam_tpu.ops.rasterizer_ref import render_dense as j_render_dense
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops import composite_entries as ce
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.ops import rasterizer as tr
from eags_slam_torch.ops.rasterizer_ref import render_dense

SMALL = (60.0, 60.0, 23.5, 15.5, 48, 32)
BIG = (90.0, 90.0, 63.5, 31.5, 128, 64)
IMG_ATOL = {"color": 2e-5, "depth": 2e-4, "alpha": 2e-5}
GRAD_REL = 1e-3
NAMES = ("means", "quats", "log_scales", "opacity", "colors", "w2c")


def _scene(seed, n, cam):
    rng = np.random.default_rng(seed)
    wx = 0.8 if cam[4] > 64 else 0.6
    means = np.stack([rng.uniform(-wx, wx, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.02, -0.01, 0.03]
    return (means, q,
            np.log(rng.uniform(0.02, 0.08, (n, 3))).astype(np.float32),
            rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32), w2c)


def _target(seed, cam):
    rng = np.random.default_rng(seed + 100)
    return rng.uniform(0, 1, (cam[5], cam[4], 3)).astype(np.float32)


def _loss_of(out, target):
    return (jnp if isinstance(out.color, jnp.ndarray) else torch).mean(
        abs(out.color - target)) + 0.1 * out.depth.mean() \
        + 0.05 * out.alpha.mean()


def _jax_side(fn, scene, cam, cfg, target, **kw):
    args = tuple(jnp.asarray(a) for a in scene)
    jcam = JCamera(*cam)

    def loss(*a):
        return _loss_of(fn(*a, jcam, cfg, **kw), jnp.asarray(target))

    out = fn(*args, jcam, cfg, **kw)
    grads = jax.grad(loss, argnums=tuple(range(6)))(*args)
    return out, [np.asarray(g) for g in grads]


def _port_side(fn, scene, cam, cfg, target, **kw):
    args = [torch.tensor(a, requires_grad=True) for a in scene]
    out = fn(*args, Camera(*cam), cfg, **kw)
    _loss_of(out, torch.as_tensor(target)).backward()
    return out, [a.grad.numpy() for a in args]


def _compare(j, t):
    (j_out, j_grads), (t_out, t_grads) = j, t
    for name, tol in IMG_ATOL.items():
        np.testing.assert_allclose(getattr(t_out, name).detach().numpy(),
                                   np.asarray(getattr(j_out, name)),
                                   atol=tol, rtol=0, err_msg=name)
    np.testing.assert_array_equal(t_out.radii.numpy(), np.asarray(j_out.radii))
    assert float(t_out.alpha.detach().max()) > 0.5
    for name, gt, gj in zip(NAMES, t_grads, j_grads):
        scale = max(np.abs(gj).max(), 1e-6)
        np.testing.assert_allclose(gt, gj, atol=GRAD_REL * scale, rtol=0,
                                   err_msg=name)
        assert np.abs(gt).max() > 0, name


@pytest.mark.parametrize("span", [True, False])
def test_render_dense_matches_jax(span):
    cam = SMALL
    scene = _scene(0, 48, cam)
    cfg_j = jr.RasterConfig(tile=16, dup_side=4)
    cfg_t = tr.RasterConfig(tile=16, dup_side=4)
    _compare(_jax_side(j_render_dense, scene, cam, cfg_j, _target(0, cam),
                       respect_tile_span=span),
             _port_side(render_dense, scene, cam, cfg_t, _target(0, cam),
                        respect_tile_span=span))


# (camera, tile, dup_side, tile_capacity, chunk, gaussians): the v2 tests'
# dense config, tests/test_rasterizer.py's, the big-tile camera at tile 32,
# and a capacity of 16 that clips the fuller tiles.
CASES = {
    "v2": (SMALL, 16, 4, 256, 16, 48),
    "v1": (SMALL, 16, 4, 128, 32, 64),
    "big_tile32": (BIG, 32, 3, 512, 64, 96),
    "clipped": (SMALL, 16, 4, 16, 8, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_jnp_backend_matches_jax(case):
    cam, tile, dup, cap, chunk, n = CASES[case]
    scene = _scene(1, n, cam)
    kw = dict(tile=tile, dup_side=dup, tile_capacity=cap, chunk=chunk,
              backend="jnp")
    cfg_t = tr.RasterConfig(**kw)
    proj = tr.project_gaussians(*(torch.as_tensor(a) for a in
                                  (scene[0], scene[1], scene[2], scene[3],
                                   scene[5])), Camera(*cam), cfg_t)
    table, count = tr._build_tile_table(proj, Camera(*cam), cfg_t)
    _, _, _, full = tr._bin_entries(proj, Camera(*cam), cfg_t)
    # The clipped case drops entries; the others keep every one.
    assert bool((full[:-1] > cap).any()) == (case == "clipped")
    assert int(count.max()) <= cap and table.shape[1] == cap
    cs.reset_counts()
    ce.reset_counts()
    _compare(_jax_side(jr.render, scene, cam, jr.RasterConfig(**kw),
                       _target(1, cam)),
             _port_side(tr.render, scene, cam, cfg_t, _target(1, cam)))
    # Plain PyTorch: no kernel and no twin of one ran.
    assert not any({**cs.counts(), **ce.counts()}.values())


def test_tile_table_matches_jax():
    """The table itself: the same gaussians in the same slots, the same
    counts (clipped at the capacity)."""
    cam = SMALL
    scene = _scene(2, 64, cam)
    kw = dict(tile=16, dup_side=4, tile_capacity=16, chunk=8)
    jproj = jr.project_gaussians(*(jnp.asarray(scene[i])
                                   for i in (0, 1, 2, 3, 5)),
                                 JCamera(*cam), jr.RasterConfig(**kw))
    j_table, j_count = jr._build_tile_table(jproj, JCamera(*cam),
                                            jr.RasterConfig(**kw))
    tproj = tr.project_gaussians(*(torch.as_tensor(scene[i])
                                   for i in (0, 1, 2, 3, 5)),
                                 Camera(*cam), tr.RasterConfig(**kw))
    t_table, t_count = tr._build_tile_table(tproj, Camera(*cam),
                                            tr.RasterConfig(**kw))
    np.testing.assert_array_equal(t_count.numpy(), np.asarray(j_count))
    np.testing.assert_array_equal(t_table.numpy(), np.asarray(j_table))


def test_jnp_no_grad_equals_grad_path():
    """Under no_grad the steps run without checkpointing: the same images
    bit for bit."""
    cam = SMALL
    scene = [torch.as_tensor(a) for a in _scene(3, 48, cam)]
    cfg = tr.RasterConfig(tile=16, dup_side=4, tile_capacity=64, chunk=16,
                          backend="jnp")
    with torch.no_grad():
        a = tr.render(*scene, Camera(*cam), cfg)
    b = tr.render(*(s.clone().requires_grad_(True) for s in scene),
                  Camera(*cam), cfg)
    for name in ("color", "depth", "alpha"):
        assert torch.equal(getattr(a, name), getattr(b, name).detach())

