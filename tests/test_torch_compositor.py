"""The port's compositing (K1 forward, K2 backward) against the JAX sorted
backend in Pallas interpret mode. (The CUDA kernels against their plain
twins: tests/test_torch_kernels_cuda.py, on the card.)

JAX side: `rasterizer_pallas_v2.composite_sorted` on the attrs / segment
tables that the JAX rasterizer builds; its (S_pad, 16, PX) output is
compared on out[:S, :8]. Port side: the plain twins the CPU takes. Shapes of
tests/test_rasterizer_v2.py: CAM 48x32, tile 16, seg_cap 256, bands 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.ops import rasterizer as jr
from eags_slam_tpu.ops.rasterizer_pallas_v2 import \
    composite_sorted as j_composite
from eags_slam_torch.ops import composite_sorted as cs

CAM = JCamera(fx=60.0, fy=60.0, cx=23.5, cy=15.5, width=48, height=32)
JCFG = jr.RasterConfig(tile=16, dup_side=4, chunk=16, backend="sorted",
                       seg_cap=256, bands=3, group=2)
TILES_X, TILES_Y = 3, 2


def _scene(rng, n):
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return (means, q,
            np.log(rng.uniform(0.02, 0.07, (n, 3))).astype(np.float32),
            rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32),
            np.eye(4, dtype=np.float32))


def _kernel_inputs(rng, n, cfg=JCFG, cam=CAM):
    """attrs (16, Npad), seg_start, seg_cnt as the JAX rasterizer builds
    them, as numpy."""
    m, q, ls, op, col, w2c = (jnp.asarray(a) for a in _scene(rng, n))
    proj = jr.project_gaussians(m, q, ls, op, w2c, cam, cfg,
                                radius_cap=jr._v2_radius_cap(cfg))
    attrs, ss, sc = jr._sorted_attrs(proj, col, cam, cfg)
    return np.asarray(attrs), np.asarray(ss), np.asarray(sc)


def _both(attrs, ss, sc, tile_ids, cfg=JCFG):
    """JAX forward out[:S, :8] and the port twin's (out, cols)."""
    j_out = j_composite(jnp.asarray(attrs), jnp.asarray(ss),
                        jnp.asarray(sc), jnp.asarray(tile_ids, jnp.int32),
                        cfg.tile, TILES_X, cfg.group, cfg.bands, cfg.seg_cap)
    s = len(tile_ids)
    t_out, t_cols = cs.composite_sorted_fwd_plain(
        torch.as_tensor(attrs), torch.as_tensor(ss), torch.as_tensor(sc),
        torch.as_tensor(np.asarray(tile_ids, np.int32)), cfg.tile, TILES_X,
        cfg.bands, cfg.seg_cap)
    return np.asarray(j_out)[:s, :8], t_out, t_cols


# Forward tolerance: same float32 arithmetic per (pixel, survivor); the TPU
# kernel forms the in-chunk transmittance prefix and the colour sums with
# matmuls, the twin with cumsums -- float32 rounding only. The JAX side's
# interpret-mode matmuls themselves vary by up to ~3e-5 from run to run on
# the CPU, so colour/alpha get 1e-4 and depth/log T 5e-4.
FWD_ATOL = {0: 1e-4, 1: 1e-4, 2: 1e-4, 3: 5e-4, 4: 1e-4, 5: 5e-4}


def _assert_fwd(j_out, t_out):
    t = t_out.numpy()
    for ch, tol in FWD_ATOL.items():
        np.testing.assert_allclose(t[:, ch], j_out[:, ch], atol=tol,
                                   err_msg=f"channel {ch}")
    # Chunks used and survivor counts are exact integers.
    np.testing.assert_array_equal(t[:, 6:8], j_out[:, 6:8])


@pytest.mark.parametrize("case", ["full", "subset", "band_overflow"])
def test_k1_twin_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "band_overflow":
        # 512 gaussians into seg_cap 128: the bands overflow and clip.
        cfg = JCFG._replace(seg_cap=128)
        attrs, ss, sc = _kernel_inputs(rng, 512, cfg)
        assert int(((ss % 128) + sc).max()) == 128  # clipped windows
        tile_ids = np.arange(6)
    else:
        cfg = JCFG
        attrs, ss, sc = _kernel_inputs(rng, 200)
        tile_ids = (np.arange(6) if case == "full"
                    else np.array([4, 0, 5, 2]))
    j_out, t_out, _ = _both(attrs, ss, sc, tile_ids, cfg)
    assert j_out[:, 7].max() > 10  # tiles hold real survivor lists
    _assert_fwd(j_out, t_out)


@pytest.mark.parametrize("case", ["full", "subset"])
def test_k2_twin_matches_jax_vjp(case):
    """The analytic K2 twin against jax.vjp of the TPU composite (its K2)
    with the same cotangent on channels 0-4."""
    rng = np.random.default_rng(1)
    attrs, ss, sc = _kernel_inputs(rng, 200)
    tile_ids = np.arange(6) if case == "full" else np.array([5, 1, 3])
    s = len(tile_ids)
    px = JCFG.tile ** 2
    dout = np.zeros((s, 8, px), np.float32)
    dout[:, :5] = rng.normal(size=(s, 5, px)).astype(np.float32)

    def f(a):
        return j_composite(a, jnp.asarray(ss), jnp.asarray(sc),
                           jnp.asarray(tile_ids, jnp.int32), JCFG.tile,
                           TILES_X, JCFG.group, JCFG.bands, JCFG.seg_cap)

    j_out, vjp = jax.vjp(f, jnp.asarray(attrs))
    ct = np.zeros(j_out.shape, np.float32)
    ct[:s, :8] = dout
    (j_grad,) = vjp(jnp.asarray(ct))
    j_grad = np.asarray(j_grad)

    t_attrs = torch.as_tensor(attrs)
    t_ids = torch.as_tensor(tile_ids.astype(np.int32))
    t_out, t_cols = cs.composite_sorted_fwd_plain(
        t_attrs, torch.as_tensor(ss), torch.as_tensor(sc), t_ids, JCFG.tile,
        TILES_X, JCFG.bands, JCFG.seg_cap)
    t_grad = cs.composite_sorted_bwd_plain(t_attrs, t_ids, t_out, t_cols,
                                           torch.as_tensor(dout), JCFG.tile,
                                           TILES_X).numpy()
    # Grad tolerance: per row, 1e-4 of the row's largest |grad| (float32
    # sums over 256 pixels taken in another order: matmuls on the JAX side,
    # cumsums and index_add here).
    for row in range(10):
        scale = max(np.abs(j_grad[row]).max(), 1e-12)
        np.testing.assert_allclose(t_grad[row], j_grad[row],
                                   atol=1e-4 * scale, err_msg=f"row {row}")
        assert np.abs(j_grad[row]).max() > 0
    assert np.all(t_grad[10:] == 0)


@pytest.mark.parametrize("tile,dup,seg_cap", [(32, 3, 256), (64, 2, 384)])
def test_big_tiles_twins_match_jax(tile, dup, seg_cap):
    """K1 / K2 twins at the card's tile 32 (and 64) on the 128x64 scene of
    tests/test_rasterizer_v2.py::test_sorted_big_tiles_match_dense, full
    frame: forward as test_k1_twin_matches_jax, grads as
    test_k2_twin_matches_jax_vjp (1e-4 of each row's largest |grad|)."""
    cam = JCamera(fx=90.0, fy=90.0, cx=63.5, cy=31.5, width=128, height=64)
    cfg = JCFG._replace(tile=tile, dup_side=dup, seg_cap=seg_cap, group=1)
    tx = -(-cam.width // tile)
    ids = np.arange(tx * (-(-cam.height // tile)), dtype=np.int32)
    rng = np.random.default_rng(tile)
    attrs, ss, sc = _kernel_inputs(rng, 300, cfg, cam)

    def f(a):
        return j_composite(a, jnp.asarray(ss), jnp.asarray(sc),
                           jnp.asarray(ids), tile, tx, cfg.group, cfg.bands,
                           seg_cap)

    j_out, vjp = jax.vjp(f, jnp.asarray(attrs))
    s, px = len(ids), tile * tile
    dout = np.zeros((s, 8, px), np.float32)
    dout[:, :5] = rng.normal(size=(s, 5, px)).astype(np.float32)
    ct = np.zeros(j_out.shape, np.float32)
    ct[:s, :8] = dout
    j_grad = np.asarray(vjp(jnp.asarray(ct))[0])
    t_attrs = torch.as_tensor(attrs)
    t_out, t_cols = cs.composite_sorted_fwd_plain(
        t_attrs, torch.as_tensor(ss), torch.as_tensor(sc),
        torch.as_tensor(ids), tile, tx, cfg.bands, seg_cap)
    j_out = np.asarray(j_out)[:s, :8]
    assert j_out[:, 7].max() > 10
    _assert_fwd(j_out, t_out)
    t_grad = cs.composite_sorted_bwd_plain(t_attrs, torch.as_tensor(ids),
                                           t_out, t_cols,
                                           torch.as_tensor(dout), tile,
                                           tx).numpy()
    for row in range(10):
        scale = max(np.abs(j_grad[row]).max(), 1e-12)
        np.testing.assert_allclose(t_grad[row], j_grad[row],
                                   atol=1e-4 * scale, err_msg=f"row {row}")


def test_autograd_function_matches_twins():
    """CompositeSorted routes CPU tensors to the twins, forward and
    backward, and returns grads for attrs only."""
    rng = np.random.default_rng(2)
    attrs, ss, sc = _kernel_inputs(rng, 150)
    ids = torch.arange(6, dtype=torch.int32)
    a = torch.tensor(attrs, requires_grad=True)
    cs.reset_counts()
    out = cs.composite_sorted(a, torch.as_tensor(ss), torch.as_tensor(sc),
                              ids, 16, TILES_X, 3, 256)
    w = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32))
    (out[:, :5] * w[:, :5]).sum().backward()
    ref_out, cols = cs.composite_sorted_fwd_plain(
        torch.as_tensor(attrs), torch.as_tensor(ss), torch.as_tensor(sc),
        ids, 16, TILES_X, 3, 256)
    dout = torch.zeros_like(ref_out)
    dout[:, :5] = w[:, :5]
    ref_g = cs.composite_sorted_bwd_plain(torch.as_tensor(attrs), ids,
                                          ref_out, cols, dout, 16, TILES_X)
    assert torch.equal(out.detach(), ref_out)
    assert torch.equal(a.grad, ref_g)
    c = cs.counts()
    assert c["fwd_launches"] == 0 and c["bwd_launches"] == 0
    assert c["fwd_twin_calls"] == 2 and c["bwd_twin_calls"] == 2
