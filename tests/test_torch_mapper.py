"""Mapper parity: the port's seeding path and resident-sorted submap
optimisation against the JAX mapper (sorted backend, Pallas interpret mode)
on the same frame, map and random draws (the JAX draws, handed to the port
through its injection points)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core import gaussians as JG
from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.ops.rasterizer import RasterConfig as JRaster
from eags_slam_tpu.slam import mapper as JM
from eags_slam_torch.core import gaussians as G
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops.rasterizer import RasterConfig
from eags_slam_torch.slam import mapper as M

CAM = Camera(fx=80.0, fy=80.0, cx=47.5, cy=31.5, width=96, height=64)
JCAM = JCamera(*CAM)
JRCFG = JRaster(tile=16, dup_side=4, chunk=16, backend="sorted", seg_cap=256,
                bands=3, group=2)
RCFG = RasterConfig(tile=16, dup_side=4, seg_cap=256, bands=3)


def _frame():
    u, v = np.meshgrid(np.arange(CAM.width), np.arange(CAM.height))
    depth = (2.0 + 0.3 * np.sin(u / 11.0) * np.cos(v / 7.0)).astype(
        np.float32)
    color = np.stack([0.5 + 0.5 * np.sin(u / 5.0), 0.5 + 0.5 * np.cos(v / 9.0),
                      0.4 + 0.3 * ((u // 12 + v // 12) % 2)], -1).astype(
        np.float32)
    return color, depth


def _rows(color, depth, n, seed=0):
    """Point rows backprojected from `n` random pixels (numpy)."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(CAM.width), np.arange(CAM.height))
    pts = np.stack([(u - CAM.cx) / CAM.fx * depth,
                    (v - CAM.cy) / CAM.fy * depth, depth], -1).reshape(-1, 3)
    sel = rng.choice(pts.shape[0], n, replace=False)
    xyz = pts[sel].astype(np.float32)
    rgb = color.reshape(-1, 3)[sel]
    d = {"xyz": xyz, "f_dc": ((rgb - 0.5) / 0.28209479177387814).astype(
        np.float32),
         "f_rest": np.zeros((n, 15, 3), np.float32),
         "log_scales": np.full((n, 3), 0.5 * np.log(2e-3), np.float32)
         + rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
         "quats": np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)),
         "opacity_logits": np.zeros((n, 1), np.float32)}
    return d


def _jax_state(d, capacity):
    st = JG.empty_state(capacity)
    rows = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})
    st, _ = JG.insert(st, rows, jnp.ones(d["xyz"].shape[0], bool))
    return st


def _jax_to_numpy(st):
    p = st.params
    out = {k: np.asarray(getattr(p, k)) for k in G.PARAM_KEYS}
    out["alive"] = np.asarray(st.alive)
    out["adam_step"] = np.asarray(st.adam.step)
    for slot in ("mu", "nu", "vmax"):
        tree = getattr(st.adam, slot)
        for k in G.OPT_KEYS:
            out[f"adam_{slot}_{k}"] = np.asarray(getattr(tree, k))
    return out


def test_state_numpy_round_trip():
    color, depth = _frame()
    jst = _jax_state(_rows(color, depth, 300), 512)
    d = _jax_to_numpy(jst)
    st = G.state_from_numpy(d)
    back = G.state_to_numpy(st)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # pack_state-style input (alive rows only, f_rest marker): all alive.
    packed = {k: d[k][d["alive"]] for k in G.PARAM_KEYS}
    packed["f_rest"] = np.zeros((0, 15, 3), np.float32)
    st2 = G.state_from_numpy(packed)
    assert st2.capacity == 300 and bool(st2.alive.all())
    assert st2.params.f_rest.shape == (300, 15, 3)


@pytest.mark.parametrize("iters,extra", [
    (5, {}),
    (12, dict(freeze_frac=0.25, freeze_after=0.3, stale_best_cnt=2)),
], ids=["pinned", "freeze_stale"])
def test_insert_and_optimize_matches_jax(iters, extra):
    """One insert_and_optimize on a 600-gaussian map plus 300 inserted rows,
    with one keyframe (so every keyframe draw gives 0). "pinned": 5
    iterations. "freeze_stale": 12 iterations with the chip smoke's
    converged-tile freezing (one full-image iteration, then the top
    residual quarter of the tiles), both prunes, the 5% checkpoints and the
    stale-best stop. Tolerance: parameters within 1e-4 absolute (Adam
    steps of size <= lr; float32 sums in another order), alive masks
    equal, losses within 1e-4 relative."""
    color, depth = _frame()
    base = _rows(color, depth, 600, seed=1)
    new = _rows(color, depth, 300, seed=2)
    mcfg_j = JM.MapperConfig(max_keyframes=4, kf_block=10, **extra)
    mcfg_t = M.MapperConfig(max_keyframes=4, kf_block=10, **extra)

    jst = _jax_state(base, 1024)
    kfs = JM.empty_keyframes(4, JCAM)
    kfs = JM.push_keyframe(kfs, 0, jnp.asarray(color), jnp.asarray(depth),
                           jnp.eye(4), jnp.zeros(2))
    jrows = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in new.items()})
    valid = np.ones(300, bool)
    valid[::7] = False
    j_state, j_added, j_losses, j_alive, j_desc = JM.insert_and_optimize(
        jst, jrows, jnp.asarray(valid), kfs, jnp.asarray(1, jnp.int32),
        jax.random.PRNGKey(0), iters, JCAM, JRCFG, mcfg_j)

    st = G.state_from_numpy(_jax_to_numpy(jst))
    tkfs = M.empty_keyframes(4, CAM)
    M.push_keyframe(tkfs, 0, torch.as_tensor(color), torch.as_tensor(depth),
                    torch.eye(4), torch.zeros(2))
    trows = G.GaussianParams(**{k: torch.as_tensor(v) for k, v in
                                new.items()})
    t_state, t_added, t_losses, t_alive, t_desc = M.insert_and_optimize(
        st, trows, torch.as_tensor(valid), tkfs, 1, iters, CAM, RCFG, mcfg_t,
        kf_sampler=lambda p, it0: 0)

    assert t_added == int(j_added) and t_alive == int(j_alive)
    np.testing.assert_array_equal(t_state.alive.numpy(),
                                  np.asarray(j_state.alive))
    for k in G.OPT_KEYS:
        np.testing.assert_allclose(
            getattr(t_state.params, k).numpy(),
            np.asarray(getattr(j_state.params, k)), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(t_losses, np.asarray(j_losses), rtol=1e-4)
    # Moments after 5 steps: same tolerance relative to their scale.
    for k in G.OPT_KEYS:
        jm = np.asarray(getattr(j_state.adam.mu, k))
        np.testing.assert_allclose(t_state.adam.mu[k].numpy(), jm,
                                   atol=1e-3 * max(np.abs(jm).max(), 1e-9))
    np.testing.assert_allclose(t_desc.numpy(), np.asarray(j_desc),
                               atol=1e-5)


@pytest.mark.parametrize("is_new", [True, False])
def test_seed_rows_matches_jax(is_new):
    """The whole seeding path (Canny edges or the render-based update mask,
    Gumbel top-k sampling with the JAX noise, backprojection, Morton dedup +
    kNN scale init, edge pairs) gives the same candidate rows."""
    color, depth = _frame()
    mcfg_j = JM.MapperConfig(new_submap_points_num=400,
                             new_submap_gradient_points_num=200,
                             new_frame_sample_size=300, new_points_radius=0.01)
    mcfg_t = M.MapperConfig(**mcfg_j._asdict())
    jst = _jax_state(_rows(color, depth, 500, seed=3), 1024)
    key = jax.random.PRNGKey(7)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.01, -0.02, 0.0]
    w2c = np.linalg.inv(c2w).astype(np.float32)
    bits = jnp.zeros((CAM.height, -(-CAM.width // 8)), jnp.uint8)
    j_rows, j_valid, j_n, j_mask = JM.seed_rows(
        jst.params, jst.alive, key, jnp.asarray(color), jnp.asarray(depth),
        jnp.asarray(c2w), jnp.asarray(w2c), bits, JCAM, JRCFG, mcfg_j,
        is_new, True)
    p = CAM.width * CAM.height
    ks = jax.random.split(key, 3) if is_new else [key]
    gumbels = [np.asarray(jax.random.gumbel(k, (p,))) for k in ks]

    st = G.state_from_numpy(_jax_to_numpy(jst))
    t_rows, t_valid, t_n, t_mask = M.seed_rows(
        st.params, st.alive, torch.as_tensor(color), torch.as_tensor(depth),
        torch.as_tensor(c2w), torch.as_tensor(w2c), None, CAM, RCFG, mcfg_t,
        is_new, True, gumbels=gumbels)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    assert t_n == int(j_n) > 50
    jv = np.asarray(j_valid)
    np.testing.assert_array_equal(t_valid.numpy(), jv)
    # Rows: float32 backprojection / kNN in another summation order, 1e-4.
    # Edge-pair quaternions come from arccos of the pair direction's x
    # component, whose slope is unbounded near +-1: 1e-3 there.
    for k, tol in (("xyz", 1e-4), ("f_dc", 1e-4), ("log_scales", 1e-4),
                   ("opacity_logits", 1e-4), ("quats", 1e-3)):
        np.testing.assert_allclose(
            getattr(t_rows, k).numpy()[jv],
            np.asarray(getattr(j_rows, k))[jv], atol=tol, rtol=1e-4,
            err_msg=k)
