"""The map and track path's options in the port against the JAX package
(sorted backend, Pallas interpret mode), on the same frame, map and random
draws (the JAX draws, handed to the port through its injection points):

  - `mapping.tile_subset`: the per-iteration random tile subset of the
    plain loop (render_tiles against gt_tiles, SSIM per tile, the loss
    EMA's bookkeeping), the JAX package's `_optimize_core` on its sorted
    backend (on the CPU JAX takes the subset only there) with its tile
    permutations handed to the port's tile sampler;
  - `mapping.init_halfres_frac`: `halfres_single_kf` (the 2x2 colour mean
    and the hole-aware depth, holes included) exactly, and the two-phase
    submap init (insert + optimise at half resolution on Camera.scaled(1),
    then `optimize_and_describe` at full resolution) with the descriptor
    of the full-resolution frame;
  - `tracking.debug_per_iter`: `track_frame`'s per-iteration record
    (DEBUG_ITER_NAMES) and pose, the subset polish off under the flag.

Tolerances: parameters 1e-4 absolute and losses 1e-4 relative (Adam steps
and float32 sums in another order, as tests/test_torch_mapper.py); the
tracker's record as tests/test_torch_tracker.py's poses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core import gaussians as JG
from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.core.gaussians import GaussianParams as JParams
from eags_slam_tpu.core.se3 import se3_exp as j_se3_exp
from eags_slam_tpu.core.sh import sh_to_rgb as j_sh_to_rgb
from eags_slam_tpu.ops.rasterizer import RasterConfig as JRaster
from eags_slam_tpu.ops.rasterizer import render as j_render
from eags_slam_tpu.slam import mapper as JM
from eags_slam_tpu.slam import tracker as JT
from eags_slam_torch.core import gaussians as G
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.core.gaussians import GaussianParams
from eags_slam_torch.lc.descriptor import global_descriptor
from eags_slam_torch.ops.rasterizer import RasterConfig
from eags_slam_torch.slam import mapper as M
from eags_slam_torch.slam import tracker as T
from test_torch_mapper import (CAM, JCAM, JRCFG, RCFG, _frame, _jax_state,
                               _jax_to_numpy, _rows)


def _assert_states_close(t_state, j_state):
    np.testing.assert_array_equal(t_state.alive.numpy(),
                                  np.asarray(j_state.alive))
    for k in G.OPT_KEYS:
        np.testing.assert_allclose(
            getattr(t_state.params, k).numpy(),
            np.asarray(getattr(j_state.params, k)), atol=1e-4, err_msg=k)


def _setup(n_base=600, n_new=300):
    color, depth = _frame()
    base = _rows(color, depth, n_base, seed=1)
    new = _rows(color, depth, n_new, seed=2)
    valid = np.ones(n_new, bool)
    valid[::7] = False
    return color, depth, base, new, valid


def _both_kfs(color, depth):
    kfs = JM.push_keyframe(JM.empty_keyframes(4, JCAM), 0,
                           jnp.asarray(color), jnp.asarray(depth),
                           jnp.eye(4), jnp.zeros(2))
    tkfs = M.empty_keyframes(4, CAM)
    M.push_keyframe(tkfs, 0, torch.as_tensor(color), torch.as_tensor(depth),
                    torch.eye(4), torch.zeros(2))
    return kfs, tkfs


def _jax_draws(key, iters, n_kf, mcfg, num_tiles, n_sub):
    """The keyframe and tile draws of JAX's plain loop under the subset:
    per iteration key, k_sel, k_tiles = split(key, 3)."""
    p_kf = jnp.asarray(M._keyframe_distribution(
        n_kf, mcfg.max_keyframes, mcfg.current_view_opt_iterations))
    kidx, tiles = [], []
    for it in range(iters):
        key, k_sel, k_tiles = jax.random.split(key, 3)
        kidx.append(0 if it < 5 else int(jax.random.categorical(
            k_sel, jnp.log(p_kf + 1e-12))))
        tiles.append(np.asarray(jax.random.permutation(
            k_tiles, num_tiles)[:n_sub]).astype(np.int32))
    return kidx, tiles


@pytest.mark.parametrize("iters", [6, 12], ids=["pinned", "prunes"])
def test_tile_subset_optimize_matches_jax(iters):
    """insert_and_optimize with tile_subset 8 of the 24 tiles (the 8-of-24
    ratio of tests/test_mapper_subset.py): 6 iterations pinned to the
    current frame, or 12 with both prunes and the EMA checkpoints; the
    subset turns the resident loop off in both packages."""
    color, depth, base, new, valid = _setup()
    mcfg_j = JM.MapperConfig(max_keyframes=4, kf_block=10, tile_subset=8)
    mcfg_t = M.MapperConfig(max_keyframes=4, kf_block=10, tile_subset=8)
    kfs, tkfs = _both_kfs(color, depth)
    jst = _jax_state(base, 1024)
    jrows = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in new.items()})
    key = jax.random.PRNGKey(3)
    j_state, j_added, j_losses, j_alive, _ = JM.insert_and_optimize(
        jst, jrows, jnp.asarray(valid), kfs, jnp.asarray(1, jnp.int32), key,
        iters, JCAM, JRCFG, mcfg_j)
    kidx, tiles = _jax_draws(key, iters, 1, mcfg_t, 24, 8)
    drawn = []

    def tile_sampler(it):
        drawn.append(it)
        return torch.as_tensor(tiles[it])

    st = G.state_from_numpy(_jax_to_numpy(jst))
    trows = G.GaussianParams(**{k: torch.as_tensor(v)
                                for k, v in new.items()})
    t_state, t_added, t_losses, t_alive, _ = M.insert_and_optimize(
        st, trows, torch.as_tensor(valid), tkfs, 1, iters, CAM, RCFG, mcfg_t,
        kf_sampler=lambda p, it: kidx[it], tile_sampler=tile_sampler)
    assert drawn == list(range(len(drawn))) and len(drawn) >= 5
    assert t_added == int(j_added) and t_alive == int(j_alive)
    _assert_states_close(t_state, j_state)
    np.testing.assert_allclose(t_losses, np.asarray(j_losses), rtol=1e-4)


def test_tile_subset_default_sampler():
    """Without an injected sampler the subset draws min(tile_subset,
    tiles) distinct tiles from the run's generator; past the grid it takes
    every tile (the half-resolution frame's case)."""
    gen = torch.Generator().manual_seed(0)
    draw = M._default_tile_sampler(gen, "cpu", 24, 8)
    a, b = draw(0), draw(1)
    assert a.dtype == torch.int32 and a.shape == (8,)
    assert len(set(a.tolist())) == 8 and not torch.equal(a, b)
    assert int(a.max()) < 24 and int(a.min()) >= 0


def _holey_frame():
    color, depth = _frame()
    depth = depth.copy()
    rng = np.random.default_rng(0)
    depth[rng.uniform(size=depth.shape) < 0.3] = 0.0
    depth[10:14, 20:28] = 0.0                 # whole 2x2 blocks of holes
    return color, depth


def test_halfres_single_kf_matches_jax():
    color, depth = _holey_frame()
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.1, -0.2, 0.3]
    exposure = np.array([0.05, -0.01], np.float32)
    j = JM.halfres_single_kf(jnp.asarray(color), jnp.asarray(depth),
                             jnp.asarray(w2c), jnp.asarray(exposure))
    t = M.halfres_single_kf(torch.as_tensor(color), torch.as_tensor(depth),
                            torch.as_tensor(w2c), torch.as_tensor(exposure))
    for name in ("color", "depth", "w2c", "exposure", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert t.color.shape == (1, CAM.height // 2, CAM.width // 2, 3)
    assert float((t.depth[0, 5:7, 10:14] == 0).all()) == 1.0


def test_two_phase_init_matches_jax():
    """init_halfres_frac 0.25 of 12 iterations (round(3.0) = 3): phase 1
    inserts and optimises 3 iterations on the half-resolution boundary
    frame at Camera.scaled(1), phase 2 optimises the other 9 at full
    resolution; the descriptor is the full-resolution frame's, equal in
    packages (and the same as the full frame's, not the half frame's)."""
    color, depth, base, new, valid = _setup()
    iters = 12
    half = int(round(0.25 * iters))
    mcfg_j = JM.MapperConfig(max_keyframes=4, kf_block=10,
                             init_halfres_frac=0.25)
    mcfg_t = M.MapperConfig(max_keyframes=4, kf_block=10,
                            init_halfres_frac=0.25)
    kfs, tkfs = _both_kfs(color, depth)
    jst = _jax_state(base, 1024)
    jrows = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in new.items()})
    jhalf = JM.halfres_single_kf(jnp.asarray(color), jnp.asarray(depth),
                                 jnp.eye(4), jnp.zeros(2))
    one = jnp.asarray(1, jnp.int32)
    j1, j_added, _, _, _ = JM.insert_and_optimize(
        jst, jrows, jnp.asarray(valid), jhalf, one, jax.random.PRNGKey(1),
        half, JCAM.scaled(1), JRCFG, mcfg_j)
    j2, j_losses, j_alive, j_desc = JM.optimize_and_describe(
        j1, kfs, one, jax.random.PRNGKey(2), iters - half, JCAM, JRCFG,
        mcfg_j)

    st = G.state_from_numpy(_jax_to_numpy(jst))
    trows = G.GaussianParams(**{k: torch.as_tensor(v)
                                for k, v in new.items()})
    thalf = M.halfres_single_kf(torch.as_tensor(color),
                                torch.as_tensor(depth), torch.eye(4),
                                torch.zeros(2))
    t1, t_added, _, _, _ = M.insert_and_optimize(
        st, trows, torch.as_tensor(valid), thalf, 1, half, CAM.scaled(1),
        RCFG, mcfg_t, kf_sampler=lambda p, it: 0)
    _assert_states_close(t1, j1)
    t2, t_losses, t_alive, t_desc, t_iters = M.optimize_and_describe(
        t1, tkfs, 1, iters - half, CAM, RCFG, mcfg_t,
        kf_sampler=lambda p, it: 0)
    assert t_added == int(j_added) and t_alive == int(j_alive)
    assert t_iters <= iters - half
    _assert_states_close(t2, j2)
    np.testing.assert_allclose(t_losses, np.asarray(j_losses), rtol=1e-4)
    # The full-resolution frame's descriptor (not the half-resolution
    # one's), equal to JAX's within tests/test_torch_mapper.py's 1e-5.
    full = global_descriptor(torch.as_tensor(color)).numpy()
    np.testing.assert_array_equal(t_desc.numpy(), full)
    assert not np.array_equal(full, global_descriptor(thalf.color[0]).numpy())
    np.testing.assert_allclose(t_desc.numpy(), np.asarray(j_desc),
                               atol=1e-5)


TCAM = Camera(fx=60.0, fy=60.0, cx=23.5, cy=19.5, width=48, height=40)
JTCAM = JCamera(*TCAM)
JTRCFG = JRaster(tile=16, dup_side=4, chunk=16, backend="sorted",
                 seg_cap=256, bands=3, group=3)
TRCFG = RasterConfig(tile=16, dup_side=4, seg_cap=256, bands=3)


def test_debug_per_iter_matches_jax():
    """track_frame with debug_per_iter on tests/test_torch_tracker.py's
    scene: both records are (2 x iterations, 12); the port's active rows
    are the iterations run, as JAX's, with the same losses (1e-3
    relative), LR scales and poses (1e-3), and its rows past the exit are
    zero; the subset polish is off under the flag in both packages (the
    iteration counts agree)."""
    from test_torch_tracker import _scene

    d = _scene()
    jp = JParams(**{k: jnp.asarray(v) for k, v in d.items()})
    alive = np.ones(d["xyz"].shape[0], bool)
    out = j_render(jp.xyz, jp.quats, jp.log_scales, jp.opacity_logits,
                   j_sh_to_rgb(jp.f_dc), jnp.eye(4), JTCAM, JTRCFG,
                   alive=jnp.asarray(alive))
    gt_color = np.asarray(out.color)
    gt_depth = np.asarray(jnp.where(
        out.alpha > 0.5, out.depth / jnp.maximum(out.alpha, 1e-6), 0.0))
    tau = np.array([0.01, -0.008, 0.006, 0.006, -0.008, 0.005], np.float32)
    rels = np.asarray(j_se3_exp(jnp.asarray(tau)))[None].astype(np.float32)
    common = dict(iterations=8, tile_subset_frac=0.6, polish_iters=3,
                  polish_frac=0.9, alpha_thre=0.5, early_stop_cnt=60,
                  debug_per_iter=True)
    j_rel, _, j_stats, j_per = JT.track_frame(
        jp, jnp.asarray(alive), jnp.asarray(rels), jnp.eye(4),
        jnp.asarray(gt_color), jnp.asarray(gt_depth), jnp.float32(np.inf),
        jnp.float32(np.inf), jnp.zeros(2), JTCAM, JTRCFG,
        JT.TrackerConfig(**common))
    tp = GaussianParams(**{k: torch.as_tensor(v) for k, v in d.items()})
    t_rel, _, t_stats, t_per = T.track_frame(
        tp, torch.as_tensor(alive), torch.as_tensor(rels), torch.eye(4),
        torch.as_tensor(gt_color), torch.as_tensor(gt_depth), np.inf, np.inf,
        torch.zeros(2), TCAM, TRCFG, T.TrackerConfig(**common))
    j_per = np.asarray(j_per)
    assert T.DEBUG_ITER_NAMES == JT.DEBUG_ITER_NAMES
    assert t_per.shape == j_per.shape == (16, 12)
    n = int(t_stats[3])
    assert n == int(j_stats[3]) and n >= 8     # no polish phase
    active = t_per[:, 4] == 1.0
    np.testing.assert_array_equal(active, j_per[:, 4] == 1.0)
    assert int(active.sum()) == n and bool(active[:n].all())
    assert np.all(t_per[n:] == 0.0)
    np.testing.assert_allclose(t_per[:n, 0:3], j_per[:n, 0:3], rtol=1e-3)
    np.testing.assert_allclose(t_per[:n, 3], j_per[:n, 3], rtol=1e-6)
    np.testing.assert_allclose(t_per[:n, 5:], j_per[:n, 5:], atol=1e-3)
    np.testing.assert_allclose(t_rel.numpy(), np.asarray(j_rel), atol=1e-3)
