"""Per-module parity of the PyTorch port against the JAX package: the same
numpy inputs (made from a seed) go through both, at the shapes of the
matching JAX tests, with the tolerance stated in each test.

Covered: config, camera / SE(3) / SH, the gaussian state, the sorted
rasterizer (the JAX side runs its Pallas kernels in interpret mode), losses,
image ops, kNN, the optimizer, the global descriptor and the trajectory
evaluation.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu import config as jconfig
from eags_slam_tpu.core import camera as JC
from eags_slam_tpu.core import gaussians as JG
from eags_slam_tpu.core import se3 as JS
from eags_slam_tpu.core import sh as JSH
from eags_slam_tpu.evaluation import trajectory as JTR
from eags_slam_tpu.lc.descriptor import global_descriptor as j_descriptor
from eags_slam_tpu.ops import image as JI
from eags_slam_tpu.ops import knn as JK
from eags_slam_tpu.ops import losses as JL
from eags_slam_tpu.ops import rasterizer as JR
from eags_slam_tpu.utils import optim as JO
from eags_slam_torch import config as tconfig
from eags_slam_torch.core import camera as TC
from eags_slam_torch.core import gaussians as TG
from eags_slam_torch.core import se3 as TS
from eags_slam_torch.core import sh as TSH
from eags_slam_torch.evaluation import trajectory as TTR
from eags_slam_torch.lc.descriptor import global_descriptor as t_descriptor
from eags_slam_torch.ops import image as TI
from eags_slam_torch.ops import knn as TK
from eags_slam_torch.ops import losses as TL
from eags_slam_torch.ops import rasterizer as TR
from eags_slam_torch.utils import optim as TO


def T(x, dtype=None):
    """numpy / jax array -> a CPU torch tensor (own memory)."""
    a = np.array(x)
    return torch.as_tensor(a if dtype is None else a.astype(dtype))


def N(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# config.py
# ---------------------------------------------------------------------------

CONFIGS = ["configs/synthetic/tiny.yaml", "configs/synthetic/base.yaml",
           "configs/Replica/room0.yaml", "configs/TUM_RGBD/fr1_desk.yaml"]


@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_matches_jax(path):
    """Same inherit_from resolution and defaults. One default differs by
    design: `device` is a torch device string ("cuda") where the JAX
    package keeps the reference's GPU index 0."""
    j = jconfig.load_config(path)
    t = tconfig.load_config(path)
    assert t.pop("device") == "cuda" and j.pop("device") == 0
    assert t == j


def test_cli_overrides_and_save_round_trip(tmp_path):
    args = argparse.Namespace(output_path="out/x", frame_limit=3, seed=5,
                              map_every=2, tracking_iterations=7,
                              soft_alpha=False, input_path=None)
    j = jconfig.update_config_with_args(
        jconfig.load_config(CONFIGS[0]), args)
    t = tconfig.update_config_with_args(
        tconfig.load_config(CONFIGS[0]), args)
    t["device"] = j["device"]
    assert t == j
    tconfig.save_config(t, str(tmp_path / "config.yaml"))
    assert jconfig.load_config(str(tmp_path / "config.yaml"),
                               defaults=False) == j


# ---------------------------------------------------------------------------
# core: camera, se3, sh
# ---------------------------------------------------------------------------

CAM = (60.0, 58.0, 23.5, 15.5, 48, 32)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_camera_scaled_and_backproject(level):
    jc = JC.Camera(*CAM).scaled(level)
    tc = TC.Camera(*CAM).scaled(level)
    assert tuple(jc) == tuple(tc)
    rng = np.random.default_rng(level)
    depth = rng.uniform(0.5, 3.0, (tc.height, tc.width)).astype(np.float32)
    # float32 elementwise; 1e-6 relative.
    np.testing.assert_allclose(N(TC.backproject(tc, T(depth))),
                               N(JC.backproject(jc, jnp.asarray(depth))),
                               rtol=1e-6, atol=1e-6)
    pts = np.concatenate([rng.normal(size=(20, 2)),
                          rng.uniform(0.5, 4, (20, 1))], -1).astype(np.float32)
    for a, b in zip(TC.project(tc, T(pts)), JC.project(jc, jnp.asarray(pts))):
        np.testing.assert_allclose(N(a), N(b), rtol=1e-6, atol=1e-5)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quaternion_ops_match_jax():
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    tol = dict(rtol=1e-5, atol=1e-6)   # float32 elementwise
    np.testing.assert_allclose(N(TS.quat_multiply(T(q1), T(q2))),
                               N(JS.quat_multiply(q1, q2)), **tol)
    np.testing.assert_allclose(N(TS.quat_conjugate(T(q1))),
                               N(JS.quat_conjugate(q1)), **tol)
    R = N(JS.quat_to_rotmat(q1))
    np.testing.assert_allclose(N(TS.quat_to_rotmat(T(q1))), R, **tol)
    # rotmat_to_quat: the pivot choice and the w >= 0 sign are exact, so the
    # quaternions agree to float32 rounding of the square roots.
    np.testing.assert_allclose(N(TS.rotmat_to_quat(T(R))),
                               N(JS.rotmat_to_quat(jnp.asarray(R))),
                               rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("scale", [1e-5, 0.1, 2.0])
def test_se3_exp_matches_jax(scale):
    """Small, moderate and large twists (the small branch at 1e-5)."""
    rng = np.random.default_rng(1)
    tau = (scale * rng.normal(size=(32, 6))).astype(np.float32)
    np.testing.assert_allclose(N(TS.se3_exp(T(tau))),
                               N(JS.se3_exp(jnp.asarray(tau))),
                               rtol=1e-5, atol=2e-6)
    Tm = N(JS.se3_exp(jnp.asarray(tau)))
    np.testing.assert_allclose(N(TS.mat_inverse(T(Tm))),
                               N(JS.mat_inverse(jnp.asarray(Tm))),
                               rtol=1e-5, atol=2e-6)
    pts = rng.normal(size=(32, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        N(TS.transform_points(T(Tm), T(pts))),
        N(JS.transform_points(jnp.asarray(Tm), jnp.asarray(pts))),
        rtol=1e-5, atol=1e-5)


def test_sh_round_trip_matches_jax():
    rgb = np.random.default_rng(2).uniform(0, 1, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(N(TSH.rgb_to_sh(T(rgb))),
                               N(JSH.rgb_to_sh(jnp.asarray(rgb))), rtol=1e-6)
    sh = N(JSH.rgb_to_sh(jnp.asarray(rgb)))
    np.testing.assert_allclose(N(TSH.sh_to_rgb(T(sh))),
                               N(JSH.sh_to_rgb(jnp.asarray(sh))), rtol=1e-6)


# ---------------------------------------------------------------------------
# core/gaussians.py
# ---------------------------------------------------------------------------


def _rows_np(rng, m):
    return {"xyz": rng.normal(size=(m, 3)).astype(np.float32),
            "rgb": rng.uniform(0, 1, (m, 3)).astype(np.float32),
            "dist2": rng.uniform(1e-4, 1e-2, m).astype(np.float32),
            "opacity": rng.uniform(0.1, 0.9, m).astype(np.float32)}


@pytest.mark.parametrize("capacity,m", [(16, 6), (16, 20), (64, 40)])
def test_insert_prune_match_jax(capacity, m):
    """Dead-first slot allocation, dropped overflow rows, Adam slot reset
    and prune give identical states (exact: no arithmetic)."""
    rng = np.random.default_rng(capacity + m)
    r = _rows_np(rng, m)
    valid = rng.uniform(size=m) > 0.2
    jst = JG.empty_state(capacity)
    jrows = JG.point_rows(*(jnp.asarray(r[k]) for k in
                            ("xyz", "rgb", "dist2", "opacity")))
    tst = TG.empty_state(capacity)
    trows = TG.point_rows(*(T(r[k]) for k in ("xyz", "rgb", "dist2",
                                              "opacity")))
    for k in TG.PARAM_KEYS:
        np.testing.assert_allclose(N(getattr(trows, k)),
                                   N(getattr(jrows, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    jst, jn = JG.insert(jst, jrows, jnp.asarray(valid))
    tst, tn = TG.insert(tst, trows, T(valid))
    assert tn == int(jn)
    kill = rng.uniform(size=capacity) > 0.6
    jst = JG.prune(jst, jnp.asarray(kill))
    tst = TG.prune(tst, T(kill))
    jst, jn = JG.insert(jst, jrows, jnp.ones(m, bool))
    tst, tn = TG.insert(tst, trows, torch.ones(m, dtype=torch.bool))
    assert tn == int(jn)
    np.testing.assert_array_equal(N(tst.alive), N(jst.alive))
    for k in TG.PARAM_KEYS:
        np.testing.assert_allclose(N(getattr(tst.params, k)),
                                   N(getattr(jst.params, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("n,cap", [(1, 1 << 18), (9000, 1 << 18),
                                   (70000, 1 << 16), (1 << 20, 1 << 18)])
def test_bucket_for_matches_jax(n, cap):
    assert TG.bucket_for(n, cap) == JG.bucket_for(n, cap)


def test_expand_state_matches_jax():
    rng = np.random.default_rng(3)
    r = _rows_np(rng, 10)
    jst, _ = JG.insert(JG.empty_state(16), JG.point_rows(
        *(jnp.asarray(r[k]) for k in ("xyz", "rgb", "dist2", "opacity"))),
        jnp.ones(10, bool))
    tst, _ = TG.insert(TG.empty_state(16), TG.point_rows(
        *(T(r[k]) for k in ("xyz", "rgb", "dist2", "opacity"))),
        torch.ones(10, dtype=torch.bool))
    jst = JG.expand_state(jst, 40)
    tst = TG.expand_state(tst, 40)
    assert tst.capacity == 40
    np.testing.assert_array_equal(N(tst.alive), N(jst.alive))
    for k in TG.PARAM_KEYS:
        np.testing.assert_allclose(N(getattr(tst.params, k)),
                                   N(getattr(jst.params, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for k in TG.OPT_KEYS:
        assert tst.adam.mu[k].shape == getattr(jst.adam.mu, k).shape


def test_edge_pair_seeds_match_jax():
    """Edge pairs on a synthetic edge image: the same deduped pairs,
    memberships and pair gaussians (float32; quats 1e-5)."""
    rng = np.random.default_rng(4)
    h, w = 24, 32
    edge = np.zeros((h, w), bool)
    edge[8, 4:28] = True
    edge[4:20, 16] = True
    edge[rng.integers(0, h, 20), rng.integers(0, w, 20)] = True
    depth = (2.0 + 0.002 * rng.normal(size=(h, w))).astype(np.float32)
    pts = rng.normal(size=(h * w, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (h * w, 3)).astype(np.float32)
    ids = rng.choice(h * w, 200, replace=False).astype(np.int32)
    ids[:30] = np.flatnonzero(edge.reshape(-1))[:30]
    sval = rng.uniform(size=200) > 0.1
    j = JG.edge_pair_seeds(jnp.asarray(ids), jnp.asarray(sval),
                           jnp.asarray(edge), jnp.asarray(depth),
                           jnp.asarray(pts), jnp.asarray(cols), h, w)
    t = TG.edge_pair_seeds(T(ids), T(sval), T(edge), T(depth), T(pts),
                           T(cols), h, w)
    assert int(N(j[2]).sum()) > 5
    for i in (0, 1, 2, 7):
        np.testing.assert_array_equal(N(t[i]), N(j[i]), err_msg=str(i))
    ok = N(j[2])
    for i in (3, 4, 5, 6):
        np.testing.assert_allclose(N(t[i])[ok], N(j[i])[ok], rtol=1e-5,
                                   atol=1e-5, err_msg=str(i))
    jr = JG.edge_rows(*j[3:7])
    tr = TG.edge_rows(*t[3:7])
    for k in TG.PARAM_KEYS:
        np.testing.assert_allclose(N(getattr(tr, k))[ok],
                                   N(getattr(jr, k))[ok], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# ops/rasterizer.py (sorted path; JAX side in Pallas interpret mode)
# ---------------------------------------------------------------------------

RCAM = (60.0, 60.0, 23.5, 15.5, 48, 32)
JRCFG = JR.RasterConfig(tile=16, dup_side=4, chunk=16, backend="sorted",
                        seg_cap=256, bands=3, group=2)
TRCFG = TR.RasterConfig(tile=16, dup_side=4, seg_cap=256, bands=3)


def _scene(seed, n=48):
    """The scene of tests/test_rasterizer_v2.py (numpy)."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    return (means, _quats(rng, n),
            np.log(rng.uniform(0.02, 0.07, (n, 3))).astype(np.float32),
            rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32),
            np.eye(4, dtype=np.float32))


def _pose(seed):
    tau = 0.03 * np.random.default_rng(seed).normal(size=6)
    return N(JS.se3_exp(jnp.asarray(tau, jnp.float32)))


def test_projection_and_center_sort_match_jax():
    """EWA projection within float32 rounding; the centre-tile sort, the
    128-aligned segment starts and the seg_cap clip are bit for bit."""
    a = _scene(0, 300)
    w2c = _pose(0)
    cap = JR._v2_radius_cap(JRCFG)
    assert TR._v2_radius_cap(TRCFG) == cap
    jp = JR.project_gaussians(*(jnp.asarray(x) for x in a[:4]),
                              jnp.asarray(w2c), JC.Camera(*RCAM), JRCFG,
                              radius_cap=cap)
    tp = TR.project_gaussians(*(T(x) for x in a[:4]), T(w2c),
                              TC.Camera(*RCAM), TRCFG, radius_cap=cap)
    for name in ("mean2d", "conic", "depth", "radius", "opacity"):
        np.testing.assert_allclose(N(getattr(tp, name)),
                                   N(getattr(jp, name)), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
    # Sort the same projection (the JAX one) on both sides: exact.
    tp_j = TR._Projected(*(T(getattr(jp, f)) for f in TR._Projected._fields))
    for cfg_j, cfg_t in ((JRCFG, TRCFG),
                         (JRCFG._replace(seg_cap=128),
                          TRCFG._replace(seg_cap=128))):
        jo, js, jc = JR._center_sort(jp, JC.Camera(*RCAM), cfg_j)
        to, ts, tcnt = TR._center_sort(tp_j, TC.Camera(*RCAM), cfg_t)
        np.testing.assert_array_equal(N(to), N(jo))
        np.testing.assert_array_equal(N(ts), N(js))
        np.testing.assert_array_equal(N(tcnt), N(jc))


def _render_both(args, w2c, grads=False, seed=0):
    """JAX and port `render` on one scene; with `grads`, also the grads of a
    mixed colour/depth/alpha loss w.r.t. every input including w2c."""
    jcam, tcam = JC.Camera(*RCAM), TC.Camera(*RCAM)
    target = np.random.default_rng(seed).uniform(
        0, 1, (RCAM[5], RCAM[4], 3)).astype(np.float32)

    def jloss(*xs):
        o = JR.render(*xs, jcam, JRCFG)
        return (jnp.mean(jnp.abs(o.color - target)) + 0.1 * jnp.mean(o.depth)
                + 0.05 * jnp.mean(o.alpha)), o

    jargs = [jnp.asarray(x) for x in args[:5]] + [jnp.asarray(w2c)]
    targs = [T(x).requires_grad_(grads) for x in args[:5]] + \
        [T(w2c).requires_grad_(grads)]
    o = TR.render(*targs, tcam, TRCFG)
    if not grads:
        return jloss(*jargs)[1], o, None, None
    (_, jo), jg = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                     has_aux=True)(*jargs)
    loss = (torch.mean(torch.abs(o.color - T(target)))
            + 0.1 * torch.mean(o.depth) + 0.05 * torch.mean(o.alpha))
    tg = torch.autograd.grad(loss, targs)
    return jo, o, jg, tg


@pytest.mark.parametrize("seed", [0, 1])
def test_render_forward_matches_jax(seed):
    """Full-frame render. Tolerance: colour / alpha 1e-4, depth 5e-4 (the
    compositing's float32 sums in another order, see
    test_torch_compositor.py)."""
    jo, to, _, _ = _render_both(_scene(seed), _pose(seed))
    np.testing.assert_allclose(N(to.color), N(jo.color), atol=1e-4)
    np.testing.assert_allclose(N(to.alpha), N(jo.alpha), atol=1e-4)
    np.testing.assert_allclose(N(to.depth), N(jo.depth), atol=5e-4)
    np.testing.assert_array_equal(N(to.radii), N(jo.radii))
    assert float(N(to.alpha).max()) > 0.5


def test_render_gradients_match_jax():
    """All-input gradients through projection, the sorted gather (its
    backward a scatter-add) and K2's twin. Tolerance: 1e-3 of each input's
    largest |grad| (float32 sums in another order through the whole
    chain)."""
    _, _, jg, tg = _render_both(_scene(2, 32), _pose(2), grads=True, seed=2)
    names = ["means", "quats", "log_scales", "opacity", "colors", "w2c"]
    for name, a, b in zip(names, tg, jg):
        b = N(b)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(N(a), b, atol=1e-3 * scale, err_msg=name)
        assert np.abs(b).max() > 0, name


def test_render_tiles_and_gt_tiles_match_jax():
    a = _scene(3)
    w2c = _pose(3)
    ids = np.array([0, 2, 5], np.int32)
    jt = JR.render_tiles(*(jnp.asarray(x) for x in a[:5]), jnp.asarray(w2c),
                         jnp.asarray(ids), JC.Camera(*RCAM), JRCFG)
    tt = TR.render_tiles(*(T(x) for x in a[:5]), T(w2c), T(ids),
                         TC.Camera(*RCAM), TRCFG)
    np.testing.assert_allclose(N(tt.color), N(jt.color), atol=1e-4)
    np.testing.assert_allclose(N(tt.depth), N(jt.depth), atol=5e-4)
    np.testing.assert_allclose(N(tt.alpha), N(jt.alpha), atol=1e-4)
    img = np.random.default_rng(3).uniform(size=(30, 45, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        N(TR.gt_tiles(T(img), T(ids), 16, 3, 2)),
        N(JR.gt_tiles(jnp.asarray(img), jnp.asarray(ids), 16, 3, 2)))
    np.testing.assert_allclose(
        N(TR.tile_sums(T(img[..., 0]), 16, 3, 2)),
        N(JR.tile_sums(jnp.asarray(img[..., 0]), 16, 3, 2)), rtol=1e-5)


def test_resident_sorted_render_matches_jax():
    """sorted_layout + render_sorted_resident(_tiles): rows permuted into
    the layout's order render like the JAX resident path, with the same
    parameter gradients."""
    a = _scene(4, 64)
    w2c = _pose(4)
    jcam, tcam = JC.Camera(*RCAM), TC.Camera(*RCAM)
    jord, jss, jsc = JR.sorted_layout(*(jnp.asarray(x) for x in a[:4]),
                                      jnp.asarray(w2c), jcam, JRCFG)
    tord, tss, tsc = TR.sorted_layout(*(T(x) for x in a[:4]), T(w2c), tcam,
                                      TRCFG)
    np.testing.assert_array_equal(N(tord), N(jord))
    order = N(jord)
    perm = [x[order] for x in a[:5]]

    def jloss(means, ls):
        o = JR.render_sorted_resident(means, perm[1], ls, perm[3], perm[4],
                                      jnp.asarray(w2c), jss, jsc, jcam,
                                      JRCFG)
        return jnp.mean(o.color) + 0.1 * jnp.mean(o.depth), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(perm[0]), jnp.asarray(perm[2]))
    m, ls = T(perm[0]).requires_grad_(True), T(perm[2]).requires_grad_(True)
    to = TR.render_sorted_resident(m, T(perm[1]), ls, T(perm[3]), T(perm[4]),
                                   T(w2c), tss, tsc, tcam, TRCFG)
    tg = torch.autograd.grad(torch.mean(to.color)
                             + 0.1 * torch.mean(to.depth), [m, ls])
    np.testing.assert_allclose(N(to.color), N(jo.color), atol=1e-4)
    np.testing.assert_allclose(N(to.depth), N(jo.depth), atol=5e-4)
    for a_, b_ in zip(tg, jg):
        scale = max(np.abs(N(b_)).max(), 1e-9)
        np.testing.assert_allclose(N(a_), N(b_), atol=1e-3 * scale)
    ids = np.array([4, 1], np.int32)
    jt = JR.render_sorted_resident_tiles(
        *(jnp.asarray(x) for x in perm), jnp.asarray(w2c), jss, jsc,
        jnp.asarray(ids), jcam, JRCFG)
    tt = TR.render_sorted_resident_tiles(*(T(x) for x in perm), T(w2c), tss,
                                         tsc, T(ids), tcam, TRCFG)
    np.testing.assert_allclose(N(tt.color), N(jt.color), atol=1e-4)


@pytest.mark.parametrize("subset", [False, True])
def test_frozen_sorted_pose_grads_match_jax(subset):
    """The tracking render: freeze at one pose, render at a nearby pose,
    and differentiate w.r.t. the pose through `_reproject_rows`.
    Tolerance: images 1e-4 (depth 5e-4); pose grads 2e-3 of the largest."""
    a = _scene(5, 64)
    jcam, tcam = JC.Camera(*RCAM), TC.Camera(*RCAM)
    w0, w1 = _pose(5), _pose(6)
    jfs = JR.freeze_sorted(*(jnp.asarray(x) for x in a[:5]),
                           jnp.asarray(w0), jcam, JRCFG)
    tfs = TR.freeze_sorted(*(T(x) for x in a[:5]), T(w0), tcam, TRCFG)
    np.testing.assert_allclose(N(tfs.e3d), N(jfs.e3d), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(N(tfs.seg_start), N(jfs.seg_start))
    np.testing.assert_array_equal(N(tfs.seg_cnt), N(jfs.seg_cnt))
    ids = np.array([5, 0, 3], np.int32)

    def jrender(w):
        if subset:
            return JR.render_frozen_sorted_tiles(jfs, w, jnp.asarray(ids),
                                                 jcam, JRCFG)
        return JR.render_frozen_sorted(jfs, w, jcam, JRCFG)

    def trender(w):
        if subset:
            return TR.render_frozen_sorted_tiles(tfs, w, T(ids), tcam, TRCFG)
        return TR.render_frozen_sorted(tfs, w, tcam, TRCFG)

    def jloss(w):
        o = jrender(w)
        return jnp.mean(o.color) + 0.1 * jnp.mean(o.depth), o

    (_, jo), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(w1))
    w = T(w1).requires_grad_(True)
    to = trender(w)
    (tg,) = torch.autograd.grad(torch.mean(to.color)
                                + 0.1 * torch.mean(to.depth), [w])
    np.testing.assert_allclose(N(to.color), N(jo.color), atol=1e-4)
    np.testing.assert_allclose(N(to.depth), N(jo.depth), atol=5e-4)
    jg = N(jg)
    np.testing.assert_allclose(N(tg), jg, atol=2e-3 * np.abs(jg).max())
    assert np.abs(jg).max() > 0


# ---------------------------------------------------------------------------
# ops/losses.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(32, 48, 3), (17, 23), (40, 40, 1)])
def test_losses_match_jax(shape):
    """L1, masked L1, banded SSIM, PSNR (float32 sums: 1e-5 relative)."""
    rng = np.random.default_rng(len(shape))
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    mask = (rng.uniform(size=shape[:2]) > 0.3).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(TL.l1_loss(T(a), T(b))),
                               N(JL.l1_loss(ja, jb)), **tol)
    np.testing.assert_allclose(N(TL.masked_l1(T(a), T(b), T(mask))),
                               N(JL.masked_l1(ja, jb, jnp.asarray(mask))),
                               **tol)
    np.testing.assert_allclose(N(TL.ssim(T(a), T(b))), N(JL.ssim(ja, jb)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(N(TL.psnr(T(a), T(b))), N(JL.psnr(ja, jb)),
                               **tol)


@pytest.mark.parametrize("shape", [(176, 200, 3), (170, 171)])
def test_ms_ssim_matches_jax(shape):
    """The evaluator's MS-SSIM: five scales with odd-size average pooling
    (float32 products of powers: 1e-5 absolute)."""
    rng = np.random.default_rng(shape[1])
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.15 * rng.normal(size=shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(N(TL.ms_ssim(T(a), T(b))),
                               N(JL.ms_ssim(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5)


def test_ssim_batched_and_isotropic_match_jax():
    rng = np.random.default_rng(7)
    a = rng.uniform(size=(4, 16, 16, 3)).astype(np.float32)
    b = rng.uniform(size=(4, 16, 16, 3)).astype(np.float32)
    ref = np.stack([N(JL.ssim(jnp.asarray(x), jnp.asarray(y)))
                    for x, y in zip(a, b)])
    np.testing.assert_allclose(N(TL.ssim_batched(T(a), T(b))), ref,
                               rtol=1e-5, atol=1e-5)
    ls = rng.normal(-4, 0.5, (50, 3)).astype(np.float32)
    alive = rng.uniform(size=50) > 0.3
    np.testing.assert_allclose(
        N(TL.isotropic_loss(T(ls), T(alive))),
        N(JL.isotropic_loss(jnp.asarray(ls), jnp.asarray(alive))), rtol=1e-5)


# ---------------------------------------------------------------------------
# ops/image.py
# ---------------------------------------------------------------------------


def _gray_img(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    img[8:30, 10:40] = 200.0
    img[15:22, 20:50] += 40.0
    return img + rng.uniform(0, 20, (h, w)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_image_ops_match_jax(seed):
    """Sobel / gradient probabilities (float32 1e-5), Canny and dilation
    (exact masks), luma, hole-aware depth downsampling, bit unpacking."""
    img = _gray_img(seed)
    ji = jnp.asarray(img)
    for a, b in zip(TI.sobel(T(img)), JI.sobel(ji)):
        np.testing.assert_allclose(N(a), N(b), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(N(TI.gradient_sample_probs(T(img))),
                               N(JI.gradient_sample_probs(ji)), rtol=1e-5,
                               atol=1e-9)
    for l2 in (True, False):
        je = N(JI.canny(ji, 100.0, 150.0, l2gradient=l2))
        assert je.sum() > 20
        np.testing.assert_array_equal(
            N(TI.canny(T(img), 100.0, 150.0, l2gradient=l2)), je)
        for size in (2, 3):
            np.testing.assert_array_equal(
                N(TI.dilate(T(je), size)), N(JI.dilate(jnp.asarray(je),
                                                       size)))
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 1, (12, 14, 3)).astype(np.float32)
    np.testing.assert_allclose(N(TI.rgb_to_gray(T(rgb))),
                               N(JI.rgb_to_gray(jnp.asarray(rgb))),
                               rtol=1e-6)
    depth = rng.uniform(0.5, 3, (13, 15)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) > 0.6] = 0.0
    np.testing.assert_allclose(N(TI.depth_pyr_down(T(depth))),
                               N(JI.depth_pyr_down(jnp.asarray(depth))),
                               rtol=1e-6)
    mask = rng.uniform(size=(9, 21)) > 0.5
    bits = np.packbits(mask, axis=1)
    np.testing.assert_array_equal(
        N(TI.unpack_mask_bits(T(bits), 9, 21)),
        N(JI.unpack_mask_bits(jnp.asarray(bits), 9, 21)))
    np.testing.assert_array_equal(N(TI.unpack_mask_bits(T(bits), 9, 21)),
                                  mask)


# ---------------------------------------------------------------------------
# ops/knn.py
# ---------------------------------------------------------------------------


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * [1.0, 0.5, 0.2]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_knn_brute_force_match_jax(seed):
    """Chunked brute force: mean kNN distance (float32 distance expansion,
    1e-4 relative), nearest distance, radius dedup and the statistical
    outlier mask (exact masks)."""
    pts = _cloud(seed, 120)
    mask = np.ones(120, bool)
    mask[100:] = False
    jp, jm = jnp.asarray(pts), jnp.asarray(mask)
    np.testing.assert_allclose(N(TK.mean_sq_dist_knn(T(pts), T(mask), 3, 32)),
                               N(JK.mean_sq_dist_knn(jp, jm, 3, 32)),
                               rtol=1e-4, atol=1e-7)
    q = _cloud(seed + 10, 40)
    qm = np.ones(40, bool)
    ref = np.concatenate([pts, q])
    rm = np.concatenate([mask, qm])
    np.testing.assert_allclose(
        N(TK.mean_sq_dist_knn_query(T(q), T(qm), T(ref), T(rm), 3, 16,
                                    self_offset=120)),
        N(JK.mean_sq_dist_knn_query(jnp.asarray(q), jnp.asarray(qm),
                                    jnp.asarray(ref), jnp.asarray(rm), 3, 16,
                                    self_offset=120)), rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(
        N(TK.radius_dedup(T(q), T(qm), T(pts), T(mask), 0.15, 16)),
        N(JK.radius_dedup(jnp.asarray(q), jnp.asarray(qm), jp, jm, 0.15,
                          16)))
    out = pts.copy()
    out[:3] += 8.0
    np.testing.assert_array_equal(
        N(TK.statistical_inlier_mask(T(out), T(mask), 5, 2.0, 32)),
        N(JK.statistical_inlier_mask(jnp.asarray(out), jm, 5, 2.0, 32)))


@pytest.mark.parametrize("seed,radius", [(0, 0.05), (1, 0.2), (2, 1e-7)])
def test_morton_window_nn_matches_jax(seed, radius):
    """Morton codes (exact) and the fused dedup + kNN of map growth: the
    keep mask exact, the kNN distances within float32 rounding."""
    ex = _cloud(seed, 300)
    exm = np.random.default_rng(seed).uniform(size=300) > 0.2
    cand = (_cloud(seed + 5, 150) * 1.1).astype(np.float32)
    cm = np.ones(150, bool)
    cm[::9] = False
    np.testing.assert_array_equal(
        N(TK.morton_codes(T(ex), T(exm))),
        N(JK.morton_codes(jnp.asarray(ex), jnp.asarray(exm))).astype(
            np.int64))
    jk, jd = JK.morton_window_nn(jnp.asarray(cand), jnp.asarray(cm),
                                 jnp.asarray(ex), jnp.asarray(exm), radius)
    tk, td = TK.morton_window_nn(T(cand), T(cm), T(ex), T(exm), radius)
    np.testing.assert_array_equal(N(tk), N(jk))
    np.testing.assert_allclose(N(td), N(jd), rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# utils/optim.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("amsgrad", [False, True])
def test_adam_matches_jax(amsgrad):
    """Eight Adam steps with per-leaf learning rates and one slot reset.
    Tolerance: 1e-5 relative, 1e-5 absolute (1e-3 of a step of lr 1e-2:
    rows whose moments were reset divide by square roots of tiny second
    moments, where float32 rounding differs in the last bits)."""
    rng = np.random.default_rng(int(amsgrad))
    params = {"a": rng.normal(size=(20, 3)).astype(np.float32),
              "b": rng.normal(size=(20, 1)).astype(np.float32)}
    lrs = {"a": 1e-2, "b": 5e-2}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: T(v) for k, v in params.items()}
    js, ts = JO.adam_init(jp), TO.adam_init(tp)
    for step in range(8):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        jp, js = JO.adam_update(js, jp, {k: jnp.asarray(v) for k, v in
                                         g.items()}, lrs, amsgrad=amsgrad)
        tp, ts = TO.adam_update(ts, tp, {k: T(v) for k, v in g.items()},
                                lrs, amsgrad=amsgrad)
        if step == 3:
            idx = np.array([1, 5, 7], np.int32)
            ok = np.array([True, False, True])
            js = JO.reset_slots(js, jnp.asarray(idx), jnp.asarray(ok))
            ts = TO.reset_slots(ts, T(idx).long(), T(ok))
    assert ts.step == int(js.step)
    for k in params:
        np.testing.assert_allclose(N(tp[k]), N(jp[k]), rtol=1e-5, atol=1e-5)
        for slot in ("mu", "nu", "vmax"):
            np.testing.assert_allclose(N(getattr(ts, slot)[k]),
                                       N(getattr(js, slot)[k]), rtol=1e-5,
                                       atol=1e-9)


def test_schedules_match_jax():
    for step in (0, 10, 500, 2000):
        for delay in (0, 100):
            np.testing.assert_allclose(
                TO.exp_lr_schedule(step, 1e-2, 1e-4, 1000, 0.01, delay),
                float(JO.exp_lr_schedule(jnp.asarray(step), 1e-2, 1e-4, 1000,
                                         0.01, delay)), rtol=1e-5)
    js, ts = JO.plateau_init(), TO.plateau_init()
    losses = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.98, 0.99, 0.85, 0.9, 0.9,
              0.91, 0.92, 0.93, 0.94, 0.95]
    for loss in losses:
        js = JO.plateau_update(js, jnp.float32(loss), 3, 0.5)
        ts = TO.plateau_update(ts, float(np.float32(loss)), 3, 0.5)
        assert ts.bad_count == int(js.bad_count)
        np.testing.assert_allclose(ts.lr_scale, float(js.lr_scale),
                                   rtol=1e-6)
    assert ts.lr_scale < 1.0


# ---------------------------------------------------------------------------
# lc/descriptor.py, evaluation/trajectory.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 96), (75, 130)])
def test_global_descriptor_matches_jax(hw):
    """The place-recognition descriptor cached into every submap file
    (float32 resizes and histograms: 1e-5 absolute on a unit vector)."""
    rng = np.random.default_rng(hw[0])
    rgb = rng.uniform(0, 1, hw + (3,)).astype(np.float32)
    rgb[hw[0] // 3:, : hw[1] // 2] *= 0.3
    np.testing.assert_allclose(N(t_descriptor(T(rgb))),
                               N(j_descriptor(jnp.asarray(rgb))), atol=1e-5)


def test_trajectory_eval_matches_jax(tmp_path):
    """Raw / Horn-aligned ATE and RPE of a perturbed trajectory (float64
    numpy on both sides: 1e-9 relative)."""
    rng = np.random.default_rng(9)
    gt = np.stack([N(JS.se3_exp(jnp.asarray(0.3 * rng.normal(size=6),
                                            jnp.float32))).astype(np.float64)
                   for _ in range(12)])
    est = gt.copy()
    est[:, :3, 3] += 0.02 * rng.normal(size=(12, 3))
    j = JTR.evaluate_trajectory(est, gt)
    t = TTR.evaluate_trajectory(est, gt, str(tmp_path))
    for sec in ("ate", "ate_aligned", "rpe"):
        for k, v in j[sec].items():
            np.testing.assert_allclose(t[sec][k], v, rtol=1e-9, err_msg=k)
    assert (tmp_path / "ate.json").exists()
