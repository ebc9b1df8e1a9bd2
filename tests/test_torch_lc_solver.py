"""Loop-closure registration in the port against the JAX package, on the
same numpy inputs from a seed: `information_matrix`, `icp_registration`,
the tracker's `refine_pose` (re-binning every step, as viewpoint
localisation runs it), `gaussian_registration` on the 64x48 camera of
tests/test_gs_registration.py with the sorted backend on both sides (JAX in
Pallas interpret mode), and the RANSAC core fed JAX's own draws.
Tolerances are stated in each test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.core.gaussians import GaussianParams as JParams
from eags_slam_tpu.core.se3 import se3_exp as j_se3_exp
from eags_slam_tpu.core.sh import rgb_to_sh as j_rgb_to_sh
from eags_slam_tpu.core.sh import sh_to_rgb as j_sh_to_rgb
from eags_slam_tpu.lc import pcr as JPCR
from eags_slam_tpu.lc import solver as JS
from eags_slam_tpu.lc.descriptor import GlobalDesc as JGlobalDesc
from eags_slam_tpu.ops.rasterizer import RasterConfig as JRaster
from eags_slam_tpu.ops.rasterizer import render as j_render
from eags_slam_tpu.slam import tracker as JT
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.core.gaussians import GaussianParams
from eags_slam_torch.lc import pcr as TPCR
from eags_slam_torch.lc import solver as TS
from eags_slam_torch.ops.rasterizer import RasterConfig
from eags_slam_torch.slam import tracker as TT

CAM = Camera(fx=70.0, fy=70.0, cx=31.5, cy=23.5, width=64, height=48)
JCAM = JCamera(*CAM)
JRCFG = JRaster(tile=16, dup_side=4, backend="sorted", seg_cap=256, bands=3)
RCFG = RasterConfig(tile=16, dup_side=4, backend="sorted", seg_cap=256,
                    bands=3)


def _scene(rng, n=300):
    """The scene of tests/test_gs_registration.py."""
    xyz = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                    rng.uniform(1.5, 3.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return {
        "xyz": xyz,
        "f_dc": np.asarray(j_rgb_to_sh(jnp.asarray(
            rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)))),
        "f_rest": np.zeros((n, 15, 3), np.float32),
        "log_scales": np.log(rng.uniform(0.06, 0.15, (n, 3))).astype(
            np.float32),
        "quats": q,
        "opacity_logits": rng.uniform(1.5, 4.0, (n, 1)).astype(np.float32),
    }


def _moved(g, T):
    out = dict(g)
    out["xyz"] = (g["xyz"] @ T[:3, :3].T.astype(np.float32)
                  + T[:3, 3].astype(np.float32))
    return out


def _frame(g, c2w):
    """The JAX sorted renderer's RGB-D frame of `g` at c2w (numpy)."""
    out = j_render(jnp.asarray(g["xyz"]), jnp.asarray(g["quats"]),
                   jnp.asarray(g["log_scales"]),
                   jnp.asarray(g["opacity_logits"]),
                   j_sh_to_rgb(jnp.asarray(g["f_dc"])),
                   jnp.asarray(np.linalg.inv(c2w), dtype=jnp.float32), JCAM,
                   JRCFG)
    color = np.asarray(jnp.clip(out.color, 0, 1))
    depth = np.asarray(jnp.where(out.alpha > 0.5,
                                 out.depth / jnp.maximum(out.alpha, 1e-6),
                                 0.0))
    return color, depth


def _views(g, c2ws):
    desc = JGlobalDesc()
    views, descs = [], []
    for c2w in c2ws:
        color, depth = _frame(g, c2w)
        views.append({"c2w": c2w, "color": color, "depth": depth})
        descs.append(np.asarray(desc(color)))
    return views, np.stack(descs)


def _angle_deg(R):
    return np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def test_information_matrix_matches_jax(rng):
    """Same correspondences, same closed form: equal to rtol 1e-6 (float64
    sums of the same float32 points)."""
    src = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    tgt = src + rng.normal(scale=0.03, size=src.shape).astype(np.float32)
    tgt[::3] += 1.0                      # a third without a correspondence
    j = JS.information_matrix(src, tgt, max_corr=0.1)
    t = TS.information_matrix(src, tgt, max_corr=0.1)
    assert 100 < j[0, 0] < 400
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(TS.information_matrix(src, src + 5.0, 0.1),
                                  np.eye(6))


@pytest.mark.parametrize("n", [500, 3000])
def test_icp_registration_matches_jax(rng, n):
    """Point-to-point ICP: the same correction to 1e-5 and the same
    fitness."""
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    T = np.asarray(j_se3_exp(jnp.asarray([0.05, -0.03, 0.02, 0.02, 0.03,
                                          -0.01])), np.float64)
    Ti = np.linalg.inv(T)
    tgt = (pts @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
    j = JS.icp_registration({"xyz": pts}, {"xyz": tgt})
    t = TS.icp_registration({"xyz": pts}, {"xyz": tgt})
    assert t.successful and j.successful
    np.testing.assert_allclose(t.transformation, j.transformation, atol=1e-5)
    assert abs(t.fitness - j.fitness) < 1e-6
    assert np.linalg.norm(t.transformation - T) < 0.02


def test_refine_pose_matches_jax(rng):
    """viewpoint_localize's refinement (frozen_binning off: a sort every
    step) from a perturbed pose, directly and through viewpoint_localize:
    the poses agree within 1 mm and 0.05 deg, the iteration counts exactly,
    the losses to 1e-3 relative."""
    g = _scene(rng)
    color, depth = _frame(g, np.eye(4))
    tau = np.array([0.02, -0.015, 0.01, 0.01, -0.012, 0.008], np.float32)
    init_rel = np.asarray(j_se3_exp(jnp.asarray(tau)))
    kw = dict(iterations=15, cam_rot_lr=3e-3, cam_trans_lr=1e-3,
              w_color_loss=0.95, alpha_thre=0.95, soft_alpha=False,
              early_stop_cnt=15, plateau_factor=0.98, plateau_patience=5,
              frozen_binning=False)
    jp = JParams(**{k: jnp.asarray(v) for k, v in g.items()})
    alive = np.ones(g["xyz"].shape[0], bool)
    j_rel, _, j_stats = JT.refine_pose(
        jp, jnp.asarray(alive), jnp.asarray(init_rel), jnp.eye(4),
        jnp.asarray(color), jnp.asarray(depth), jnp.asarray(15, jnp.int32),
        jnp.zeros(2), JCAM, JRCFG, JT.TrackerConfig(**kw))
    tp = GaussianParams(**{k: torch.as_tensor(v) for k, v in g.items()})
    t_rel, _, t_stats = TT.refine_pose(
        tp, torch.as_tensor(alive), torch.as_tensor(init_rel), torch.eye(4),
        torch.as_tensor(color), torch.as_tensor(depth), 15, torch.zeros(2),
        CAM, RCFG, TT.TrackerConfig(**kw))
    j_rel, j_stats = np.asarray(j_rel, np.float64), np.asarray(j_stats)
    d = np.linalg.inv(j_rel) @ t_rel.numpy().astype(np.float64)
    assert np.linalg.norm(d[:3, 3]) < 1e-3 and _angle_deg(d[:3, :3]) < 0.05
    np.testing.assert_array_equal(t_stats[3:5], j_stats[3:5])
    np.testing.assert_allclose(t_stats[0:3], j_stats[0:3], rtol=1e-3)
    # viewpoint_localize: the same refinement with loop closure's settings,
    # from a view whose stored pose is off by the perturbation.
    view_c2w = np.linalg.inv(init_rel.astype(np.float64))
    j_c2w, j_loss = JS.viewpoint_localize(
        jp, jnp.asarray(alive), view_c2w, jnp.asarray(color),
        jnp.asarray(depth), JCAM, JRCFG, iters=15)
    t_c2w, t_loss = TS.viewpoint_localize(
        tp, torch.as_tensor(alive), view_c2w, torch.as_tensor(color),
        torch.as_tensor(depth), CAM, RCFG, iters=15)
    d = np.linalg.inv(j_c2w) @ t_c2w
    assert np.linalg.norm(d[:3, 3]) < 1e-3 and _angle_deg(d[:3, :3]) < 0.05
    assert abs(t_loss - j_loss) <= 1e-3 * abs(j_loss)


def test_gaussian_registration_matches_jax(rng):
    """gs_reg on a target submap misplaced by a known drift: one view a
    side, two localisation segments (the first on the top half of the
    tiles, the last on the full image). Both recover the drift (the JAX
    test's 3 cm / 1.5 deg), and their corrections agree to atol 1e-3; the
    overlap ratios are equal."""
    src = _scene(rng)
    err = np.asarray(j_se3_exp(jnp.asarray(
        [0.03, -0.02, 0.015, 0.008, -0.01, 0.008])), np.float64)
    tgt = _moved(src, np.linalg.inv(err))
    views_src, desc_src = _views(src, [np.eye(4)])
    views_tgt, desc_tgt = _views(tgt, [np.linalg.inv(err)])
    kw = dict(capacity=512, overlap_thre=0.1, top_views=1,
              pose_opt_iters=60, overlap_dist=0.2, localize_restarts=2,
              localize_subset_frac=0.5)
    j = JS.gaussian_registration(src, tgt, views_src, views_tgt, desc_src,
                                 desc_tgt, JCAM, JRCFG, **kw)
    timings = {}
    t = TS.gaussian_registration(src, tgt, views_src, views_tgt, desc_src,
                                 desc_tgt, CAM, RCFG, timings=timings, **kw)
    assert j.successful and t.successful
    assert abs(t.overlap - j.overlap) < 1e-6
    np.testing.assert_allclose(t.transformation, j.transformation, atol=1e-3)
    diff = t.transformation @ np.linalg.inv(err)
    assert np.linalg.norm(diff[:3, 3]) < 0.03
    assert _angle_deg(diff[:3, :3]) < 1.5
    assert set(timings) == {"subsample_ms", "overlap_ms", "views_ms",
                            "localize_ms"}


def test_gaussian_registration_overlap_gate(rng):
    """Disjoint submaps: both reject at the overlap gate, with the same
    ratio; a 600-row submap over capacity 512 takes the same seeded rows."""
    src = _scene(rng, n=600)
    far = _moved(src, np.eye(4))
    far["xyz"] = src["xyz"] + 100.0
    args = (src, far, [], [], np.zeros((0, 1024)), np.zeros((0, 1024)))
    j = JS.gaussian_registration(*args, JCAM, JRCFG, capacity=512)
    t = TS.gaussian_registration(*args, CAM, RCFG, capacity=512)
    assert not j.successful and not t.successful
    assert t.overlap == j.overlap < 0.2
    jp, ja = JS._pad_params(src, 512)
    tp, ta = TS.subsample_params(src, 512, "cpu")
    np.testing.assert_array_equal(tp.xyz.numpy(), np.asarray(jp.xyz)[:512])
    assert bool(ta.all()) and int(np.asarray(ja).sum()) == 512


def test_ransac_core_with_jax_draws(rng):
    """The RANSAC core on a correspondence set with 40% outliers, fed the
    triples JAX draws from PRNGKey(0): the same best transform (atol 1e-4)
    and inlier fraction (equal to 1e-6)."""
    m = 600
    src = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    T = np.asarray(j_se3_exp(jnp.asarray([0.2, -0.1, 0.05, 0.0, 0.0, 0.5],
                                         jnp.float32)))
    tgt = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    out = rng.uniform(size=m) < 0.4
    tgt[out] = rng.uniform(-1, 1, (int(out.sum()), 3)).astype(np.float32)
    corr = np.arange(m, dtype=np.int32)
    key = jax.random.PRNGKey(0)
    T_j, f_j = JPCR._ransac_core(key, jnp.asarray(src), jnp.asarray(tgt),
                                 jnp.asarray(corr), jnp.asarray(corr), 0.05,
                                 n_hyp=1024)
    trip = np.asarray(jax.random.randint(key, (1024, 3), 0, m))
    T_t, f_t = TPCR._ransac_core(
        torch.as_tensor(trip, dtype=torch.long), torch.as_tensor(src),
        torch.as_tensor(tgt), torch.as_tensor(corr, dtype=torch.long),
        torch.as_tensor(corr, dtype=torch.long), 0.05)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
    assert abs(f_t - float(f_j)) < 1e-6
    np.testing.assert_allclose(T_t.numpy(), T, atol=1e-3)


def test_normals_and_fpfh_match_jax(rng):
    """kNN-PCA normals agree up to float32 rounding (|dot| > 0.999 on 99% of
    the points); FPFH rows agree (L1 distance < 0.05 on 95% of the rows: a
    neighbour at a bin edge can fall on either side)."""
    n = 500
    pts = np.concatenate([
        np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                  0.01 * rng.normal(size=n)], -1),
        np.stack([rng.uniform(0, 1, n), 0.01 * rng.normal(size=n),
                  rng.uniform(0, 1, n)], -1)]).astype(np.float32)
    nj = np.asarray(JPCR.estimate_normals(jnp.asarray(pts)))
    nt = TPCR.estimate_normals(torch.as_tensor(pts))
    assert (np.abs((nj * nt.numpy()).sum(-1)) > 0.999).mean() > 0.99
    fj = np.asarray(JPCR.fpfh(jnp.asarray(pts), jnp.asarray(nj)))
    ft = TPCR.fpfh(torch.as_tensor(pts), torch.as_tensor(nj)).numpy()
    assert (np.abs(fj - ft).sum(-1) < 0.05).mean() > 0.95


def test_robust_icp_recovers_large_rotation(rng):
    """Twin of test_lc.py::test_robust_icp_recovers_large_rotation on the
    port (its RANSAC draws from a torch.Generator): a 30 degree turn is
    recovered within 3 deg and 5 cm."""
    n = 900
    a = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                  0.02 * rng.normal(size=n)], -1)
    b = np.stack([rng.uniform(0, 1, n), 0.02 * rng.normal(size=n),
                  rng.uniform(0, 0.7, n)], -1)
    c = np.stack([0.02 * rng.normal(size=n), rng.uniform(0, 1, n),
                  rng.uniform(0, 0.7, n)], -1)
    pts = np.concatenate([a, b, c]).astype(np.float32)
    T = np.asarray(j_se3_exp(jnp.asarray([0.3, -0.2, 0.1, 0.0, 0.0,
                                          np.deg2rad(30.0)], jnp.float32)))
    Ti = np.linalg.inv(T)
    tgt = (pts @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
    res = TS.icp_registration({"xyz": pts}, {"xyz": tgt}, robust=True)
    assert res.successful
    assert _angle_deg(res.transformation[:3, :3].T @ T[:3, :3]) < 3.0
    assert np.linalg.norm(res.transformation[:3, 3] - T[:3, 3]) < 0.05
