"""Tracker parity: the port's `track_frame` against the JAX one (sorted
backend, Pallas interpret mode) on the same map, frame and candidates, at
the scene of tests/test_tracker.py (48x40, tile 16, seg_cap 256)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.core.gaussians import GaussianParams as JParams
from eags_slam_tpu.core.se3 import se3_exp as j_se3_exp
from eags_slam_tpu.core.sh import sh_to_rgb as j_sh_to_rgb
from eags_slam_tpu.ops.rasterizer import RasterConfig as JRaster
from eags_slam_tpu.ops.rasterizer import render as j_render
from eags_slam_tpu.slam import tracker as JT
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.core.gaussians import GaussianParams
from eags_slam_torch.core.se3 import se3_exp
from eags_slam_torch.lc import solver
from eags_slam_torch.ops import rasterizer as R
from eags_slam_torch.ops.rasterizer import RasterConfig
from eags_slam_torch.parallel import mesh
from eags_slam_torch.slam import tracker as T
from eags_slam_torch.utils import tracing

CAM = Camera(fx=60.0, fy=60.0, cx=23.5, cy=19.5, width=48, height=40)
JCAM = JCamera(*CAM)
JRCFG = JRaster(tile=16, dup_side=4, chunk=16, backend="sorted", seg_cap=256,
                bands=3, group=3)
RCFG = RasterConfig(tile=16, dup_side=4, seg_cap=256, bands=3)


def _scene(n=300, seed=0):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                      rng.uniform(1.5, 3.5, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    return {"xyz": means, "f_dc": ((rgb - 0.5) / 0.28209479177387814).astype(
        np.float32), "f_rest": np.zeros((n, 15, 3), np.float32),
        "log_scales": np.log(rng.uniform(0.05, 0.15, (n, 3))).astype(
            np.float32),
        "quats": q,
        "opacity_logits": rng.uniform(1, 5, (n, 1)).astype(np.float32)}


def _rel_errors(rel):
    t = np.linalg.norm(rel[:3, 3])
    r = np.degrees(np.arccos(np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1)))
    return t, r


@pytest.mark.parametrize("variant", ["subset_polish", "full_image",
                                     "exposure_stale"])
def test_track_frame_matches_jax(variant):
    """Same candidates (far / near perturbations of the true pose), same
    frame rendered by the JAX sorted renderer. Tolerance: the refined
    relative poses agree within 1 mm and 0.05 deg (float32 losses and
    gradients in another summation order through 20-odd Adam steps); the
    candidate choice, iteration counts and initial losses agree."""
    d = _scene()
    jp = JParams(**{k: jnp.asarray(v) for k, v in d.items()})
    alive = np.ones(d["xyz"].shape[0], bool)
    out = j_render(jp.xyz, jp.quats, jp.log_scales, jp.opacity_logits,
                   j_sh_to_rgb(jp.f_dc), jnp.eye(4), JCAM, JRCFG,
                   alive=jnp.asarray(alive))
    gt_color = np.asarray(out.color)
    gt_depth = np.asarray(jnp.where(
        out.alpha > 0.5, out.depth / jnp.maximum(out.alpha, 1e-6), 0.0))
    tau_near = np.array([0.01, -0.008, 0.006, 0.006, -0.008, 0.005],
                        np.float32)
    tau_far = np.array([0.15, 0.1, 0.0, 0.08, 0.0, 0.0], np.float32)
    rels = np.stack([np.asarray(j_se3_exp(jnp.asarray(tau_far))),
                     np.asarray(j_se3_exp(jnp.asarray(tau_near)))]
                    ).astype(np.float32)
    if variant == "subset_polish":
        kw = dict(iterations=20, tile_subset_frac=0.6, polish_iters=6,
                  polish_frac=0.9)
    elif variant == "full_image":
        kw = dict(iterations=16, tile_subset_frac=0.0, stale_best_cnt=10)
    else:   # the chip smoke's tracker: exposure on, stale-best stop
        kw = dict(iterations=20, tile_subset_frac=0.6, polish_iters=6,
                  polish_frac=0.9, enable_exposure=True, stale_best_cnt=15)
    common = dict(alpha_thre=0.5, early_stop_cnt=60, **kw)
    jt = JT.TrackerConfig(**common)
    tt = T.TrackerConfig(**common)

    j_rel, j_exp, j_stats, _ = JT.track_frame(
        jp, jnp.asarray(alive), jnp.asarray(rels), jnp.eye(4),
        jnp.asarray(gt_color), jnp.asarray(gt_depth), jnp.float32(np.inf),
        jnp.float32(np.inf), jnp.zeros(2), JCAM, JRCFG, jt)
    tp = GaussianParams(**{k: torch.as_tensor(v) for k, v in d.items()})
    t_rel, t_exp, t_stats, _ = T.track_frame(
        tp, torch.as_tensor(alive), torch.as_tensor(rels), torch.eye(4),
        torch.as_tensor(gt_color), torch.as_tensor(gt_depth), np.inf, np.inf,
        torch.zeros(2), CAM, RCFG, tt)
    j_rel, t_rel = np.asarray(j_rel), t_rel.numpy()
    j_stats = np.asarray(j_stats)
    # candidate, iteration counts exact; initial losses float32-close.
    assert int(t_stats[5]) == int(j_stats[5]) == 1
    np.testing.assert_array_equal(t_stats[3:5], j_stats[3:5])
    np.testing.assert_allclose(t_stats[6:8], j_stats[6:8], rtol=1e-4)
    np.testing.assert_allclose(t_stats[0:3], j_stats[0:3], rtol=1e-3)
    dt, dr = _rel_errors(np.linalg.inv(j_rel.astype(np.float64)) @ t_rel)
    assert dt < 1e-3 and dr < 0.05, (dt, dr)
    # Exposure (a, b): same Adam path, 1e-4 absolute.
    np.testing.assert_allclose(t_exp.numpy(), np.asarray(j_exp), atol=1e-4)
    # ...and the short refinement moved the pose towards the truth.
    t_err, _ = _rel_errors(t_rel)
    assert t_err < 0.85 * np.linalg.norm(rels[1][:3, 3])


def test_tracker_host_flow_matches_jax():
    """Tracker.track: candidates from c2w poses, GT-free loss history and
    the returned c2w, on the same map and frame."""
    d = _scene(seed=1)
    jp = JParams(**{k: jnp.asarray(v) for k, v in d.items()})
    alive = np.ones(d["xyz"].shape[0], bool)
    out = j_render(jp.xyz, jp.quats, jp.log_scales, jp.opacity_logits,
                   j_sh_to_rgb(jp.f_dc), jnp.eye(4), JCAM, JRCFG,
                   alive=jnp.asarray(alive))
    gt_color = np.asarray(out.color)
    gt_depth = np.asarray(jnp.where(
        out.alpha > 0.5, out.depth / jnp.maximum(out.alpha, 1e-6), 0.0))
    last = np.linalg.inv(np.asarray(
        se3_exp(torch.tensor([0.004, 0.0, -0.003, 0.0, 0.004, 0.0])),
        np.float64))
    cands = {"const_speed": np.eye(4), "previous": last}
    common = dict(iterations=8, alpha_thre=0.5, tile_subset_frac=0.0)
    jtr = JT.Tracker(JT.TrackerConfig(**common), JRCFG, JCAM)
    ttr = T.Tracker(T.TrackerConfig(**common), RCFG, CAM)
    j_c2w, _, j_st = jtr.track(jp, jnp.asarray(alive), last, cands,
                               jnp.asarray(gt_color), jnp.asarray(gt_depth))
    tp = GaussianParams(**{k: torch.as_tensor(v) for k, v in d.items()})
    t_c2w, _, t_st = ttr.track(tp, torch.as_tensor(alive), last, cands,
                               torch.as_tensor(gt_color),
                               torch.as_tensor(gt_depth))
    assert jtr.init_pose_cnt == ttr.init_pose_cnt
    assert t_st["iters"] == j_st["iters"]
    assert np.linalg.norm(t_c2w[:3, 3] - j_c2w[:3, 3]) < 1e-3



def _toy_loss(*args, **kw):
    """A stand-in for `_make_loss_fn`: a smooth loss of the pose alone, so
    that the refine loop runs without the compositor's CPU twin."""
    def loss_fn(pose):
        q = pose["quat"] - torch.tensor([1.0, 0.02, -0.01, 0.0])
        t = pose["trans"] - torch.tensor([0.01, -0.02, 0.03])
        cl = (q * q).sum() + (t * t).sum() + 0.1 * (pose["exposure"] ** 2
                                                    ).sum()
        dl = 0.5 * (t * t).sum()
        return 0.9 * cl + 0.1 * dl, (cl, dl)
    return loss_fn


def test_graph_runner_stays_off_the_eager_paths(monkeypatch):
    """The CPU device, `debug_per_iter`, the loop closer's localisation and
    `sp_track` keep the eager refine loop: no graph runner reaches
    `_refine`, `track.graph_captures` reads 0, and `Tracker.track` returns
    what `track_frame`'s eager loop returns (the loss a stand-in, the
    candidates' scores fixed: the routing is under test here)."""
    graphs = []
    refine = T._refine

    def spy(*args, graph=None, **kw):
        graphs.append(graph)
        return refine(*args, graph=graph, **kw)

    def candidates(params, alive, rels, *args):
        return (np.ones((len(rels), 3), np.float32),
                [torch.ones(CAM.height, CAM.width)] * len(rels))

    for mod in (T, solver):
        monkeypatch.setattr(mod, "_refine", spy)
        monkeypatch.setattr(mod, "_make_loss_fn", _toy_loss)
    monkeypatch.setattr(T, "eval_init_candidates", candidates)
    monkeypatch.setattr(mesh, "broadcast_tensors", lambda m, ts: ts)
    # On a card as well, these settings keep the eager loop.
    for tkw, rkw in (({"debug_per_iter": True}, {}),
                     ({"frozen_binning": False}, {}),
                     ({}, {"backend": "pallas"}), ({}, {"backend": "jnp"})):
        tr = T.Tracker(T.TrackerConfig(**tkw), RCFG._replace(**rkw), CAM)
        assert tr._refine_graph(torch.device("cuda")) is None

    tp = GaussianParams(**{k: torch.as_tensor(v)
                           for k, v in _scene(n=8).items()})
    alive = torch.ones(8, dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    gt = (torch.rand(CAM.height, CAM.width, 3, generator=gen),
          torch.rand(CAM.height, CAM.width, generator=gen) + 1.0)
    rel = torch.eye(4)
    rel[:3, 3] = torch.tensor([0.004, 0.0, -0.003])
    cands = {"previous": np.linalg.inv(rel.double().numpy())}
    tracing.disable()
    tracing.drain()
    try:
        tracing.enable()
        for f, tkw in enumerate(({"polish_iters": 2},
                                 {"debug_per_iter": True})):
            tcfg = T.TrackerConfig(iterations=6, tile_subset_frac=0.5, **tkw)
            with tracing.frame(f):
                c2w, _, stats = T.Tracker(tcfg, RCFG, CAM).track(
                    tp, alive, np.eye(4), cands, *gt)
            e_rel, _, e_stats, _ = T.track_frame(
                tp, alive, rel[None].float(), torch.eye(4), *gt, np.inf,
                np.inf, torch.zeros(2), CAM, RCFG, tcfg)
            want = np.linalg.inv(e_rel.numpy().astype(np.float64))
            want[3] = [0.0, 0.0, 0.0, 1.0]
            np.testing.assert_array_equal(c2w, want)
            assert stats["iters"] == e_stats[3] == 6
        # sp_track: the mesh's split refinement, never the runner.
        sp = T.Tracker(T.TrackerConfig(iterations=3), RCFG, CAM)
        sp._sp_refine = lambda *a: (torch.eye(4), torch.zeros(2),
                                    np.zeros(5, np.float32))
        monkeypatch.setattr(sp, "_refine_graph", None)
        with tracing.frame(2):
            sp.track(tp, alive, np.eye(4), cands, *gt)
        # The loop closer's localisations.
        solver._localize_batch(tp, alive, [torch.eye(4)], [gt[0]], [gt[1]],
                               4, 1, CAM, RCFG)
        counters = tracing.drain()["counters"]
    finally:
        tracing.disable()
    assert len(graphs) == 7 and not any(graphs)
    captures = [c["n"] for c in counters
                if c["name"] == "track.graph_captures"]
    assert len(captures) == 3 and sum(captures) == 0


@pytest.mark.parametrize("tiles, k4", [(True, False), (False, True)],
                         ids=["subset_k2", "full_k4"])
def test_frozen_sorted_loss_in_steps_is_autograds(tiles, k4):
    """`_frozen_sorted_loss`, its kernel calls made as they come, returns
    the loss of `render_frozen_sorted(_tiles)(_pose)` and autograd's
    gradient through it bit for bit (the CPU twins; seg_cap 64 keeps them
    fast)."""
    rcfg = RCFG._replace(dup_side=3, seg_cap=64)
    p = {k: torch.as_tensor(v) for k, v in _scene(n=60, seed=3).items()}
    colors = 0.28209479177387814 * p["f_dc"] + 0.5
    fs = R.freeze_sorted(p["xyz"], p["quats"], p["log_scales"],
                         p["opacity_logits"], colors, torch.eye(4), CAM, rcfg)
    tcfg = T.TrackerConfig(enable_exposure=True, pose_grad_kernel=k4)
    gen = torch.Generator().manual_seed(1)
    gt = (torch.rand(CAM.height, CAM.width, 3, generator=gen),
          torch.rand(CAM.height, CAM.width, generator=gen) + 2.0)
    ids = None
    if tiles:
        ids = torch.tensor([0, 2, 4, 5], dtype=torch.int32)
        gt = tuple(R.gt_tiles(g, ids, 16, 3, 3) for g in gt)
    pose = {"quat": torch.tensor([0.999, 0.01, -0.02, 0.005]),
            "trans": torch.tensor([0.01, -0.02, 0.03]),
            "exposure": torch.tensor([0.05, -0.01])}

    leaf = {k: v.clone().requires_grad_(True) for k, v in pose.items()}
    if k4:
        vec = torch.cat([leaf["quat"], leaf["trans"]])
        out = (R.render_frozen_sorted_tiles_pose(fs, vec, torch.eye(4), ids,
                                                 CAM, rcfg) if tiles else
               R.render_frozen_sorted_pose(fs, vec, torch.eye(4), CAM, rcfg))
    else:
        w2c = R.small_matmul(torch.eye(4),
                             T._rel_matrix(leaf["quat"], leaf["trans"]))
        out = (R.render_frozen_sorted_tiles(fs, w2c, ids, CAM, rcfg) if tiles
               else R.render_frozen_sorted(fs, w2c, CAM, rcfg))
    cl, dl = T._losses_from_output(out, leaf, *gt, tcfg)
    total = tcfg.w_color_loss * cl + (1 - tcfg.w_color_loss) * dl
    want = torch.cat(torch.autograd.grad(total, [leaf[k] for k in T.LEAVES]))

    steps = T._frozen_sorted_loss(fs, torch.eye(4), ids, *gt, None, CAM,
                                  rcfg, tcfg)(
        {k: v.clone().requires_grad_(True) for k, v in pose.items()})
    calls = []
    try:
        call = next(steps)
        while True:
            calls.append(call[0].__name__)
            call = steps.send(call[0](*call[1]))
    except StopIteration as stop:
        got_total, got_cl, got_dl, got = stop.value
    assert calls == ["frozen_fwd", "frozen_pose_grad" if k4 else "frozen_bwd"]
    assert torch.equal(got_total.detach(), total.detach())
    assert torch.equal(got_cl.detach(), cl.detach())
    assert torch.equal(got_dl.detach(), dl.detach())
    assert torch.equal(got, want), (got - want).abs().max()
