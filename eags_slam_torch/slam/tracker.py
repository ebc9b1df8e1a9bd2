"""Render-based camera tracking (port of eags_slam_tpu.slam.tracker).

Per frame: score the candidate init poses on full-image renders, double the
iteration budget when the best candidate's loss is far above the running
medians, then refine w2c = last_w2c @ Rel(quat, trans) with amsgrad Adam,
ReduceLROnPlateau, the |delta loss| early stop, the optional stale-best stop
and best-iterate recovery. On the sorted backend the refinement renders a
frozen centre-sorted layout (`freeze_sorted`), optionally on the
top-scoring tile subset with a wider polish phase at the end (off under
`debug_per_iter`, which records every iteration; DEBUG_ITER_NAMES); with
`pose_grad_kernel` its pose gradient comes from the pose-contraction
backward (K4) instead of the K2 grads and autograd through the
reprojection. On the `pallas` backend it renders a frozen entry binning
(`freeze_binning`, K5 / K6) on the full image. On the `jnp` backend it
renders the whole map every iteration (no frozen layout, no subset). The
JAX `lax.while_loop` is a Python loop here; its carry is plain
Python/numpy scalars plus the pose tensors. With a mesh and `sp_track`,
`Tracker` scores the candidates apart
(`eval_init_candidates`) and refines over the mesh's split tile grid
(parallel/mesh.py `sp_track_refine`: the full grid, no subset, no polish,
no K4).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from ..core.se3 import quat_to_rotmat, rotmat_to_quat
from ..core.sh import sh_to_rgb
from ..ops.rasterizer import (RasterConfig, backend_of, freeze_binning,
                              freeze_sorted, gt_tiles, render, render_frozen,
                              render_frozen_sorted, render_frozen_sorted_pose,
                              render_frozen_sorted_tiles,
                              render_frozen_sorted_tiles_pose, tile_sums)
from ..utils import optim, tracing


class TrackerConfig(NamedTuple):
    iterations: int = 60
    cam_rot_lr: float = 0.002
    cam_trans_lr: float = 0.01
    exposure_lr: float = 0.01
    w_color_loss: float = 0.95
    alpha_thre: float = 0.98
    filter_alpha: bool = True
    filter_outlier_depth: bool = True
    soft_alpha: bool = True
    mask_invalid_depth: bool = False
    early_stop_thre: float = 1e-6
    early_stop_cnt: int = 10
    stale_best_cnt: int = 0
    frozen_binning: bool = True
    init_err_ratio: float = 5.0
    enable_exposure: bool = False
    plateau_patience: int = 5
    plateau_factor: float = 0.95
    pose_grad_kernel: bool = False   # pose-contraction backward (K4)
    tile_subset_frac: float = 0.25
    polish_iters: int = 0
    polish_frac: float = 1.0
    debug_per_iter: bool = False


STAT_NAMES = ("loss", "color_loss", "depth_loss", "iters", "best_iter")
TRACK_STAT_NAMES = STAT_NAMES + ("best_cand", "init_color_loss",
                                 "init_depth_loss")
# The per-iteration record of `debug_per_iter`: after iteration i, its loss
# and the best colour / depth losses so far; before it, the plateau's LR
# scale and the pose; `active` 1 for an iteration that ran.
DEBUG_ITER_NAMES = ("loss", "color_loss", "depth_loss", "lr_scale",
                    "active", "qw", "qx", "qy", "qz", "tx", "ty", "tz")


def _rel_matrix(quat: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    R = quat_to_rotmat(quat)
    top = torch.cat([R, trans[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype,
                          device=R.device)
    return torch.cat([top, bottom], dim=0)


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy/jnp median (mean of the two middle values for even counts)."""
    v = torch.sort(x.reshape(-1)).values
    n = v.numel()
    if n % 2:
        return v[n // 2]
    return 0.5 * (v[n // 2 - 1] + v[n // 2])


def _losses_from_output(out, pose: Dict[str, torch.Tensor], gt_color,
                        gt_depth, tcfg: TrackerConfig, valid=None):
    """Masked tracking losses on full images (H, W, *) or tile stacks
    (S, ts, ts, *); `valid` masks pixels outside the image."""
    image = out.color
    if tcfg.enable_exposure:
        ex = pose["exposure"]
        image = torch.clamp(torch.exp(ex[0]) * image + ex[1], 0.0, 1.0)
    depth_mask = gt_depth > 0.0
    if valid is not None:
        depth_mask = depth_mask & valid
    tracking_mask = depth_mask
    if tcfg.filter_alpha:
        tracking_mask = tracking_mask & (out.alpha > tcfg.alpha_thre)
    if tcfg.filter_outlier_depth:
        depth_err = torch.abs(out.depth - gt_depth) * depth_mask
        med = _median(depth_err[..., ::4, ::4].detach())
        tracking_mask = tracking_mask & ((depth_err < 50.0 * med)
                                         | ~(med > 0))
    color_px = torch.abs(image - gt_color) + 1e-8
    if valid is not None:
        color_px = color_px * valid[..., None]
    depth_px = (torch.abs(out.depth - gt_depth) + 1e-8) * tracking_mask
    if tcfg.soft_alpha:
        a3 = out.alpha ** 3
        color_px = color_px * a3[..., None]
        depth_px = depth_px * a3
        if tcfg.mask_invalid_depth:
            color_px = color_px * tracking_mask[..., None]
    else:
        color_px = color_px * tracking_mask[..., None]
    n_color = (color_px > 0).sum()
    n_depth = (depth_px > 0).sum()
    inf = torch.tensor(float("inf"), device=color_px.device)
    color_loss = torch.where(n_color > 0, color_px.sum()
                             / torch.clamp(n_color, min=1), inf)
    depth_loss = torch.where(n_depth > 0, depth_px.sum()
                             / torch.clamp(n_depth, min=1), inf)
    return color_loss, depth_loss


def _make_loss_fn(params: GaussianParams, alive, colors, init_rel, last_w2c,
                  gt_color, gt_depth, cam: Camera, rcfg: RasterConfig,
                  tcfg: TrackerConfig, subset=None):
    """Refinement loss over the frozen layout of the backend: the
    centre-sorted one (tile subset when `subset` = (tile_ids, gt_c_tiles,
    gt_d_tiles, in_img) is given) or the entry binning; the full render
    every iteration with `frozen_binning` off or on the `jnp` backend."""
    w = tcfg.w_color_loss
    if not tcfg.frozen_binning or backend_of(rcfg) == "jnp":
        def loss_full(pose):
            out = render(params.xyz, params.quats, params.log_scales,
                         params.opacity_logits, colors,
                         last_w2c @ _rel_matrix(pose["quat"], pose["trans"]),
                         cam, rcfg, alive=alive)
            cl, dl = _losses_from_output(out, pose, gt_color, gt_depth, tcfg)
            return w * cl + (1 - w) * dl, (cl, dl)
        return loss_full
    if backend_of(rcfg) == "pallas":
        fb = freeze_binning(params.xyz, params.quats, params.log_scales,
                            params.opacity_logits, colors,
                            last_w2c @ init_rel, cam, rcfg, alive=alive)

        def loss_frozen(pose):
            out = render_frozen(
                fb, last_w2c @ _rel_matrix(pose["quat"], pose["trans"]), cam,
                rcfg)
            cl, dl = _losses_from_output(out, pose, gt_color, gt_depth, tcfg)
            return w * cl + (1 - w) * dl, (cl, dl)
        return loss_frozen
    fs = freeze_sorted(params.xyz, params.quats, params.log_scales,
                       params.opacity_logits, colors, last_w2c @ init_rel,
                       cam, rcfg, alive=alive)
    if subset is not None:
        tile_ids, gt_c_t, gt_d_t, in_img = subset

        def render_fn(pose):
            if tcfg.pose_grad_kernel:
                return render_frozen_sorted_tiles_pose(
                    fs, torch.cat([pose["quat"], pose["trans"]]), last_w2c,
                    tile_ids, cam, rcfg)
            return render_frozen_sorted_tiles(
                fs, last_w2c @ _rel_matrix(pose["quat"], pose["trans"]),
                tile_ids, cam, rcfg)

        def loss_fn(pose):
            cl, dl = _losses_from_output(render_fn(pose), pose, gt_c_t,
                                         gt_d_t, tcfg, valid=in_img)
            return w * cl + (1 - w) * dl, (cl, dl)
    else:
        def render_fn(pose):
            if tcfg.pose_grad_kernel:
                return render_frozen_sorted_pose(
                    fs, torch.cat([pose["quat"], pose["trans"]]), last_w2c,
                    cam, rcfg)
            return render_frozen_sorted(
                fs, last_w2c @ _rel_matrix(pose["quat"], pose["trans"]),
                cam, rcfg)

        def loss_fn(pose):
            cl, dl = _losses_from_output(render_fn(pose), pose, gt_color,
                                         gt_depth, tcfg)
            return w * cl + (1 - w) * dl, (cl, dl)
    return loss_fn


def _refine(loss_fn, init_rel, num_iters: int, exposure0,
            tcfg: TrackerConfig, warm=None, record=None):
    """Pose refinement loop; returns (rel_best 4x4, exposure, stats (5,)
    np.float32 of STAT_NAMES, (adam, plateau)). `warm` = (adam, plateau)
    continues a previous phase's optimizer state. `record`: an (I, 12)
    array whose row `it` gets iteration it's DEBUG_ITER_NAMES values."""
    f32 = np.float32
    q0 = rotmat_to_quat(init_rel[:3, :3])
    pose = {"quat": q0, "trans": init_rel[:3, 3].clone(),
            "exposure": exposure0.clone()}
    adam = optim.adam_init(pose) if warm is None else warm[0]
    plateau = optim.plateau_init() if warm is None else warm[1]
    it, break_cnt, done = 0, 0, False
    prev_loss = f32(np.inf)
    best_loss, best_cl, best_dl, best_it = (f32(np.inf), f32(np.inf),
                                            f32(np.inf), 0)
    best_pose = {k: v.detach().clone() for k, v in pose.items()}
    while it < num_iters and not done:
        with tracing.span("track.iter"):
            leaf = {k: v.detach().requires_grad_(True)
                    for k, v in pose.items()}
            total, (cl, dl) = loss_fn(leaf)
            gq, gt, ge = torch.autograd.grad(
                total, [leaf["quat"], leaf["trans"], leaf["exposure"]],
                allow_unused=True)
            grads = {"quat": gq, "trans": gt,
                     "exposure": ge if ge is not None
                     else torch.zeros_like(leaf["exposure"])}
            with tracing.span("track.readback"):
                vals = torch.stack([total.detach(), cl.detach(),
                                    dl.detach()]).cpu()
            total_f, cl_f, dl_f = (f32(v) for v in vals.numpy())

            with np.errstate(invalid="ignore"):   # inf - inf: not flat
                flat = abs(f32(total_f - prev_loss)) < tcfg.early_stop_thre
            break_cnt = break_cnt + 1 if flat else 0
            done = break_cnt > tcfg.early_stop_cnt
            if tcfg.stale_best_cnt > 0:
                done = done or (it - best_it > tcfg.stale_best_cnt)
            lr = plateau.lr_scale
            lr_tree = {"quat": tcfg.cam_rot_lr * lr,
                       "trans": tcfg.cam_trans_lr * lr,
                       "exposure": tcfg.exposure_lr * lr}
            old = {k: v.detach() for k, v in leaf.items()}
            new_pose, adam = optim.adam_update(adam, old, grads, lr_tree,
                                               amsgrad=True)
            new_pose["quat"] = new_pose["quat"] / torch.clamp(
                torch.linalg.norm(new_pose["quat"]), min=1e-12)
            plateau = optim.plateau_update(plateau, total_f,
                                           tcfg.plateau_patience,
                                           tcfg.plateau_factor)
            if total_f < best_loss:
                best_pose = old
                best_cl, best_dl, best_it = cl_f, dl_f, it
            if record is not None:
                record[it, :5] = (total_f, best_cl, best_dl, lr, 1.0)
                record[it, 5:9] = old["quat"].cpu().numpy()
                record[it, 9:] = old["trans"].cpu().numpy()
            best_loss = min(total_f, best_loss)
            prev_loss = total_f
            pose = new_pose
            it += 1
    rel = _rel_matrix(best_pose["quat"], best_pose["trans"])
    stats = np.array([best_loss, best_cl, best_dl, it, best_it], np.float32)
    return rel, best_pose["exposure"], stats, (adam, plateau)


def refine_pose(params: GaussianParams, alive, init_rel, last_w2c, gt_color,
                gt_depth, num_iters: int, exposure0, cam: Camera,
                rcfg: RasterConfig, tcfg: TrackerConfig):
    """Optimise the relative pose on the full image; returns (rel_best
    4x4, exposure (2,), stats (5,) np.float32 of STAT_NAMES). Loop
    closure's viewpoint localisation runs it with `frozen_binning` off,
    which re-bins at every step."""
    colors = sh_to_rgb(params.f_dc)
    loss_fn = _make_loss_fn(params, alive, colors, init_rel, last_w2c,
                            gt_color, gt_depth, cam, rcfg, tcfg)
    rel, exposure, stats, _ = _refine(loss_fn, init_rel, int(num_iters),
                                      exposure0, tcfg)
    return rel, exposure, stats


def _stable_topk(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values, ties to the lower index (the
    lax.top_k order)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def _select_tiles(gt_color, gt_depth, alpha, cam: Camera, ts: int,
                  tiles_x: int, tiles_y: int, s: int):
    """Top-`s` tiles by alpha^3-weighted image + capped depth gradient
    energy plus a small valid-depth bonus."""
    gray = gt_color.mean(-1)
    gx = torch.diff(gray, dim=1, append=gray[:, -1:])
    gy = torch.diff(gray, dim=0, append=gray[-1:, :])
    dgx = torch.diff(gt_depth, dim=1, append=gt_depth[:, -1:])
    dgy = torch.diff(gt_depth, dim=0, append=gt_depth[-1:, :])
    energy = gx * gx + gy * gy + 0.01 * torch.clamp(dgx * dgx + dgy * dgy,
                                                    max=1.0)
    energy = energy * torch.clamp(alpha, 0.0, 1.0) ** 3
    valid = (gt_depth > 0).to(torch.float32)
    score = (tile_sums(energy * valid, ts, tiles_x, tiles_y)
             + 1e-4 * tile_sums(valid, ts, tiles_x, tiles_y))
    return _stable_topk(score, s).to(torch.int32)


def _in_image_mask(tile_ids, ts: int, tiles_x: int, cam: Camera):
    tid = tile_ids.long()
    tx0 = (tid % tiles_x) * ts
    ty0 = (tid // tiles_x) * ts
    r = torch.arange(ts, device=tile_ids.device)
    uu = tx0[:, None, None] + r[None, None, :]
    vv = ty0[:, None, None] + r[None, :, None]
    return (uu < cam.width) & (vv < cam.height)


def _subset(gt_color, gt_depth, alpha, cam, ts, tiles_x, tiles_y, s):
    tile_ids = _select_tiles(gt_color, gt_depth, alpha, cam, ts, tiles_x,
                             tiles_y, s)
    return (tile_ids, gt_tiles(gt_color, tile_ids, ts, tiles_x, tiles_y),
            gt_tiles(gt_depth, tile_ids, ts, tiles_x, tiles_y),
            _in_image_mask(tile_ids, ts, tiles_x, cam))


def eval_init_candidates(params: GaussianParams, alive, rel_mats, last_w2c,
                         gt_color, gt_depth, cam: Camera, rcfg: RasterConfig,
                         tcfg: TrackerConfig):
    """Score the candidate relative poses on full-image renders: returns
    ((C, 3) np.float32 rows of (total, colour, depth) loss, the C alpha
    maps)."""
    colors = sh_to_rgb(params.f_dc)
    w = tcfg.w_color_loss
    cand, alphas = [], []
    with torch.no_grad(), tracing.span("track.candidates"):
        for rel in rel_mats:
            q = rotmat_to_quat(rel[:3, :3])
            pose = {"quat": q, "trans": rel[:3, 3],
                    "exposure": torch.zeros(2, device=rel.device)}
            out = render(params.xyz, params.quats, params.log_scales,
                         params.opacity_logits, colors,
                         last_w2c @ _rel_matrix(q, rel[:3, 3]), cam, rcfg,
                         alive=alive)
            cl, dl = _losses_from_output(out, pose, gt_color, gt_depth, tcfg)
            cand.append(torch.stack([w * cl + (1 - w) * dl, cl, dl]))
            alphas.append(out.alpha)
        cand = torch.stack(cand).cpu().numpy().astype(np.float32)
    return cand, alphas


def track_frame(params: GaussianParams, alive, rel_mats, last_w2c, gt_color,
                gt_depth, med_cl: float, med_dl: float, exposure0,
                cam: Camera, rcfg: RasterConfig, tcfg: TrackerConfig):
    """Candidate scoring (full-image renders), iteration doubling, then the
    refinement (tile subset + polish when configured, sorted backend only).
    Returns (rel 4x4, exposure (2,), stats np.float32 of TRACK_STAT_NAMES,
    per_iter): with `debug_per_iter`, per_iter is the (2 x iterations, 12)
    float32 record of DEBUG_ITER_NAMES (rows past the last iteration zero,
    `active` 0) and the polish phase is off; else None."""
    colors = sh_to_rgb(params.f_dc)
    cand, alphas = eval_init_candidates(params, alive, rel_mats, last_w2c,
                                        gt_color, gt_depth, cam, rcfg, tcfg)
    best = int(np.argmin(cand[:, 0]))
    init_rel = rel_mats[best]
    init_cl, init_dl = cand[best, 1], cand[best, 2]
    double = (init_cl > np.float32(tcfg.init_err_ratio * med_cl)) or (
        init_dl > np.float32(tcfg.init_err_ratio * med_dl))
    num_iters = 2 * tcfg.iterations if double else tcfg.iterations

    ts = rcfg.tile
    tiles_x = -(-cam.width // ts)
    tiles_y = -(-cam.height // ts)
    num_tiles = tiles_x * tiles_y
    s = int(round(tcfg.tile_subset_frac * num_tiles))
    subset = None
    if (0 < s < num_tiles and backend_of(rcfg) == "sorted"
            and tcfg.frozen_binning):
        subset = _subset(gt_color, gt_depth, alphas[best], cam, ts, tiles_x,
                         tiles_y, s)
    loss_fn = _make_loss_fn(params, alive, colors, init_rel, last_w2c,
                            gt_color, gt_depth, cam, rcfg, tcfg,
                            subset=subset)
    per_iter = None
    if tcfg.debug_per_iter:
        per_iter = np.zeros((2 * tcfg.iterations, len(DEBUG_ITER_NAMES)),
                            np.float32)
    polish = int(tcfg.polish_iters)
    if subset is not None and polish > 0 and per_iter is None:
        n1 = max(num_iters - polish, 0)
        rel1, exp1, stats1, opt_state = _refine(loss_fn, init_rel, n1,
                                                exposure0, tcfg)
        s2 = int(round(tcfg.polish_frac * num_tiles))
        subset2 = None
        if 0 < s2 < num_tiles:
            subset2 = _subset(gt_color, gt_depth, alphas[best], cam, ts,
                              tiles_x, tiles_y, s2)
        loss_wide = _make_loss_fn(params, alive, colors, init_rel, last_w2c,
                                  gt_color, gt_depth, cam, rcfg, tcfg,
                                  subset=subset2)
        n2 = min(polish, num_iters)
        rel, exposure, stats, _ = _refine(loss_wide, rel1, n2, exp1, tcfg,
                                          warm=opt_state)
        stats = np.array([stats[0], stats[1], stats[2],
                          stats1[3] + stats[3], stats1[3] + stats[4]],
                         np.float32)
    else:
        rel, exposure, stats, _ = _refine(loss_fn, init_rel, num_iters,
                                          exposure0, tcfg, record=per_iter)
    stats = np.concatenate([stats, np.array([best, init_cl, init_dl],
                                            np.float32)])
    return rel, exposure, stats, per_iter


class Tracker:
    """Host-side per-frame tracking flow: candidates, adaptive iteration
    count, refinement, loss history for the doubling heuristic. With a
    `mesh` and `sp_track`, the refinement runs tile-split over the mesh
    (parallel/mesh.py `sp_track_refine`): the candidates are scored apart
    from it (`eval_init_candidates`, the mesh's first rank's scores and
    poses broadcast to every rank), the iteration count doubled on the host,
    and the per-iteration records of `debug_per_iter` are dropped."""

    def __init__(self, tcfg: TrackerConfig, rcfg: RasterConfig, cam: Camera,
                 mesh=None, sp_track: bool = False):
        self.tcfg = tcfg
        self.rcfg = rcfg
        self.cam = cam
        self.mesh = mesh
        self.frame_color_loss = []
        self.frame_depth_loss = []
        self.init_pose_cnt = {"const_speed": 0, "previous": 0, "odometer": 0}
        self.iter_cnt = []
        self.last_per_iter = None   # the last frame's record (debug_per_iter)
        self._sp_refine = None
        if mesh is not None and sp_track:
            from ..parallel.mesh import sp_track_refine

            if tcfg.debug_per_iter:
                import warnings

                warnings.warn("sp_track drops debug_per_iter records "
                              "(per-iteration diagnostics stay on the "
                              "single-device path)")
            self._sp_refine, _ = sp_track_refine(mesh, cam, rcfg, tcfg)

    def _track_sp(self, params, alive, rels, last_w2c, gt_color, gt_depth,
                  med_cl: float, med_dl: float, exp0):
        from ..parallel.mesh import broadcast_tensors

        cand, _ = eval_init_candidates(params, alive, rels, last_w2c,
                                       gt_color, gt_depth, self.cam,
                                       self.rcfg, self.tcfg)
        cand, rels = broadcast_tensors(
            self.mesh, [torch.as_tensor(cand, device=rels.device), rels])
        cand = cand.cpu().numpy()
        best = int(np.argmin(cand[:, 0]))
        double = (cand[best, 1] > self.tcfg.init_err_ratio * med_cl
                  or cand[best, 2] > self.tcfg.init_err_ratio * med_dl)
        num_iters = (2 if double else 1) * self.tcfg.iterations
        rel, exposure, stats = self._sp_refine(
            params, alive, rels[best], last_w2c, gt_color, gt_depth, exp0,
            num_iters)
        stats = np.concatenate([stats, np.array(
            [best, cand[best, 1], cand[best, 2]], np.float32)])
        return rel, exposure, stats, None

    def track(self, params, alive, last_c2w, init_candidates: dict,
              gt_color, gt_depth, exposure0=None):
        """Returns (c2w (4, 4) float64, exposure (2,), stats dict)."""
        dev = gt_color.device
        last_w2c = np.linalg.inv(np.asarray(last_c2w, np.float64))
        names = list(init_candidates.keys())
        rels = np.stack([np.linalg.inv(np.asarray(c2w, np.float64) @ last_w2c)
                         for c2w in init_candidates.values()]
                        ).astype(np.float32)
        med_cl = (np.median(self.frame_color_loss)
                  if self.frame_color_loss else np.inf)
        med_dl = (np.median(self.frame_depth_loss)
                  if self.frame_depth_loss else np.inf)
        exp0 = (torch.zeros(2, device=dev) if exposure0 is None
                else torch.as_tensor(exposure0, dtype=torch.float32,
                                     device=dev))
        args = (params, alive, torch.as_tensor(rels, device=dev),
                torch.as_tensor(last_w2c, dtype=torch.float32, device=dev),
                gt_color, gt_depth, float(med_cl), float(med_dl), exp0)
        if self._sp_refine is not None:
            rel, exposure, stats_vec, self.last_per_iter = \
                self._track_sp(*args)
        else:
            rel, exposure, stats_vec, self.last_per_iter = track_frame(
                *args, self.cam, self.rcfg, self.tcfg)
        rel = rel.detach().cpu().numpy()
        exposure = exposure.detach().cpu().numpy()
        stats = dict(zip(TRACK_STAT_NAMES, (float(v) for v in stats_vec)))
        best = int(stats.pop("best_cand"))
        self.init_pose_cnt[names[best]] = \
            self.init_pose_cnt.get(names[best], 0) + 1
        self.frame_color_loss.append(stats["color_loss"])
        self.frame_depth_loss.append(stats["depth_loss"])
        self.iter_cnt.append(int(stats["iters"]))
        tracing.count("track.iters", self.iter_cnt[-1])
        w2c = last_w2c @ np.asarray(rel, np.float64)
        c2w = np.linalg.inv(w2c)
        c2w[3] = [0.0, 0.0, 0.0, 1.0]
        return c2w, exposure, stats

    def report(self) -> dict:
        return {"init_pose_cnt": dict(self.init_pose_cnt),
                "iters_avg": float(np.mean(self.iter_cnt))
                if self.iter_cnt else 0.0}
