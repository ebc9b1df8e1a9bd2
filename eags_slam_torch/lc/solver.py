"""Submap-to-submap registration (port of eags_slam_tpu.lc.solver).

`gaussian_registration` (the reference's gs_reg): an overlap gate on the
gaussian centres, the top-2 keyframe views per side by descriptor
cross-similarity, a viewpoint localisation of each view against the other
submap's map (render + pose-gradient descent), and the residual-weighted
fusion of the per-view corrections with `rotation_average`. The pose
gradient goes through the shared rasterizer (K1 / K2 on the card).
`icp_registration` is point-to-point ICP on the centres, with the FPFH +
RANSAC global initialisation of `lc/pcr.py` when `robust`.

Each submap is rendered from a seeded subsample of at most `capacity`
gaussians (the same numpy draw as the JAX package's `_pad_params`).
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from ..core.se3 import rotation_average
from ..core.sh import sh_to_rgb
from ..ops import knn
from ..ops.rasterizer import RasterConfig, backend_of, gt_tiles, render
from ..slam.tracker import (TrackerConfig, _in_image_mask, _make_loss_fn,
                            _refine, _select_tiles, refine_pose)


class RegistrationResult(NamedTuple):
    successful: bool
    # Correction C: corrected_world_pose_of_target = C @ current_world_pose.
    transformation: np.ndarray   # (4, 4)
    fitness: float
    overlap: float
    # 6x6 information of the estimate; None -> the caller substitutes an
    # isotropic one from the fitness.
    information: Optional[np.ndarray] = None


def information_matrix(points_src: np.ndarray, points_tgt: np.ndarray,
                       max_corr: float, device="cpu") -> np.ndarray:
    """Open3D-style 6x6 information from nearest-neighbour correspondences:
    sum over matched source points p of A_p^T A_p, A_p = [I3 | -skew(p)]
    (o3d get_information_matrix_from_point_clouds)."""
    dev = torch.device(device)
    p_src = torch.as_tensor(points_src, dtype=torch.float32, device=dev)
    p_tgt = torch.as_tensor(points_tgt, dtype=torch.float32, device=dev)
    d2, _ = knn.nearest_neighbor(
        p_src, torch.ones(p_src.shape[0], dtype=torch.bool, device=dev),
        p_tgt, torch.ones(p_tgt.shape[0], dtype=torch.bool, device=dev))
    m = (d2 < max_corr * max_corr).cpu().numpy()
    p = np.asarray(points_src)[m]
    if p.shape[0] == 0:
        return np.eye(6)
    n = p.shape[0]
    ps = p.sum(axis=0)
    sk = np.array([[0.0, -ps[2], ps[1]],
                   [ps[2], 0.0, -ps[0]],
                   [-ps[1], ps[0], 0.0]])
    info = np.zeros((6, 6))
    info[:3, :3] = n * np.eye(3)
    info[:3, 3:] = -sk
    info[3:, :3] = -sk.T
    info[3:, 3:] = float((p * p).sum()) * np.eye(3) - p.T @ p
    return info


def subsample_params(g: Dict[str, np.ndarray], capacity: int, device):
    """Packed world-frame gaussians -> (GaussianParams, alive) on `device`,
    a seeded subsample of `capacity` rows when there are more."""
    n = g["xyz"].shape[0]
    if n > capacity:
        idx = np.random.default_rng(0).choice(n, capacity, replace=False)
        g = {k: (v[idx] if v.shape[0] == n else v) for k, v in g.items()}
        n = capacity

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    f_rest = g.get("f_rest")
    params = GaussianParams(
        xyz=dev(g["xyz"]), f_dc=dev(g["f_dc"]),
        f_rest=dev(f_rest) if f_rest is not None and f_rest.shape[0] == n
        else torch.zeros((n, 15, 3), device=device),
        log_scales=dev(g["log_scales"]), quats=dev(g["quats"]),
        opacity_logits=dev(g["opacity_logits"]))
    return params, torch.ones(n, dtype=torch.bool, device=device)


def _localize_tcfg(iters: int, base_lr: float, frozen: bool):
    """The reference viewpoint_localizer's settings: the MonoGS tracking
    loss, rot lr 3 * base_lr, trans lr base_lr, plateau 0.98 / 5."""
    return TrackerConfig(
        iterations=iters, cam_rot_lr=3.0 * base_lr, cam_trans_lr=base_lr,
        w_color_loss=0.95, alpha_thre=0.95, filter_alpha=True,
        filter_outlier_depth=True, soft_alpha=False, early_stop_cnt=15,
        plateau_factor=0.98, plateau_patience=5, frozen_binning=frozen)


def viewpoint_localize(params: GaussianParams, alive, view_c2w: np.ndarray,
                       gt_color, gt_depth, cam: Camera, rcfg: RasterConfig,
                       iters: int = 100,
                       base_lr: float = 1e-3) -> Tuple[np.ndarray, float]:
    """Optimise a camera pose so the map's render matches the view's RGB-D,
    re-binning at every step (loop-closure drift can exceed a frozen
    binning's margin). Returns (corrected c2w, final loss)."""
    dev = params.xyz.device
    last_w2c = np.linalg.inv(np.asarray(view_c2w, np.float64))
    rel, _, stats = refine_pose(
        params, alive, torch.eye(4, device=dev),
        torch.as_tensor(last_w2c, dtype=torch.float32, device=dev),
        gt_color, gt_depth, iters, torch.zeros(2, device=dev), cam, rcfg,
        _localize_tcfg(iters, base_lr, False))
    w2c_new = last_w2c @ rel.detach().cpu().numpy().astype(np.float64)
    return np.linalg.inv(w2c_new), float(stats[0])


def _localize_batch(params: GaussianParams, alive, last_w2cs, colors, depths,
                    iters: int, restarts: int, cam: Camera,
                    rcfg: RasterConfig, subset_frac: float = 0.25,
                    base_lr: float = 1e-3):
    """The viewpoint localisations of one registration side, view after
    view. `restarts` > 1 splits the budget into that many frozen-sorted
    segments of ceil(iters / restarts) iterations, re-freezing the layout
    at the updated pose between them; every segment but the last refines
    on the top-`subset_frac` tiles, chosen from a render at the segment's
    start pose (the tracker's ranking), and the last runs on the full
    image. Returns (rels (V, 4, 4) tensor, losses (V,) np.float32)."""
    inner = -(-iters // max(restarts, 1))
    tcfg = _localize_tcfg(inner, base_lr, restarts > 1)
    dev = params.xyz.device
    ts = rcfg.tile
    tiles_x = -(-cam.width // ts)
    tiles_y = -(-cam.height // ts)
    num_tiles = tiles_x * tiles_y
    s = int(round(subset_frac * num_tiles))
    use_subset = (0 < s < num_tiles and restarts > 1
                  and backend_of(rcfg) == "sorted" and tcfg.frozen_binning)
    colors_g = sh_to_rgb(params.f_dc)
    eye = torch.eye(4, device=dev)
    n_seg = max(restarts, 1)
    rels, losses = [], []
    for last_w2c, color, depth in zip(last_w2cs, colors, depths):
        rel_acc = eye
        loss = np.float32(np.inf)
        for seg in range(n_seg):
            base_w2c = last_w2c @ rel_acc
            subset = None
            if use_subset and seg < n_seg - 1:
                with torch.no_grad():
                    out0 = render(params.xyz, params.quats, params.log_scales,
                                  params.opacity_logits, colors_g, base_w2c,
                                  cam, rcfg, alive=alive)
                tile_ids = _select_tiles(color, depth, out0.alpha, cam, ts,
                                         tiles_x, tiles_y, s)
                subset = (tile_ids,
                          gt_tiles(color, tile_ids, ts, tiles_x, tiles_y),
                          gt_tiles(depth, tile_ids, ts, tiles_x, tiles_y),
                          _in_image_mask(tile_ids, ts, tiles_x, cam))
            loss_fn = _make_loss_fn(params, alive, colors_g, eye, base_w2c,
                                    color, depth, cam, rcfg, tcfg,
                                    subset=subset)
            rel, _, stats, _ = _refine(loss_fn, eye, inner,
                                       torch.zeros(2, device=dev), tcfg)
            rel_acc = rel_acc @ rel.detach()
            loss = stats[0]
        rels.append(rel_acc)
        losses.append(loss)
    return torch.stack(rels), np.asarray(losses, np.float32)


def icp_registration(gauss_src: Dict[str, np.ndarray],
                     gauss_tgt: Dict[str, np.ndarray], iters: int = 15,
                     dist: float = 0.25, robust: bool = False,
                     device="cpu") -> RegistrationResult:
    """Point-to-point ICP on gaussian centres (the reference's icp /
    robust_icp). `robust` first runs the FPFH + RANSAC global registration,
    then a shrinking-distance schedule. Returns the correction C for the
    target cloud."""
    dev = torch.device(device)
    src = gauss_src["xyz"].astype(np.float64)
    tgt = gauss_tgt["xyz"].astype(np.float64)
    cap = 20000
    rng = np.random.default_rng(0)
    if len(src) > cap:
        src = src[rng.choice(len(src), cap, replace=False)]
    if len(tgt) > cap:
        tgt = tgt[rng.choice(len(tgt), cap, replace=False)]
    C = np.eye(4)
    if robust:
        from .pcr import global_registration

        # C maps target-cloud points toward the source cloud.
        T_init, inl = global_registration(tgt, src, device=dev)
        if inl > 0.1:
            C = T_init
    fitness = 0.0
    src_t = torch.as_tensor(src, dtype=torch.float32, device=dev)
    src_mask = torch.ones(len(src), dtype=torch.bool, device=dev)
    tgt_mask = torch.ones(len(tgt), dtype=torch.bool, device=dev)
    for it in range(iters):
        d = dist * (0.5 ** (it // 5)) if robust else dist
        cur = tgt @ C[:3, :3].T + C[:3, 3]
        d2, nn_all = knn.nearest_neighbor(
            torch.as_tensor(cur, dtype=torch.float32, device=dev), tgt_mask,
            src_t, src_mask)
        d2 = d2.cpu().numpy()
        nn_all = nn_all.cpu().numpy()
        match = d2 < d * d
        fitness = float(match.mean())
        if match.sum() < 10:
            return RegistrationResult(False, np.eye(4), fitness, fitness)
        sub = cur[match]
        nn = nn_all[match]
        A = sub - sub.mean(0)
        B = src[nn] - src[nn].mean(0)
        U, _, Vt = np.linalg.svd(A.T @ B)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T
        step = np.eye(4)
        step[:3, :3] = R
        step[:3, 3] = src[nn].mean(0) - R @ sub.mean(0)
        C = step @ C
    return RegistrationResult(fitness > 0.3, C, fitness, fitness)


def gaussian_registration(
    gauss_src: Dict[str, np.ndarray],
    gauss_tgt: Dict[str, np.ndarray],
    views_src: List,
    views_tgt: List,
    desc_src: np.ndarray,
    desc_tgt: np.ndarray,
    cam: Camera,
    rcfg: RasterConfig,
    capacity: int,
    overlap_thre: float = 0.2,
    top_views: int = 2,
    pose_opt_iters: int = 100,
    base_lr: float = 1e-3,
    use_render: bool = False,
    overlap_dist: float = 0.05,
    localize_level: int = 0,
    localize_restarts: int = 4,
    localize_subset_frac: float = 0.25,
    timings: Optional[Dict[str, float]] = None,
    device="cpu",
) -> RegistrationResult:
    """Estimate the correction C that aligns the *target* submap onto the
    *source* one.

    views_*: keyframes as {c2w, color (H, W, 3), depth (H, W)} or
    zero-argument callables returning one (only the top-`top_views` views
    a side are resolved). desc_*: their (K, D) descriptors.
    localize_level: pyramid level of the localisations (colour box-averaged,
    depth strided: averaging across depth edges fabricates surfaces)."""
    dev = torch.device(device)

    def tick(name, t0):
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + 1e3 * (
                time.perf_counter() - t0)
        return time.perf_counter()

    t0 = time.perf_counter()
    p_src, a_src = subsample_params(gauss_src, capacity, dev)
    p_tgt, a_tgt = subsample_params(gauss_tgt, capacity, dev)
    t0 = tick("subsample_ms", t0)
    overlap = float(knn.overlap_ratio(p_src.xyz, a_src, p_tgt.xyz, a_tgt,
                                      overlap_dist))
    t0 = tick("overlap_ms", t0)
    if overlap < overlap_thre:
        return RegistrationResult(False, np.eye(4), 0.0, overlap)

    # Target views that look like source content and vice versa.
    sim = desc_src @ desc_tgt.T
    tgt_best = np.argsort(-sim.max(axis=0))[:top_views]
    src_best = np.argsort(-sim.max(axis=1))[:top_views]

    def resolve(views, idxs):
        return [views[int(i)]() if callable(views[int(i)])
                else views[int(i)] for i in idxs]

    corrections: List[np.ndarray] = []
    losses: List[float] = []
    # Target views against the SOURCE map give C directly; source views
    # against the TARGET map give its inverse. p_own is the view's own
    # submap: with use_render the localisation target is its render.
    for p_map, a_map, p_own, a_own, view_list, invert in (
        (p_src, a_src, p_tgt, a_tgt, resolve(views_tgt, tgt_best), False),
        (p_tgt, a_tgt, p_src, a_src, resolve(views_src, src_best), True),
    ):
        if not view_list:
            continue
        last_w2cs = np.stack([np.linalg.inv(np.asarray(v["c2w"], np.float64))
                              for v in view_list])
        if use_render:
            own_colors = sh_to_rgb(p_own.f_dc)
            rc, rd = [], []
            with torch.no_grad():
                for k in range(len(view_list)):
                    out = render(p_own.xyz, p_own.quats, p_own.log_scales,
                                 p_own.opacity_logits, own_colors,
                                 torch.as_tensor(last_w2cs[k],
                                                 dtype=torch.float32,
                                                 device=dev),
                                 cam, rcfg, alive=a_own)
                    rc.append(torch.clamp(out.color, 0.0, 1.0))
                    rd.append(torch.nan_to_num(out.depth, nan=0.0))
            colors, depths = torch.stack(rc), torch.stack(rd)
        else:
            colors = torch.stack([torch.as_tensor(v["color"], device=dev)
                                  for v in view_list]).to(torch.float32)
            depths = torch.stack([torch.as_tensor(v["depth"], device=dev)
                                  for v in view_list]).to(torch.float32)
        cam_l = cam
        if localize_level > 0:
            f = 1 << localize_level
            cam_l = cam.scaled(localize_level)
            hc, wc = cam_l.height * f, cam_l.width * f
            colors = colors[:, :hc, :wc].reshape(
                colors.shape[0], cam_l.height, f, cam_l.width, f, 3
            ).mean(dim=(2, 4))
            depths = depths[:, :hc:f, :wc:f].contiguous()
        t0 = tick("views_ms", t0)
        rels, losses_v = _localize_batch(
            p_map, a_map,
            torch.as_tensor(last_w2cs, dtype=torch.float32, device=dev),
            colors, depths, pose_opt_iters, localize_restarts, cam_l, rcfg,
            subset_frac=localize_subset_frac, base_lr=base_lr)
        rels = rels.cpu().numpy().astype(np.float64)
        t0 = tick("localize_ms", t0)
        for k, v in enumerate(view_list):
            c2w_new = np.linalg.inv(last_w2cs[k] @ rels[k])
            C = c2w_new @ np.linalg.inv(np.asarray(v["c2w"], np.float64))
            corrections.append(np.linalg.inv(C) if invert else C)
            losses.append(float(losses_v[k]))

    losses_np = np.asarray(losses)
    if not np.all(np.isfinite(losses_np)) or not all(
            np.all(np.isfinite(c)) for c in corrections):
        return RegistrationResult(False, np.eye(4), 0.0, overlap)

    # Residual-weighted fusion: a softmax over -loss (numpy's population
    # std), the rotations averaged in float32 on the host.
    w = np.exp(-(losses_np - losses_np.min()) / max(losses_np.std(), 1e-6))
    w = w / w.sum()
    R_fused = rotation_average(
        torch.as_tensor(np.stack([c[:3, :3] for c in corrections]),
                        dtype=torch.float32),
        torch.as_tensor(w, dtype=torch.float32)).numpy().astype(np.float64)
    C = np.eye(4)
    C[:3, :3] = R_fused
    C[:3, 3] = np.sum(np.stack([c[:3, 3] for c in corrections])
                      * w[:, None], axis=0)
    return RegistrationResult(True, C, float(w.max()), overlap)
