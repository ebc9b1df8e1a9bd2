"""Keyframe mapping: seeding, submap growth, resident-sorted submap
optimisation (port of eags_slam_tpu.slam.mapper).

Differences in form from the JAX version, none in the arithmetic:
  - the jitted `lax.while_loop`s are Python loops; the carry is tensors plus
    Python/numpy scalars;
  - the keyframe store is updated in place (`push_keyframe`);
  - randomness comes from a `torch.Generator`. The draws are split out so a
    caller can inject them: `sample_seed_ids` takes the Gumbel noise
    (`gumbels`), the optimisation takes a keyframe sampler (`kf_sampler`,
    called once per block) and a tile sampler (`tile_sampler`, called once
    per iteration of the tile subset). The same injected draws make the
    two packages take the same path.

Both optimisation loops are ported: the resident-sorted one (sorted
backend, `kf_block > 0`) and the plain one that renders every iteration
from the canonical row order with a keyframe drawn per iteration (the
`pallas` and `jnp` backends, or `kf_block <= 0`). With `tile_subset > 0` on the
sorted backend each iteration of the plain loop optimises a random subset
of min(tile_subset, tiles) tiles (`render_tiles` against `gt_tiles`, the
SSIM per tile), and the bookkeeping compares a loss EMA (beta 0.8): the
resident loop is off under the subset, as in the JAX package.
`halfres_single_kf` and `optimize_and_describe` are the two phases of the
half-resolution submap init (`init_halfres_frac`, driven by
`slam/gaussian_slam.py`).

With a `mesh` (parallel/mesh.py) the plain loop runs, never the resident
one; above one rank every rank draws the same n_dev keyframe indices each
iteration, rank r renders the r-th, and the loss terms and the gradient are
the ranks' means (`_mesh_step`, the JAX package's shard_map branch).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.camera import Camera, backproject
from ..core.gaussians import (OPT_KEYS, GaussianParams, GaussianState,
                              concat_rows, edge_pair_seeds, edge_rows, insert,
                              num_alive, point_rows)
from ..core.sh import sh_to_rgb
from ..ops import knn
from ..ops.image import (canny, depth_pyr_down, dilate,
                         gradient_sample_probs, rgb_to_gray)
from ..ops.losses import isotropic_loss, masked_l1, ssim, ssim_batched
from ..ops.rasterizer import (RasterConfig, backend_of, gt_tiles, render,
                              render_sorted_resident,
                              render_sorted_resident_tiles, render_tiles,
                              sorted_layout, tile_sums)
from ..utils import optim, tracing


class MapperConfig(NamedTuple):
    iterations: int = 100
    new_submap_iterations: int = 100
    new_submap_points_num: int = 100000
    new_submap_gradient_points_num: int = 50000
    new_frame_sample_size: int = 30000
    new_points_radius: float = 1e-7
    current_view_opt_iterations: float = 0.4
    alpha_thre: float = 0.6
    pruning_thre: float = 0.1
    edge_dilate: int = 2
    depth_thres: float = 0.025
    lambda_dssim: float = 0.2
    outlier_removal: bool = False
    max_keyframes: int = 32
    nn_backend: str = "morton"
    tile_subset: int = 0
    kf_block: int = 10
    freeze_frac: float = 0.0
    freeze_after: float = 0.65
    init_halfres_frac: float = 0.0
    init_warm_start: bool = False
    stale_best_cnt: int = 0
    warm_min_visible: int = 20000
    lr_xyz: float = 1e-4
    lr_scaling: float = 5e-3
    lr_rotation: float = 1e-3
    lr_opacity: float = 0.05


@dataclass
class KeyframeBatch:
    """Fixed-capacity stacked keyframes of the active submap."""

    color: torch.Tensor      # (K, H, W, 3)
    depth: torch.Tensor      # (K, H, W)
    w2c: torch.Tensor        # (K, 4, 4)
    exposure: torch.Tensor   # (K, 2)
    valid: torch.Tensor      # (K,) bool


def empty_keyframes(k: int, cam: Camera, device="cpu") -> KeyframeBatch:
    f32 = dict(dtype=torch.float32, device=device)
    return KeyframeBatch(
        color=torch.zeros((k, cam.height, cam.width, 3), **f32),
        depth=torch.zeros((k, cam.height, cam.width), **f32),
        w2c=torch.eye(4, **f32).repeat(k, 1, 1),
        exposure=torch.zeros((k, 2), **f32),
        valid=torch.zeros(k, dtype=torch.bool, device=device),
    )


@torch.no_grad()
def push_keyframe(kfs: KeyframeBatch, slot: int, color, depth, w2c,
                  exposure) -> KeyframeBatch:
    """Write a keyframe into `slot` (in place)."""
    kfs.color[slot] = color
    kfs.depth[slot] = depth
    kfs.w2c[slot] = w2c
    kfs.exposure[slot] = exposure
    kfs.valid[slot] = True
    return kfs


# ---------------------------------------------------------------------------
# Seeding
# ---------------------------------------------------------------------------


@torch.no_grad()
def seeding_mask_update(params: GaussianParams, alive, w2c, gt_depth,
                        cam: Camera, rcfg: RasterConfig, alpha_thre: float):
    """alpha < thre OR (rendered depth > gt AND depth_err > 40 * median)."""
    from .tracker import _median

    out = render(params.xyz, params.quats, params.log_scales,
                 params.opacity_logits, sh_to_rgb(params.f_dc), w2c, cam,
                 rcfg, alive=alive)
    valid_d = gt_depth > 0
    err = torch.abs(gt_depth - out.depth) * valid_d
    med = _median(err)
    depth_mask = (out.depth > gt_depth) & (err > 40.0 * med)
    return (out.alpha < alpha_thre) | depth_mask


def gumbel_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


@torch.no_grad()
def sample_seed_ids(seeding_mask, gt_depth, gray, n_uniform: int,
                    n_gradient: int, n_mask: int, is_new: bool,
                    generator: Optional[torch.Generator] = None,
                    gumbels=None):
    """Seed pixel ids (fixed size, validity-masked) by Gumbel top-k.

    New submap: union of uniform, gradient-weighted and mask pixels (capped
    at n_mask), duplicates removed. Update: up to n_mask mask pixels.
    `gumbels`: the Gumbel noise, one (H*W,) tensor per draw (3 for a new
    submap, 1 otherwise); drawn from `generator` when None."""
    p = seeding_mask.numel()
    dev = seeding_mask.device
    flat_mask = seeding_mask.reshape(-1) & (gt_depth.reshape(-1) > 0)
    n_draw = 3 if is_new else 1
    if gumbels is None:
        gumbels = [gumbel_noise(p, generator, dev) for _ in range(n_draw)]
    gumbels = [torch.as_tensor(g, dtype=torch.float32, device=dev)
               for g in gumbels]

    def gumbel_topk(g, logits, n):
        return torch.sort(logits + g, descending=True,
                          stable=True).indices[:n]

    neg_inf = torch.full((p,), -float("inf"), device=dev)
    mask_logits = torch.where(flat_mask, torch.zeros_like(neg_inf), neg_inf)
    if is_new:
        uni = gumbel_topk(gumbels[0], torch.zeros(p, device=dev), n_uniform)
        grad_logits = torch.log(gradient_sample_probs(gray) + 1e-12)
        grd = gumbel_topk(gumbels[1], grad_logits, n_gradient)
        msk = gumbel_topk(gumbels[2], mask_logits, n_mask)
        ids = torch.cat([uni, grd, msk])
        valid = torch.cat([torch.ones(n_uniform + n_gradient,
                                      dtype=torch.bool, device=dev),
                           flat_mask[msk]])
        key = torch.where(valid, ids, torch.full_like(ids, 2**31 - 1))
        order = torch.argsort(key, stable=True)
        s_ids, s_val = ids[order], valid[order]
        dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                         s_ids[1:] == s_ids[:-1]])
        ids, valid = s_ids, s_val & ~dup
    else:
        ids = gumbel_topk(gumbels[0], mask_logits, n_mask)
        valid = flat_mask[ids]
    valid = valid & (gt_depth.reshape(-1)[ids] > 0)
    return ids.to(torch.int32), valid


@torch.no_grad()
def backproject_world(gt_color, gt_depth, c2w, cam: Camera):
    """(H*W, 3) world points at 1.0001 * depth, and colours."""
    pts_cam = backproject(cam, 1.0001 * gt_depth)
    R, t = c2w[:3, :3], c2w[:3, 3]
    return pts_cam.reshape(-1, 3) @ R.T + t, gt_color.reshape(-1, 3)


@torch.no_grad()
def _build_rows(map_xyz, map_alive, sample_ids, sample_valid, all_pts_w,
                all_rgb, edge_img, gt_depth, radius: float, height: int,
                width: int, use_edge: bool, outlier: bool,
                depth_thres: float, nn_backend: str
                ) -> Tuple[GaussianParams, torch.Tensor]:
    """Candidate rows: dedup vs the submap, optional outlier filter, kNN
    scale init, point + edge rows."""
    ids = sample_ids.long()
    cand = all_pts_w[ids]
    if nn_backend == "morton":
        keep, dist2 = knn.morton_window_nn(cand, sample_valid, map_xyz,
                                           map_alive, radius)
        if outlier:
            keep = keep & knn.statistical_inlier_mask(cand, keep, nb=20)
        sample_valid = keep
    else:
        keep = knn.radius_dedup(cand, sample_valid, map_xyz, map_alive,
                                radius)
        if outlier:
            keep = keep & knn.statistical_inlier_mask(cand, keep, nb=20)
        sample_valid = keep
        dist2 = knn.mean_sq_dist_knn_query(
            cand, sample_valid, torch.cat([map_xyz, cand], 0),
            torch.cat([map_alive, sample_valid], 0),
            self_offset=map_xyz.shape[0])
    if use_edge:
        (_, _, pair_valid, exyz, ergb, elog_s, equat,
         member) = edge_pair_seeds(ids, sample_valid, edge_img, gt_depth,
                                   all_pts_w, all_rgb, height, width,
                                   depth_thres)
        opacity = torch.where(member, torch.full_like(dist2, 0.1),
                              torch.full_like(dist2, 0.5))
        rows = concat_rows(point_rows(cand, all_rgb[ids], dist2, opacity),
                           edge_rows(exyz, ergb, elog_s, equat))
        valid = torch.cat([sample_valid, pair_valid])
    else:
        rows = point_rows(cand, all_rgb[ids], dist2,
                          torch.full_like(dist2, 0.5))
        valid = sample_valid
    return rows, valid


@torch.no_grad()
def grow_submap(state: GaussianState, sample_ids, sample_valid, all_pts_w,
                all_rgb, edge_img, gt_depth, radius: float, cam: Camera,
                height: int, width: int, use_edge: bool, outlier: bool,
                depth_thres: float = 0.025):
    """Exact (brute-force NN) growth: dedup, scale init, insert."""
    rows, valid = _build_rows(state.params.xyz, state.alive, sample_ids,
                              sample_valid, all_pts_w, all_rgb, edge_img,
                              gt_depth, radius, height, width, use_edge,
                              outlier, depth_thres, nn_backend="brute")
    return insert(state, rows, valid)


@torch.no_grad()
def seed_rows(params: GaussianParams, alive, gt_color, gt_depth, c2w, w2c,
              edges, cam: Camera, rcfg: RasterConfig, mcfg: MapperConfig,
              is_new: bool, use_canny: bool, use_edge: bool = True,
              outlier: bool = False, generator=None, gumbels=None):
    """The pre-optimisation mapped-frame path: edges, seeding mask, seed
    sampling, backprojection, dedup + scale init, candidate rows.
    `edges`: the (H, W) bool edge mask (the VO's), read unless `use_canny`.
    Returns (rows, valid, n_valid, seeding_mask)."""
    gray255 = rgb_to_gray(gt_color) * 255.0
    if use_canny:
        edge_b = canny(gray255, 100.0, 150.0, l2gradient=False)
    else:
        edge_b = edges
    edge_b = edge_b.clone()
    edge_b[0] = False
    edge_b[-1] = False
    edge_b[:, 0] = False
    edge_b[:, -1] = False
    if is_new:
        seeding_mask = dilate(edge_b, mcfg.edge_dilate)
    else:
        seeding_mask = seeding_mask_update(params, alive, w2c, gt_depth, cam,
                                           rcfg, mcfg.alpha_thre)
    ids, valid = sample_seed_ids(
        seeding_mask, gt_depth, gray255, mcfg.new_submap_points_num,
        mcfg.new_submap_gradient_points_num, mcfg.new_frame_sample_size,
        is_new, generator=generator, gumbels=gumbels)
    pts_w, rgbs = backproject_world(gt_color, gt_depth, c2w, cam)
    rows, row_valid = _build_rows(
        params.xyz, alive, ids, valid, pts_w, rgbs, edge_b, gt_depth,
        mcfg.new_points_radius, cam.height, cam.width, use_edge, outlier,
        mcfg.depth_thres, mcfg.nn_backend)
    return rows, row_valid, int(row_valid.sum()), seeding_mask


# ---------------------------------------------------------------------------
# Submap optimisation
# ---------------------------------------------------------------------------


def _keyframe_distribution(n_kf: int, k_max: int, cur_frac: float):
    """P(keyframe): slot 0 (the current frame) gets `cur_frac`, the rest is
    uniform over the other valid keyframes (float32, like the JAX one)."""
    idx = np.arange(k_max)
    others = max(n_kf - 1, 1)
    p = np.where(idx == 0, np.float32(cur_frac),
                 np.float32(1.0 - cur_frac) / np.float32(others))
    p = np.where(idx < n_kf, p, 0.0).astype(np.float32)
    return p / p.sum()


@dataclass
class _BookState:
    """Bookkeeping of the optimisation loop: loss EMA, the every-5% best
    checkpoint of (params, Adam), prune/rollback flags, the post-prune
    early-stop and stale-best counters."""

    best_loss: np.float32
    ema: np.float32
    ckpt_opt: Dict[str, torch.Tensor]
    ckpt_adam: optim.AdamState
    has_ckpt: bool
    early_cnt: int
    stale_cnt: int
    stopped: bool


def _book_step(book: _BookState, it: int, total, opt, adam, alive, *,
               pruning_thre, ckpt_every, early_thre, prune_iters, ema_beta,
               stale_best_cnt=0):
    """One bookkeeping step on the post-update (opt, adam). Returns
    (book', opt', adam', alive')."""
    f32 = np.float32
    total = f32(total)
    ema = total if it == 0 else f32(f32(ema_beta) * book.ema
                                    + f32(1 - ema_beta) * total)
    is_ckpt_iter = (it % ckpt_every == 0) and it != 0
    improved = bool(ema < book.best_loss)
    take = is_ckpt_iter and improved
    ckpt_opt = opt if take else book.ckpt_opt
    ckpt_adam = adam if take else book.ckpt_adam
    best_loss = ema if take else book.best_loss
    has_ckpt = book.has_ckpt or take

    is_prune = it == prune_iters[0] or it == prune_iters[1]
    if is_prune and has_ckpt and best_loss < ema:
        opt, adam = ckpt_opt, ckpt_adam
    if is_prune:
        alive = alive & ~(torch.sigmoid(opt["opacity_logits"][:, 0])
                          < pruning_thre)
        best_loss = f32(np.inf)
        has_ckpt = False

    after = it > prune_iters[1]
    bad = after and has_ckpt and (ema - best_loss > f32(0.15) * best_loss)
    early_cnt = book.early_cnt + 1 if bad else 0
    stopped = book.stopped or early_cnt > early_thre
    stale_cnt = book.stale_cnt
    if stale_best_cnt > 0:
        stale_cnt = stale_cnt + 1 if (after and not improved) else 0
        stopped = stopped or stale_cnt > stale_best_cnt
    return (_BookState(best_loss, ema, ckpt_opt, ckpt_adam, has_ckpt,
                       early_cnt, stale_cnt, stopped), opt, adam, alive)


def _permute_adam(a: optim.AdamState, order) -> optim.AdamState:
    return optim.AdamState(a.step, {k: v[order] for k, v in a.mu.items()},
                           {k: v[order] for k, v in a.nu.items()},
                           {k: v[order] for k, v in a.vmax.items()})


def _masked_grads(opt: Dict[str, torch.Tensor], total, alive):
    leaves = [opt[k] for k in OPT_KEYS]
    gs = torch.autograd.grad(total, leaves)
    m = alive.to(torch.float32)
    return {k: g * m.reshape((-1,) + (1,) * (g.dim() - 1))
            for k, g in zip(OPT_KEYS, gs)}


def _map_loss(out, kfs: KeyframeBatch, kidx: int, log_scales, alive,
              lam: float):
    """(1 - lam) masked L1 + lam (1 - SSIM) + masked depth L1 + isotropic
    regulariser of a full-image render of keyframe `kidx`. Returns (total,
    colour loss, depth loss, exposure-corrected image, mask)."""
    gt_color, gt_depth = kfs.color[kidx], kfs.depth[kidx]
    exp_a, exp_b = kfs.exposure[kidx, 0], kfs.exposure[kidx, 1]
    image = torch.clamp(out.color * torch.exp(exp_a) + exp_b, 0.0, 1.0)
    mask = ((gt_depth > 0) & ~torch.isnan(out.depth)).to(image.dtype)
    color_loss = (1.0 - lam) * masked_l1(image, gt_color, mask) \
        + lam * (1.0 - ssim(image, gt_color))
    depth_loss = masked_l1(out.depth, gt_depth, mask)
    total = color_loss + depth_loss + isotropic_loss(log_scales, alive)
    return total, color_loss, depth_loss, image, mask


def _tile_loss(out, kfs: KeyframeBatch, kidx: int, tile_sel, cam: Camera,
               ts: int, log_scales, alive, lam: float):
    """`_map_loss` of a render of the tiles `tile_sel` (S,) of keyframe
    `kidx` against its `gt_tiles`, the SSIM taken per tile and averaged.
    Returns (total, colour loss, depth loss)."""
    tiles_x, tiles_y = -(-cam.width // ts), -(-cam.height // ts)
    gt_c = gt_tiles(kfs.color[kidx], tile_sel, ts, tiles_x, tiles_y)
    gt_d = gt_tiles(kfs.depth[kidx], tile_sel, ts, tiles_x, tiles_y)
    exp_a, exp_b = kfs.exposure[kidx, 0], kfs.exposure[kidx, 1]
    image = torch.clamp(out.color * torch.exp(exp_a) + exp_b, 0.0, 1.0)
    mask = ((gt_d > 0) & ~torch.isnan(out.depth)).to(image.dtype)
    color_loss = (1.0 - lam) * masked_l1(image, gt_c, mask) \
        + lam * (1.0 - ssim_batched(image, gt_c).mean())
    depth_loss = masked_l1(out.depth, gt_d, mask)
    total = color_loss + depth_loss + isotropic_loss(log_scales, alive)
    return total, color_loss, depth_loss


def _optimize_plain(state: GaussianState, kfs: KeyframeBatch, iterations,
                    cam, rcfg, mcfg, p_kf, lr_tree, book_step, book0,
                    draw_kf, draw_tiles=None, mesh_step=None):
    """The non-resident optimisation: every iteration draws a keyframe
    (`draw_kf(p_kf, it)`, 0 while it < 5), renders the rows in their
    canonical order (with `draw_tiles`, only the tiles `draw_tiles(it)`),
    masks the grads by `alive` and takes an Adam step and the bookkeeping
    step. `mesh_step(leaves, alive, it) -> ((3,) loss terms, grads)` takes
    the place of the draw, the render and the grads (the mesh branch)."""
    opt = {k: getattr(state.params, k) for k in OPT_KEYS}
    adam, alive, book = state.adam, state.alive, book0
    colors = sh_to_rgb(state.params.f_dc)
    losses = np.zeros((iterations, 3), np.float32)
    it = 0
    while it < iterations and not book.stopped:
        with tracing.span("map.iter"):
            leaf = {k: v.detach().requires_grad_(True)
                    for k, v in opt.items()}
            if mesh_step is not None:
                vals, grads = mesh_step(leaf, alive, it)
            else:
                with tracing.span("map.draw"):
                    kidx = int(draw_kf(p_kf, it))
                if draw_tiles is None:
                    out = render(leaf["xyz"], leaf["quats"],
                                 leaf["log_scales"], leaf["opacity_logits"],
                                 colors, kfs.w2c[kidx], cam, rcfg,
                                 alive=alive)
                    total, cl, dl, _, _ = _map_loss(out, kfs, kidx,
                                                    leaf["log_scales"], alive,
                                                    mcfg.lambda_dssim)
                else:
                    tile_sel = draw_tiles(it)
                    out = render_tiles(leaf["xyz"], leaf["quats"],
                                       leaf["log_scales"],
                                       leaf["opacity_logits"], colors,
                                       kfs.w2c[kidx], tile_sel, cam, rcfg,
                                       alive=alive)
                    total, cl, dl = _tile_loss(out, kfs, kidx, tile_sel, cam,
                                               rcfg.tile, leaf["log_scales"],
                                               alive, mcfg.lambda_dssim)
                grads = _masked_grads(leaf, total, alive)
                vals = torch.stack([total.detach(), cl.detach(), dl.detach()])
            with tracing.span("map.readback"):
                vals = vals.cpu().numpy().astype(np.float32)
            new_opt, new_adam = optim.adam_update(
                adam, {k: v.detach() for k, v in leaf.items()}, grads, lr_tree)
            book, opt, adam, alive = book_step(book, it, vals[0], new_opt,
                                               new_adam, alive)
            losses[it] = vals
            it += 1
    return opt, adam, alive, book, it, losses


def _mesh_step(mesh, kfs: KeyframeBatch, cam: Camera, rcfg: RasterConfig,
               mcfg: MapperConfig, colors, p_kf, draw_kf):
    """The mesh branch's iteration (a mesh of more than one rank): every
    rank draws the same `n_dev` keyframe indices (all 0 while it < 5), rank
    r renders keyframe kidxs[r] on the full image; the loss, its colour and
    depth terms and the gradient are the ranks' means (one all-reduce)."""
    from ..parallel.mesh import reduce_shares

    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]

    def step(leaf, alive, it):
        kidx = int(draw_kf(p_kf, it, n_dev)[mesh.coord[axis]])
        out = render(leaf["xyz"], leaf["quats"], leaf["log_scales"],
                     leaf["opacity_logits"], colors, kfs.w2c[kidx], cam,
                     rcfg, alive=alive)
        total, cl, dl, _, _ = _map_loss(out, kfs, kidx, leaf["log_scales"],
                                        alive, mcfg.lambda_dssim)
        # Each rank's loss is a whole view's: the mean of the ranks'
        # gradients is the exact one (summed, then divided, as JAX's pmean).
        vals, grads = reduce_shares(mesh.groups[axis], [total, cl, dl],
                                    _masked_grads(leaf, total, alive))
        return vals / n_dev, {k: g / n_dev for k, g in grads.items()}
    return step


def _optimize_resident(state: GaussianState, kfs: KeyframeBatch, iterations,
                       cam, rcfg, mcfg, p_kf, lr_tree, book_step, book0,
                       draw_kf):
    """Keyframe-blocked resident-sorted optimisation: once per `kf_block`
    iterations a keyframe is drawn and every per-row tensor (params, Adam
    moments, checkpoint, colours, alive) is permuted into that keyframe's
    (centre tile, depth) order; the block then renders with no per-iteration
    gather. The first 5 iterations are pinned to keyframe 0. With
    `freeze_frac`, blocks from `freeze_after * iterations` on run one
    full-image iteration and then optimise only the top residual tiles."""
    r_block = int(mcfg.kf_block)
    n = state.capacity
    dev = state.alive.device
    tiles_x = -(-cam.width // rcfg.tile)
    tiles_y = -(-cam.height // rcfg.tile)
    num_tiles = tiles_x * tiles_y
    use_freeze = mcfg.freeze_frac > 0 and r_block > 1
    k_act = max(1, int(round(num_tiles * mcfg.freeze_frac)))
    freeze_start = max(1, int(mcfg.freeze_after * iterations))
    lam = mcfg.lambda_dssim

    def loss_full(opt, f_dc, alive, kidx, seg_start, seg_cnt):
        gt_color, gt_depth = kfs.color[kidx], kfs.depth[kidx]
        out = render_sorted_resident(
            opt["xyz"], opt["quats"], opt["log_scales"],
            opt["opacity_logits"], sh_to_rgb(f_dc), kfs.w2c[kidx],
            seg_start, seg_cnt, cam, rcfg, alive=alive)
        total, color_loss, depth_loss, image, mask = _map_loss(
            out, kfs, kidx, opt["log_scales"], alive, lam)
        with torch.no_grad():
            err = (torch.abs(image - gt_color).mean(-1)
                   + torch.abs(torch.nan_to_num(out.depth) - gt_depth)) * mask
            res = tile_sums(err, rcfg.tile, tiles_x, tiles_y)
        return total, color_loss, depth_loss, res

    def loss_sub(opt, f_dc, alive, kidx, seg_start, seg_cnt, tile_sel):
        out = render_sorted_resident_tiles(
            opt["xyz"], opt["quats"], opt["log_scales"],
            opt["opacity_logits"], sh_to_rgb(f_dc), kfs.w2c[kidx],
            seg_start, seg_cnt, tile_sel, cam, rcfg, alive=alive)
        return _tile_loss(out, kfs, kidx, tile_sel, cam, rcfg.tile,
                          opt["log_scales"], alive, lam)

    it = 0
    perm = torch.arange(n, device=dev)
    opt = {k: getattr(state.params, k) for k in OPT_KEYS}
    adam = state.adam
    f_dc = state.params.f_dc
    alive = state.alive
    book = book0
    losses = np.zeros((iterations, 3), np.float32)

    def step(it, opt, adam, alive, book, kidx, seg_start, seg_cnt,
             tile_sel=None):
        with tracing.span("map.iter"):
            leaf = {k: v.detach().requires_grad_(True)
                    for k, v in opt.items()}
            if tile_sel is None:
                total, cl, dl, res = loss_full(leaf, f_dc, alive, kidx,
                                               seg_start, seg_cnt)
            else:
                total, cl, dl = loss_sub(leaf, f_dc, alive, kidx, seg_start,
                                         seg_cnt, tile_sel)
                res = None
            grads = _masked_grads(leaf, total, alive)
            vals = torch.stack([total.detach(), cl.detach(), dl.detach()])
            with tracing.span("map.readback"):
                vals = vals.cpu().numpy().astype(np.float32)
            new_opt, new_adam = optim.adam_update(
                adam, {k: v.detach() for k, v in leaf.items()}, grads, lr_tree)
            tot_for_book = vals[0] if tile_sel is None else book.ema
            book, opt, adam, alive = book_step(book, it, tot_for_book, new_opt,
                                               new_adam, alive)
            losses[it] = vals
            return opt, adam, alive, book, res

    while it < iterations and not book.stopped:
        it0 = it
        with tracing.span("map.draw"):
            kidx = int(draw_kf(p_kf, it0))
        order, seg_start, seg_cnt = sorted_layout(
            opt["xyz"], opt["quats"], opt["log_scales"],
            opt["opacity_logits"], kfs.w2c[kidx], cam, rcfg, alive=alive)
        opt = {k: v[order] for k, v in opt.items()}
        adam = _permute_adam(adam, order)
        book = replace(book, ckpt_opt={k: v[order] for k, v in
                                       book.ckpt_opt.items()},
                       ckpt_adam=_permute_adam(book.ckpt_adam, order))
        f_dc = f_dc[order]
        alive = alive[order]
        perm = perm[order]
        n_it = min(r_block, iterations - it0)
        if it0 < 5:
            n_it = min(n_it, 5 - it0)
        end = it0 + n_it
        if use_freeze and it0 >= freeze_start:
            opt, adam, alive, book, res = step(it, opt, adam, alive, book,
                                               kidx, seg_start, seg_cnt)
            it += 1
            from .tracker import _stable_topk

            tile_sel = _stable_topk(res, k_act).to(torch.int32)
            while it < end and not book.stopped:
                opt, adam, alive, book, _ = step(it, opt, adam, alive, book,
                                                 kidx, seg_start, seg_cnt,
                                                 tile_sel)
                it += 1
        else:
            while it < end and not book.stopped:
                opt, adam, alive, book, _ = step(it, opt, adam, alive, book,
                                                 kidx, seg_start, seg_cnt)
                it += 1

    inv = torch.argsort(perm)
    opt = {k: v[inv] for k, v in opt.items()}
    adam = _permute_adam(adam, inv)
    alive = alive[inv]
    book = replace(book, ckpt_opt={k: v[inv] for k, v in
                                   book.ckpt_opt.items()},
                   ckpt_adam=_permute_adam(book.ckpt_adam, inv))
    return opt, adam, alive, book, it, losses


def _default_kf_sampler(generator, device):
    """Keyframe 0 for blocks (or, in the plain loop, iterations) starting
    below iteration 5, else a draw from `p_kf`; with `n`, a list of n such
    indices (the mesh branch's draw, one a rank)."""
    def draw(p_kf, it0, n=None):
        if it0 < 5:
            return 0 if n is None else [0] * n
        p = torch.as_tensor(p_kf, dtype=torch.float32, device=device)
        if n is None:
            return int(torch.multinomial(p, 1, generator=generator))
        return torch.multinomial(p, n, replacement=True,
                                 generator=generator).tolist()
    return draw


def _default_tile_sampler(generator, device, num_tiles: int, n_sub: int):
    """`n_sub` distinct tiles of the `num_tiles`, drawn uniformly without
    replacement each iteration (the JAX package's permutation prefix)."""
    def draw(it):
        return torch.randperm(num_tiles, generator=generator,
                              device=device)[:n_sub].to(torch.int32)
    return draw


def _optimize_core(state: GaussianState, kfs: KeyframeBatch, n_kf: int,
                   iterations: int, cam: Camera, rcfg: RasterConfig,
                   mcfg: MapperConfig, generator=None, kf_sampler=None,
                   tile_sampler=None, mesh=None):
    """Submap optimisation (slot 0 = the current frame): loss = (1 - l)
    masked L1 + l (1 - SSIM) + masked depth L1 + isotropic regulariser;
    checkpoint every 5%, prune (+ rollback) at 30% / 60%, early stop after
    the last prune, final rollback and opacity < 0.01 prune.
    `kf_sampler(p_kf, it0) -> keyframe index` is called once per block of
    the resident loop, once per iteration of the plain one; it replaces the
    generator's draws (and must return 0 while it0 < 5). With a `mesh`
    (parallel/mesh.py) the plain loop runs, never the resident one; above
    one rank each iteration calls `kf_sampler(p_kf, it, n_dev) -> n_dev
    indices` and rank r renders the r-th (`_mesh_step`). With
    `mcfg.tile_subset` on the sorted backend, `tile_sampler(it) -> (S,)
    int32 tile ids` (S = min(tile_subset, tiles)) is called once per
    iteration, after the keyframe draw, in place of the generator's.
    Returns (state, {"losses": (iterations, 3), "iterations": run})."""
    frozen = state.params
    ckpt_every = max(int(0.05 * iterations), 1)
    early_thre = max(int(0.05 * iterations), 1)
    prune_iters = (int(0.3 * iterations), int(0.6 * iterations))
    p_kf = _keyframe_distribution(n_kf, mcfg.max_keyframes,
                                  mcfg.current_view_opt_iterations)
    lr_tree = {"xyz": mcfg.lr_xyz, "log_scales": mcfg.lr_scaling,
               "quats": mcfg.lr_rotation,
               "opacity_logits": mcfg.lr_opacity}
    draw_kf = kf_sampler or _default_kf_sampler(generator,
                                                 state.alive.device)
    sorted_backend = backend_of(rcfg) == "sorted"
    draw_tiles = None
    if mcfg.tile_subset > 0 and sorted_backend:
        num_tiles = -(-cam.width // rcfg.tile) * -(-cam.height // rcfg.tile)
        draw_tiles = tile_sampler or _default_tile_sampler(
            generator, state.alive.device, num_tiles,
            min(mcfg.tile_subset, num_tiles))
    # Under the tile subset the per-iteration loss is a noisy estimate: the
    # checkpoint / rollback / early-stop decisions compare an EMA.
    ema_beta = 0.8 if draw_tiles is not None else 0.0

    def book_step(book, it, total, opt, adam, alive):
        return _book_step(book, it, total, opt, adam, alive,
                          pruning_thre=mcfg.pruning_thre,
                          ckpt_every=ckpt_every, early_thre=early_thre,
                          prune_iters=prune_iters, ema_beta=ema_beta,
                          stale_best_cnt=mcfg.stale_best_cnt)

    opt0 = {k: getattr(state.params, k) for k in OPT_KEYS}
    book0 = _BookState(np.float32(np.inf), np.float32(np.inf), opt0,
                       state.adam, False, 0, 0, False)
    args = (state, kfs, iterations, cam, rcfg, mcfg, p_kf, lr_tree,
            book_step, book0, draw_kf)
    mesh_step = None
    if mesh is not None and mesh.size > 1:
        mesh_step = _mesh_step(mesh, kfs, cam, rcfg, mcfg,
                               sh_to_rgb(state.params.f_dc), p_kf, draw_kf)
    if (sorted_backend and mcfg.kf_block > 0 and draw_tiles is None
            and mesh is None):
        opt, adam, alive, book, final_it, losses = _optimize_resident(*args)
    else:
        opt, adam, alive, book, final_it, losses = _optimize_plain(
            *args, draw_tiles, mesh_step)
    last = losses[max(final_it - 1, 0)]
    losses[final_it:] = last
    if book.has_ckpt and book.best_loss < book.ema:
        opt, adam = book.ckpt_opt, book.ckpt_adam
    alive = alive & (torch.sigmoid(opt["opacity_logits"][:, 0]) >= 0.01)
    params = frozen.replace(**{k: v.detach() for k, v in opt.items()})
    return GaussianState(params, alive, adam), {"losses": losses,
                                                "iterations": final_it}


optimize_submap = _optimize_core


@torch.no_grad()
def warm_visible(params: GaussianParams, alive, w2c, cam: Camera,
                 min_opacity: float = 0.05, margin_frac: float = 0.05):
    """Alive gaussians visible at `w2c` (in front, inside the image with a
    margin, opacity >= min_opacity) for the warm-start submap init."""
    xyz_cam = params.xyz @ w2c[:3, :3].T + w2c[:3, 3]
    z = xyz_cam[:, 2]
    zs = torch.clamp(z, min=1e-6)
    u = cam.fx * xyz_cam[:, 0] / zs + cam.cx
    v = cam.fy * xyz_cam[:, 1] / zs + cam.cy
    mx = margin_frac * cam.width
    my = margin_frac * cam.height
    op = torch.sigmoid(params.opacity_logits[:, 0])
    vis = (alive & (z > 1e-2) & (u >= -mx) & (u <= cam.width - 1 + mx)
           & (v >= -my) & (v <= cam.height - 1 + my) & (op >= min_opacity))
    return vis, int(vis.sum())


@torch.no_grad()
def halfres_single_kf(color, depth, w2c, exposure) -> KeyframeBatch:
    """A one-keyframe batch at half resolution for the first phase of a
    submap's init: colour the 2x2 mean, depth `depth_pyr_down`'s
    hole-aware 2x2 mean (0 where the block holds no valid depth); the pose
    is resolution-independent, the intrinsics are `Camera.scaled(1)`'s."""
    h2, w2 = color.shape[0] // 2, color.shape[1] // 2
    c = color[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, 3)
    # Summed in the JAX package's reduction order, so the mean is its own.
    mean = (((c[:, 0, :, 0] + c[:, 0, :, 1]) + c[:, 1, :, 0])
            + c[:, 1, :, 1]) / 4.0
    return KeyframeBatch(
        color=mean[None],
        depth=depth_pyr_down(depth)[:h2, :w2][None],
        w2c=w2c[None], exposure=exposure[None],
        valid=torch.ones(1, dtype=torch.bool, device=color.device))


def optimize_and_describe(state: GaussianState, kfs: KeyframeBatch,
                          n_kf: int, iterations: int, cam: Camera,
                          rcfg: RasterConfig, mcfg: MapperConfig,
                          generator=None, kf_sampler=None,
                          tile_sampler=None, mesh=None):
    """Optimise and describe slot 0 for place recognition, no insert: the
    full-resolution tail of a half-resolution submap init (the descriptor
    comes from the full-resolution boundary frame). Returns (state,
    losses, n_alive, desc, iterations run)."""
    from ..lc.descriptor import global_descriptor

    new_state, aux = _optimize_core(state, kfs, n_kf, iterations, cam, rcfg,
                                    mcfg, generator=generator,
                                    kf_sampler=kf_sampler,
                                    tile_sampler=tile_sampler, mesh=mesh)
    desc = global_descriptor(kfs.color[0])
    return (new_state, aux["losses"], num_alive(new_state), desc,
            aux["iterations"])


def insert_and_optimize(state: GaussianState, rows: GaussianParams, valid,
                        kfs: KeyframeBatch, n_kf: int, iterations: int,
                        cam: Camera, rcfg: RasterConfig, mcfg: MapperConfig,
                        generator=None, kf_sampler=None, tile_sampler=None,
                        mesh=None):
    """Insert `seed_rows` output, optimise, and describe slot 0 for place
    recognition. Returns (state, n_added, losses, n_alive, desc)."""
    state, n_added = insert(state, rows, valid)
    new_state, losses, n_alive, desc, _ = optimize_and_describe(
        state, kfs, n_kf, iterations, cam, rcfg, mcfg, generator=generator,
        kf_sampler=kf_sampler, tile_sampler=tile_sampler, mesh=mesh)
    return new_state, n_added, losses, n_alive, desc
