"""Device mesh over `torch.distributed`: data- and spatially-parallel map
optimisation and spatially-parallel tracking (port of
eags_slam_tpu.parallel.mesh).

One process per rank, PyTorch's idiom (JAX drives every chip from one
process). Every rank runs the same frame loop on replicated state; a `Mesh`
is a set of those ranks with a process group per axis, the counterpart of
`jax.sharding.Mesh`. Collectives go through `torch.distributed`: NCCL on
the card, gloo on the CPU.

  - `dp_map_step`: the keyframes split over `data`, one a rank, against the
    replicated map; the loss and its gradient averaged over the ranks;
  - `sp_map_step`: ONE view's tile grid split over the ranks (padded to a
    multiple of the size with weight-0 tiles); the masked-L1 numerators and
    denominators and the per-tile SSIM sums all-reduced, so the loss is the
    full view's;
  - `dpsp_map_step`: both on a ("data", "space") mesh, each view's sums over
    `space`, the views' mean over `data`;
  - `sp_track_refine`: the tracker's refinement with its frozen-sorted tile
    grid split over the ranks, the loss sums all-reduced, the outlier-depth
    median taken over an all-gather of the 1/16 subsample;
  - `lc_submesh`: the ranks loop closure runs on.

Gradients. JAX takes the `pmean` of each device's gradient because
shard_map's transpose of `psum` hands each device D x its share. Autograd
in torch does not: a collective is a constant to it. So each rank builds its
SHARE of the global loss -- its local numerators over the all-reduced
denominators (counts, which need no gradient), and a replicated term over D
-- and the shares' gradients are SUMMED over the ranks, which gives the
exact gradient of the global loss. A pmean of these local gradients would
be 1/D of it, an error Adam's step-1 scale invariance hides everywhere but
its eps zone; the tests compare gradients for that reason.

Replication. The state stays bit-identical across ranks because every rank
applies the same all-reduced gradient (an all-reduce hands every rank the
same bits) to the same state with the same optimiser, and every rank's
bookkeeping (checkpoints, prunes, early stops, the tracker's plateau and
best iterate) reads the same all-reduced loss. What a rank computes alone
from replicated inputs (the tracked pose, the seed rows, the tracking
candidates) the orchestrator broadcasts from the mesh's first rank
(`broadcast_tensors`), so that no run-dependent kernel sum (K2's float
atomics) can split the ranks.

Collectives are issued at world size 1 too: that is the one-card run of
this path (`force_mesh`). `collective_counts()` counts them by kind.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.camera import Camera
from ..core.gaussians import OPT_KEYS, GaussianState, opt_subset
from ..core.sh import sh_to_rgb
from ..ops.losses import isotropic_loss, masked_l1, ssim, ssim_batched
from ..ops.rasterizer import RasterConfig, gt_tiles, render, render_tiles
from ..utils import optim

# ---------------------------------------------------------------------------
# Process group and mesh
# ---------------------------------------------------------------------------


def launched_by_torchrun() -> bool:
    """Whether torchrun's RANK / WORLD_SIZE are set for this process."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_process_group(device: torch.device) -> torch.device:
    """The run's default process group, made if there is none: from
    torchrun's RANK / WORLD_SIZE / LOCAL_RANK (env://) when they are set,
    else one rank on an in-process store. NCCL for a CUDA device, gloo for
    the CPU; an existing group must have that backend. Returns the rank's
    device (cuda:LOCAL_RANK under torchrun)."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        index = (int(os.environ.get("LOCAL_RANK", 0))
                 if launched_by_torchrun() else
                 device.index if device.index is not None
                 else torch.cuda.current_device())
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if launched_by_torchrun():
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group's backend is "
                           f"{dist.get_backend()!r}; a {device.type} run "
                           f"needs {backend!r}")
    return device


def _new_group(ranks: List[int]):
    """A process group of `ranks` (every rank of the default group must
    call this, in the same order)."""
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks)


class Mesh:
    """Counterpart of `jax.sharding.Mesh`: `axis_names`, `shape` (axis ->
    size), `ranks` (the global ranks, row-major over the axes), this rank's
    `coord` (axis -> index; None outside the mesh), `groups` (axis -> this
    rank's process group along that axis), `group` (every rank of the mesh)
    and the rank's `device`."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 ranks: List[int], groups: Optional[Dict], group,
                 device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.ranks = list(ranks)
        self.groups = groups
        self.group = group
        self.device = device
        rank = dist.get_rank()
        self.coord = None
        if rank in self.ranks:
            i, self.coord = self.ranks.index(rank), {}
            for ax in reversed(self.axis_names):
                i, self.coord[ax] = divmod(i, self.shape[ax])

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def member(self) -> bool:
        return self.coord is not None


def _default_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device: Optional[torch.device] = None) -> Mesh:
    """A 1-D mesh of the first `n_devices` ranks (all by default) of the
    default process group."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    ranks = list(range(n))
    group = _new_group(ranks)
    member = dist.get_rank() < n
    return Mesh((axis,), (n,), ranks, {axis: group} if member else None,
                group, device or _default_device())


def make_mesh2d(n_data: int, n_space: int, axes=("data", "space"),
                device: Optional[torch.device] = None) -> Mesh:
    """2D (data x space) mesh for `dpsp_map_step`: rank d * n_space + s at
    (d, s); every rank creates every group, in the same order."""
    n = n_data * n_space
    if n > dist.get_world_size():
        raise ValueError(f"a {n_data} x {n_space} mesh in a world of "
                         f"{dist.get_world_size()}")
    ranks = list(range(n))
    group = _new_group(ranks)
    along_data = [_new_group([d * n_space + s for d in range(n_data)])
                  for s in range(n_space)]
    along_space = [_new_group([d * n_space + s for s in range(n_space)])
                   for d in range(n_data)]
    groups = None
    if dist.get_rank() < n:
        d, s = divmod(dist.get_rank(), n_space)
        groups = {axes[0]: along_data[s], axes[1]: along_space[d]}
    return Mesh(axes, (n_data, n_space), ranks, groups, group,
                device or _default_device())


def lc_submesh(mesh: Mesh, n_lc_devices: int = 2) -> Mesh:
    """Carve an LC slice off the mesh (the `lc.device: 1` equivalent): its
    last min(n_lc_devices, max(size - 1, 1)) ranks."""
    n_lc = min(n_lc_devices, max(len(mesh.ranks) - 1, 1))
    ranks = mesh.ranks[-n_lc:]
    group = _new_group(ranks)
    member = dist.get_rank() in ranks
    return Mesh(("lc",), (n_lc,), ranks, {"lc": group} if member else None,
                group, mesh.device)


# ---------------------------------------------------------------------------
# Collectives, counted
# ---------------------------------------------------------------------------

_counts = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def reset_collective_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def collective_counts() -> Dict[str, int]:
    """Collective calls of this process since the last reset, by kind."""
    return dict(_counts)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group`, in place; returns it."""
    _counts["all_reduce"] += 1
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `t` of `group`, concatenated along dim 0 in rank
    order."""
    _counts["all_gather"] += 1
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def broadcast_tensors(mesh: Mesh, tensors: Sequence[torch.Tensor]):
    """The mesh's first rank's `tensors` on every rank of the mesh, in one
    broadcast (packed as float64: exact for float32, bool and int32
    values). Returns new tensors of the inputs' shapes and dtypes."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors])
    _counts["broadcast"] += 1
    dist.broadcast(flat, src=mesh.ranks[0], group=mesh.group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off: off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return out


def broadcast_object(mesh: Mesh, obj):
    """The mesh's first rank's picklable `obj` on every rank of the mesh."""
    _counts["broadcast"] += 1
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.ranks[0], group=mesh.group)
    return box[0]


def replicated(mesh: Mesh, arrays: Sequence) -> bool:
    """Whether every rank of the mesh holds the same bits in `arrays`
    (numpy arrays or tensors): one all-gather of a digest a rank."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu().numpy() if torch.is_tensor(a) else a
        h.update(np.ascontiguousarray(a).tobytes())
    _counts["all_gather"] += 1
    digests = [None] * mesh.size
    dist.all_gather_object(digests, h.hexdigest(), group=mesh.group)
    return len(set(digests)) == 1


def reduce_shares(group, values: Sequence[torch.Tensor],
                  grads: Dict[str, torch.Tensor]):
    """One all-reduce (sum over `group`) of this rank's loss shares
    `values` (scalars) and of its gradient `grads`: the global loss terms
    and the exact global gradient. Returns (values (n,), grads)."""
    keys = list(grads)
    flat = torch.cat([torch.stack([v.detach().reshape(()) for v in values])]
                     + [grads[k].reshape(-1) for k in keys])
    all_reduce(flat, group)
    out, off = {}, len(values)
    for k in keys:
        n = grads[k].numel()
        out[k] = flat[off: off + n].reshape(grads[k].shape)
        off += n
    return flat[: len(values)], out


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over `group`. A
    replicated input (the pose) feeding each rank's loss share gets its
    exact gradient on every rank (JAX's `_pmean_grad`, with the sum that
    torch's share algebra needs)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _GlobalValue(torch.autograd.Function):
    """Forward: `value`, the all-reduced global loss (the same bits on
    every rank); backward: the cotangent to this rank's `share`."""

    @staticmethod
    def forward(ctx, share, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---------------------------------------------------------------------------
# Map steps
# ---------------------------------------------------------------------------


def _lr_tree(mcfg) -> Dict[str, float]:
    return {"xyz": mcfg.lr_xyz, "log_scales": mcfg.lr_scaling,
            "quats": mcfg.lr_rotation, "opacity_logits": mcfg.lr_opacity}


def _leaves(state: GaussianState) -> Dict[str, torch.Tensor]:
    return {k: v.detach().requires_grad_(True)
            for k, v in opt_subset(state.params).items()}


def _grads(share, leaves) -> Dict[str, torch.Tensor]:
    gs = torch.autograd.grad(share, [leaves[k] for k in OPT_KEYS])
    return dict(zip(OPT_KEYS, gs))


def _apply(state: GaussianState, adam, leaves, grads, mcfg):
    """Mask the global gradient by `alive`, take the Adam step; returns
    (state with the new params (its own Adam state untouched), adam',
    masked grads)."""
    m = state.alive.to(torch.float32)
    grads = {k: g * m.reshape((-1,) + (1,) * (g.dim() - 1))
             for k, g in grads.items()}
    new_opt, new_adam = optim.adam_update(
        adam, {k: v.detach() for k, v in leaves.items()}, grads,
        _lr_tree(mcfg))
    return (GaussianState(state.params.replace(**new_opt), state.alive,
                          state.adam), new_adam, grads)


def _tile_grid(cam: Camera, ts: int, n_split: int):
    """The tile grid split `n_split` ways: (tiles_x, tiles_y, n_tiles,
    s_pad, tile ids (s_pad,) int32 padded with tile 0, real-tile mask
    (s_pad,) float32)."""
    tiles_x = -(-cam.width // ts)
    tiles_y = -(-cam.height // ts)
    n_tiles = tiles_x * tiles_y
    s_pad = -(-n_tiles // n_split) * n_split
    tile_ids = torch.cat([torch.arange(n_tiles, dtype=torch.int32),
                          torch.zeros(s_pad - n_tiles, dtype=torch.int32)])
    tmask = (torch.arange(s_pad) < n_tiles).to(torch.float32)
    return tiles_x, tiles_y, n_tiles, s_pad, tile_ids, tmask


def _part(x: torch.Tensor, i: int, n: int, device) -> torch.Tensor:
    per = x.shape[0] // n
    return x[i * per: (i + 1) * per].to(device)


def _tile_view_share(leaves, state: GaussianState, color, depth, w2c, ids,
                     tm, cam: Camera, rcfg: RasterConfig, mcfg, tiles_x,
                     tiles_y, space_group, n_space: int):
    """This rank's share of one view's tile loss on its tiles `ids`:
    masked L1 colour and depth over the view's all-reduced mask count, and
    lambda (1 / n_space - its SSIM tile sum over the view's tile count), so
    that the shares over `space_group` sum to the view's loss."""
    from ..slam.tracker import _in_image_mask

    ts = rcfg.tile
    out = render_tiles(leaves["xyz"], leaves["quats"], leaves["log_scales"],
                       leaves["opacity_logits"], sh_to_rgb(state.params.f_dc),
                       w2c, ids, cam, rcfg, alive=state.alive)
    gt_c = gt_tiles(color, ids, ts, tiles_x, tiles_y)
    gt_d = gt_tiles(depth, ids, ts, tiles_x, tiles_y)
    valid = _in_image_mask(ids, ts, tiles_x, cam) & (tm[:, None, None] > 0)
    m = ((gt_d > 0) & ~torch.isnan(out.depth) & valid).to(torch.float32)
    den = all_reduce(torch.stack([m.sum(), tm.sum()]).detach(), space_group)
    color_l1 = (torch.abs(out.color - gt_c) * m[..., None]).sum() \
        / torch.clamp(den[0] * 3.0, min=1.0)
    depth_l1 = (torch.abs(out.depth - gt_d) * m).sum() \
        / torch.clamp(den[0], min=1.0)
    ssim_t = ssim_batched(torch.clamp(out.color, 0.0, 1.0), gt_c)
    ssim_share = (ssim_t * tm).sum() / torch.clamp(den[1], min=1.0)
    lam = mcfg.lambda_dssim
    return ((1.0 - lam) * color_l1 + lam * (1.0 / n_space - ssim_share)
            + depth_l1)


def _init_adam(state: GaussianState):
    return optim.adam_init(opt_subset(state.params))


def dp_map_step(mesh: Mesh, cam: Camera, rcfg: RasterConfig, mcfg):
    """Data-parallel mapping train step over `mesh`: rank d renders
    keyframe d of the batch against the replicated map.

    Returns (train_step, init_adam); train_step(state, adam, kf_colors,
    kf_depths, kf_w2cs) -> (state', adam', loss) takes keyframe arrays with
    a leading axis of the mesh's size (every rank holds all of them)."""
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]

    def train_step(state, adam, kf_colors, kf_depths, kf_w2cs):
        d = mesh.coord[axis]
        leaves = _leaves(state)
        color, depth = kf_colors[d], kf_depths[d]
        out = render(leaves["xyz"], leaves["quats"], leaves["log_scales"],
                     leaves["opacity_logits"], sh_to_rgb(state.params.f_dc),
                     kf_w2cs[d], cam, rcfg, alive=state.alive)
        mask = ((depth > 0) & ~torch.isnan(out.depth)).to(out.color.dtype)
        lam = mcfg.lambda_dssim
        closs = (1 - lam) * masked_l1(out.color, color, mask) \
            + lam * (1.0 - ssim(out.color, color))
        dloss = masked_l1(out.depth, depth, mask)
        total = closs + dloss + isotropic_loss(leaves["log_scales"],
                                               state.alive)
        # Each rank's loss is a whole view's: the mean of the ranks'
        # gradients is the exact one (summed, then divided, as JAX's pmean).
        loss, grads = reduce_shares(mesh.groups[axis], [total],
                                    _grads(total, leaves))
        state, adam, _ = _apply(state, adam, leaves,
                                {k: g / n_dev for k, g in grads.items()},
                                mcfg)
        return state, adam, loss[0] / n_dev

    return train_step, _init_adam


def sp_map_step(mesh: Mesh, cam: Camera, rcfg: RasterConfig, mcfg):
    """Spatially-parallel mapping train step: ONE view's tile grid split
    over the mesh.

    Every rank composites its slice of the tile grid (`render_tiles`)
    against the replicated map; the masked-loss numerators' denominators
    and the SSIM tile count are all-reduced first, so each rank's loss is
    its share of the view's, and the sum of the shares' gradients is the
    exact full-view gradient (the slices partition the image; pad tiles
    weigh 0). The isotropic regulariser enters each share over D. Loss
    semantics are the tile-subset mapping loss's: masked L1 colour and
    depth plus the per-tile windowed SSIM.

    Returns (train_step, init_adam, aux); train_step(state, adam, color,
    depth, w2c) -> (state', adam', loss, grads) takes ONE replicated view;
    aux: the padded `tile_ids` and the real-tile mask `tmask`."""
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    tiles_x, tiles_y, _, _, tile_ids_all, tmask_all = _tile_grid(
        cam, rcfg.tile, n_dev)

    def train_step(state, adam, color, depth, w2c):
        c = mesh.coord[axis]
        ids = _part(tile_ids_all, c, n_dev, color.device)
        tm = _part(tmask_all, c, n_dev, color.device)
        leaves = _leaves(state)
        share = _tile_view_share(leaves, state, color, depth, w2c, ids, tm,
                                 cam, rcfg, mcfg, tiles_x, tiles_y,
                                 mesh.groups[axis], n_dev) \
            + isotropic_loss(leaves["log_scales"], state.alive) / n_dev
        loss, grads = reduce_shares(mesh.groups[axis], [share],
                                    _grads(share, leaves))
        state, adam, grads = _apply(state, adam, leaves, grads, mcfg)
        return state, adam, loss[0], grads

    return train_step, _init_adam, dict(tile_ids=tile_ids_all,
                                        tmask=tmask_all)


def dpsp_map_step(mesh: Mesh, cam: Camera, rcfg: RasterConfig, mcfg):
    """Data x spatial parallelism over a 2D ("data", "space") mesh: rank
    (d, s) composites keyframe d's tile slice s. Each view's sums are
    all-reduced over `space`, the total is the views' mean over `data`, the
    regulariser enters over the mesh's size, and the shares' gradients sum
    over the whole mesh.

    Returns (train_step, init_adam, aux); train_step(state, adam, colors,
    depths, w2cs) takes keyframe arrays with a leading axis of size
    mesh.shape["data"]."""
    ax_d, ax_s = mesh.axis_names
    n_data, n_space = mesh.shape[ax_d], mesh.shape[ax_s]
    tiles_x, tiles_y, _, _, tile_ids_all, tmask_all = _tile_grid(
        cam, rcfg.tile, n_space)

    def train_step(state, adam, colors, depths, w2cs):
        d, s = mesh.coord[ax_d], mesh.coord[ax_s]
        ids = _part(tile_ids_all, s, n_space, colors.device)
        tm = _part(tmask_all, s, n_space, colors.device)
        leaves = _leaves(state)
        view = _tile_view_share(leaves, state, colors[d], depths[d], w2cs[d],
                                ids, tm, cam, rcfg, mcfg, tiles_x, tiles_y,
                                mesh.groups[ax_s], n_space)
        share = view / n_data + isotropic_loss(
            leaves["log_scales"], state.alive) / mesh.size
        loss, grads = reduce_shares(mesh.group, [share],
                                    _grads(share, leaves))
        state, adam, grads = _apply(state, adam, leaves, grads, mcfg)
        return state, adam, loss[0], grads

    return train_step, _init_adam, dict(tile_ids=tile_ids_all,
                                        tmask=tmask_all)


# ---------------------------------------------------------------------------
# Tracking
# ---------------------------------------------------------------------------


def sp_track_refine(mesh: Mesh, cam: Camera, rcfg: RasterConfig, tcfg):
    """Tile-split (sp) tracking refinement over the mesh.

    The frozen-sorted layout is built once, at last_w2c @ init_rel, on every
    rank; each rank renders its slice of the tile grid
    (`render_frozen_sorted_tiles`), the masked tracking-loss sums and
    counts are all-reduced, the outlier-depth median's 1/16 pixel
    subsample is all-gathered (pad tiles +inf, the median taken at the
    static count of real samples), and the pose's gradient is summed over
    the ranks before the optimiser step -- so the tracker's `_refine`
    (plateau LR, early stop, best iterate) runs unchanged and in lockstep
    on every rank. No tile subset and no polish; the renders go through K1
    and their backward through K2 (no pose-contraction route, whatever
    `pose_grad_kernel` says, as in the JAX package).

    Returns (refine, aux): refine(params, alive, init_rel, last_w2c,
    gt_color, gt_depth, exposure0, num_iters) -> (rel 4x4, exposure (2,),
    stats (5,) np.float32); aux: n_tiles, s_pad and `make_loss(params,
    alive, init_rel, last_w2c, gt_color, gt_depth)`, the loss the
    refinement optimises (loss_fn(pose dict) -> (total, (cl, dl)))."""
    from ..ops.rasterizer import (backend_of, freeze_sorted,
                                  render_frozen_sorted_tiles)
    from ..slam.tracker import _in_image_mask, _refine, _rel_matrix

    if backend_of(rcfg) != "sorted":
        raise ValueError(
            "sp_track_refine renders via the frozen-sorted tile path; "
            f"backend must be 'sorted' (or 'auto'), got {rcfg.backend!r}")
    if not tcfg.frozen_binning:
        raise ValueError("sp_track_refine requires tcfg.frozen_binning")

    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    ts = rcfg.tile
    tiles_x, tiles_y, n_tiles, s_pad, tile_ids_all, tmask_all = _tile_grid(
        cam, ts, n_dev)
    treal_all = tmask_all > 0
    # Every real tile gives its full ::4, ::4 subsample grid, zeros
    # included, as the single-device full-grid path's median does.
    m_sub = len(range(0, ts, 4))
    n_med = n_tiles * m_sub * m_sub
    w = tcfg.w_color_loss

    def sp_losses(out, expo, gt_c, gt_d, valid, treal, group):
        """tracker._losses_from_output with all-reduced sums; returns
        (colour loss, depth loss, this rank's share of the total)."""
        image = out.color
        if tcfg.enable_exposure:
            image = torch.clamp(torch.exp(expo[0]) * image + expo[1], 0.0,
                                1.0)
        depth_mask = (gt_d > 0.0) & valid
        tracking_mask = depth_mask
        if tcfg.filter_alpha:
            tracking_mask = tracking_mask & (out.alpha > tcfg.alpha_thre)
        if tcfg.filter_outlier_depth:
            depth_err = torch.abs(out.depth - gt_d) * depth_mask
            # Pads -> +inf: the middle of the n_med real samples is the
            # median of exactly the single-device full grid's samples.
            sub = torch.where(treal[:, None, None],
                              depth_err[..., ::4, ::4].detach(),
                              torch.tensor(float("inf"), device=gt_d.device))
            srt = torch.sort(all_gather(sub, group).reshape(-1)).values
            med = 0.5 * (srt[(n_med - 1) // 2] + srt[n_med // 2])
            tracking_mask = tracking_mask & ((depth_err < 50.0 * med)
                                             | ~(med > 0))
        color_px = (torch.abs(image - gt_c) + 1e-8) * valid[..., None]
        depth_px = (torch.abs(out.depth - gt_d) + 1e-8) * tracking_mask
        if tcfg.soft_alpha:
            a3 = out.alpha ** 3
            color_px = color_px * a3[..., None]
            depth_px = depth_px * a3
            if tcfg.mask_invalid_depth:
                color_px = color_px * tracking_mask[..., None]
        else:
            color_px = color_px * tracking_mask[..., None]
        csum, dsum = color_px.sum(), depth_px.sum()
        tot = all_reduce(torch.stack([
            (color_px > 0).sum().to(torch.float32),
            (depth_px > 0).sum().to(torch.float32),
            csum.detach(), dsum.detach()]), group)
        n_c, n_d = torch.clamp(tot[0], min=1.0), torch.clamp(tot[1], min=1.0)
        inf = torch.tensor(float("inf"), device=tot.device)
        cl = torch.where(tot[0] > 0, tot[2] / n_c, inf)
        dl = torch.where(tot[1] > 0, tot[3] / n_d, inf)
        return cl, dl, w * csum / n_c + (1 - w) * dsum / n_d

    def make_loss(params, alive, init_rel, last_w2c, gt_color, gt_depth):
        """The refinement's loss_fn(pose dict) -> (total, (cl, dl)) on the
        layout frozen at last_w2c @ init_rel."""
        dev = gt_color.device
        group = mesh.groups[axis]
        c = mesh.coord[axis]
        fs = freeze_sorted(params.xyz, params.quats, params.log_scales,
                           params.opacity_logits, sh_to_rgb(params.f_dc),
                           last_w2c @ init_rel, cam, rcfg, alive=alive)
        ids = _part(tile_ids_all, c, n_dev, dev)
        treal = _part(treal_all, c, n_dev, dev)
        gt_c = gt_tiles(gt_color, ids, ts, tiles_x, tiles_y)
        gt_d = gt_tiles(gt_depth, ids, ts, tiles_x, tiles_y)
        valid = _in_image_mask(ids, ts, tiles_x, cam) & treal[:, None, None]

        def loss_fn(pose):
            vec = _SumGrad.apply(torch.cat([pose["quat"], pose["trans"],
                                            pose["exposure"]]), group)
            out = render_frozen_sorted_tiles(
                fs, last_w2c @ _rel_matrix(vec[:4], vec[4:7]), ids, cam,
                rcfg)
            cl, dl, share = sp_losses(out, vec[7:9], gt_c, gt_d, valid,
                                      treal, group)
            return _GlobalValue.apply(share, w * cl + (1 - w) * dl), (cl, dl)
        return loss_fn

    def refine(params, alive, init_rel, last_w2c, gt_color, gt_depth,
               exposure0, num_iters):
        loss_fn = make_loss(params, alive, init_rel, last_w2c, gt_color,
                            gt_depth)
        rel, exposure, stats, _ = _refine(loss_fn, init_rel, int(num_iters),
                                          exposure0, tcfg)
        return rel, exposure, stats

    return refine, dict(n_tiles=n_tiles, s_pad=s_pad, make_loss=make_loss)
