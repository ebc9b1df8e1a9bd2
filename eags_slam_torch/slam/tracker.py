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

Every refine iteration is one function, `_iteration`: the loss, its
gradient and the amsgrad step on the flat pose. On the sorted backend the
loss runs the frozen render in steps (`_frozen_sorted_loss`), handing out
its kernel calls. On the card, `Tracker.track` hands the refinement a
`RefineGraph`, which captures a phase's second iteration between those
calls as CUDA graphs and replays them for the rest, the kernels launched
in between as in the eager loop; the first iteration runs eagerly as the
warm-up. The other callers of `_refine` (the loop closer's localisation,
`sp_track_refine`) and every CPU run run `_iteration` eagerly.
"""
from __future__ import annotations

import inspect
import itertools
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from ..core.se3 import quat_to_rotmat, rotmat_to_quat
from ..core.sh import sh_to_rgb
from ..ops.rasterizer import (RasterConfig, backend_of, freeze_binning,
                              freeze_sorted, frozen_bwd, frozen_fwd,
                              frozen_image, frozen_pose_grad,
                              frozen_pose_rows, frozen_rows, frozen_tile_ids,
                              gt_tiles, homogeneous_row, kernel_rows, render,
                              render_frozen, small_matmul, tile_sums)
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
    return torch.cat([top, homogeneous_row(R.dtype, R.device)], dim=0)


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
    color_loss = torch.where(n_color > 0, color_px.sum()
                             / torch.clamp(n_color, min=1), float("inf"))
    depth_loss = torch.where(n_depth > 0, depth_px.sum()
                             / torch.clamp(n_depth, min=1), float("inf"))
    return color_loss, depth_loss


def _make_loss_fn(params: GaussianParams, alive, colors, init_rel, last_w2c,
                  gt_color, gt_depth, cam: Camera, rcfg: RasterConfig,
                  tcfg: TrackerConfig, subset=None):
    """Refinement loss over the frozen layout of the backend: the
    centre-sorted one (tile subset when `subset` = (tile_ids, gt_c_tiles,
    gt_d_tiles, in_img) is given; `_frozen_sorted_loss`) or the entry
    binning; the full render every iteration with `frozen_binning` off or on
    the `jnp` backend. Called on the pose's leaves (LEAVES): (total,
    (colour, depth)), or on the sorted backend the generator of
    `_frozen_sorted_loss`."""
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
    if subset is None:
        return _frozen_sorted_loss(fs, last_w2c, None, gt_color, gt_depth,
                                   None, cam, rcfg, tcfg)
    return _frozen_sorted_loss(fs, last_w2c, *subset, cam, rcfg, tcfg)


def _frozen_sorted_loss(fs, last_w2c, tile_ids, gt_color, gt_depth, valid,
                        cam: Camera, rcfg: RasterConfig, tcfg: TrackerConfig):
    """The loss of `render_frozen_sorted_tiles` (of `render_frozen_sorted`
    with `tile_ids` None; their `_pose` forms with `pose_grad_kernel`) in
    steps (`rasterizer.frozen_rows` ...): called on the pose's leaves, a
    generator that yields each kernel call as (function, arguments), takes
    its result back, and returns (total, colour, depth, the gradient in
    LEAVES' flat order), autograd's through those renders."""
    w = tcfg.w_color_loss
    ids = frozen_tile_ids(tile_ids, cam, rcfg, fs.e3d.device)
    seg_start = fs.seg_start.to(torch.int32).contiguous()
    seg_cnt = fs.seg_cnt.to(torch.int32).contiguous()

    def loss(leaf):
        if tcfg.pose_grad_kernel:
            rows, jac = frozen_pose_rows(
                fs, torch.cat([leaf["quat"], leaf["trans"]]).detach(),
                last_w2c, cam, rcfg)
        else:
            rows = frozen_rows(fs, small_matmul(
                last_w2c, _rel_matrix(leaf["quat"], leaf["trans"])), cam,
                rcfg)
        k_rows = kernel_rows(rows, rcfg)
        out, cols = yield frozen_fwd, (k_rows, seg_start, seg_cnt, ids, cam,
                                       rcfg)
        out_l = out.detach().requires_grad_(True)
        image = frozen_image(out_l, None if tile_ids is None else ids, cam,
                             rcfg)
        cl, dl = _losses_from_output(image, leaf, gt_color, gt_depth, tcfg,
                                     valid=valid)
        total = w * cl + (1 - w) * dl
        dout, ge = torch.autograd.grad(total, [out_l, leaf["exposure"]],
                                       allow_unused=True)
        if ge is None:
            ge = torch.zeros_like(leaf["exposure"])
        dout = dout.contiguous()
        if tcfg.pose_grad_kernel:
            dpose = yield frozen_pose_grad, (k_rows, jac, ids, out, cols,
                                             dout, cam, rcfg)
            return total, cl, dl, torch.cat([dpose[:7], ge])
        grads = yield frozen_bwd, (k_rows, seg_start, ids, out, cols, dout,
                                   cam, rcfg)
        gq, gt = torch.autograd.grad(rows, [leaf["quat"], leaf["trans"]],
                                     grads)
        return total, cl, dl, torch.cat([gq, gt, ge])
    return loss


LEAVES = ("quat", "trans", "exposure")     # the pose's flat layout
_SIZES = (4, 3, 2)


def _split(x: torch.Tensor) -> dict:
    return dict(zip(LEAVES, torch.split(x, _SIZES)))


class _RefineState:
    """A refine phase's tensors, flat in LEAVES' order: the pose `x`; `old`,
    the pose the last iteration started from; `best`; the amsgrad Adam
    moments (mu, nu, vmax); the last iteration's losses `vals` (total,
    colour, depth); and the step's scalars `scal`, written by the host
    through `host` (pinned on the card) before each iteration."""

    def __init__(self, x: torch.Tensor, moments: torch.Tensor):
        self.x, self.old, self.best = x.clone(), x.clone(), x.clone()
        self.moments = moments.clone()
        self.vals = torch.zeros(3, dtype=x.dtype, device=x.device)
        self.scal = torch.zeros(2 + x.shape[0], dtype=torch.float32,
                                device=x.device)
        self.host = torch.zeros(2 + x.shape[0], dtype=torch.float32,
                                pin_memory=x.device.type == "cuda")

    def stage(self, step: int, lrs) -> None:
        """The scalars of Adam step `step` at the per-element learning rates
        `lrs`. The previous iteration's loss read waited for the last copy
        from `host`."""
        self.host.numpy()[:] = optim.staged_scalars(step, lrs)
        self.scal.copy_(self.host, non_blocking=True)


def _iteration(loss_fn, st: _RefineState):
    """One refine iteration, in place on `st`: the losses into `vals`, the
    pose it starts from into `old`, the next pose (amsgrad Adam, the
    quaternion renormalised) into `x`. A generator: it passes on the kernel
    calls of a `_frozen_sorted_loss` (a plain loss has none)."""
    leaf = {k: v.detach().requires_grad_(True)
            for k, v in _split(st.x).items()}
    res = loss_fn(leaf)
    if inspect.isgenerator(res):
        total, cl, dl, grad = yield from res
    else:
        total, (cl, dl) = res
        grads = torch.autograd.grad(total, [leaf[k] for k in LEAVES],
                                    allow_unused=True)
        grad = torch.cat([torch.zeros_like(leaf[k]) if g is None else g
                          for k, g in zip(LEAVES, grads)])
    with torch.no_grad():
        st.vals.copy_(torch.stack([total, cl, dl]))
        new, mu, nu, vmax = optim.adam_amsgrad_staged(st.x, grad,
                                                      *st.moments, st.scal)
        new[:4] = new[:4] / torch.clamp(torch.linalg.norm(new[:4]),
                                        min=1e-12)
        st.old.copy_(st.x)
        st.x.copy_(new)
        st.moments.copy_(torch.stack([mu, nu, vmax]))


def _run(iteration) -> None:
    """Run an `_iteration` eagerly, each kernel call as it comes."""
    try:
        call = next(iteration)
        while True:
            fn, args = call
            call = iteration.send(fn(*args))
    except StopIteration:
        pass


def _tensors(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


class RefineGraph:
    """`_iteration` as CUDA graphs with the compositing kernels left out: a
    refine phase's second iteration is captured (`capture`) and its later
    ones replay it (`replay`); the first runs eagerly as the warm-up. The
    work between two kernel calls is one graph, a segment; the kernels (K1,
    then K2 / K3 or K4) launch between the segments' replays as calls of
    their own, so each launch is counted and timed on the loop's stream as
    in the eager loop. The host keeps the loop's control flow (the loss
    read, the stops, the plateau, the best iterate). `Tracker.track` makes
    one for the card.

    Memory: the segments work in place on the phase's tensors (the frozen
    layout, the tile ids, the GT tiles and masks, `_RefineState`) and copy
    none of them. Every capture goes to one private pool, which holds what
    a segment leaves to a later one (the reprojected rows, the cotangent)
    and the segments' scratch, and which the next capture reuses (the
    previous graphs are reset once it is done: torch 2.11 fails an
    internal assert when a capture goes to a pool whose graphs were all
    reset). The kernels' outputs that a segment reads (K1's `out`, K2's
    gradient) are the capture's, and each replay copies its own into them.
    At the phase's end (`release`) the capture's tensors go, and the pool's
    reserved blocks, free, wait for the next capture: they are the graph's
    memory. The segments make no cuBLAS call (`small_matmul`), so the side
    stream needs no cuBLAS workspace.

    The capture runs on a side stream fenced both ways with the loop's
    stream, where the replays and the kernel calls run, in `thread_local`
    mode, so that the loop closer's thread may allocate and launch
    meanwhile; it calls `capture_begin` / `capture_end`, not
    `torch.cuda.graph`, which would synchronise the device and empty the
    caches at every capture. A capture that fails raises.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a refine graph needs a CUDA device, not "
                             f"{self.device}")
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(device=self.device)
        self.segments = []      # CUDAGraph: one before each call, one last
        self.calls = []         # (function, arguments, the capture's result)
        self.captures = self.replays = 0

    def capture(self, iteration) -> None:
        """Run the generator `iteration` (`_iteration`) once, capturing each
        segment and replaying it on the loop's stream, where the kernel
        calls run in between."""
        loop = torch.cuda.current_stream(self.device)
        old, self.segments, self.calls = self.segments, [], []
        sent, call = None, ()
        while call is not None:
            graph = torch.cuda.CUDAGraph()
            self.side.wait_stream(loop)
            with torch.cuda.stream(self.side):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    call = iteration.send(sent)
                except StopIteration:
                    call = None
                finally:
                    graph.capture_end()
            loop.wait_stream(self.side)
            graph.replay()
            self.segments.append(graph)
            if call is not None:
                fn, args = call
                sent = fn(*args)
                self.calls.append((fn, args, sent))
        for graph in old:
            graph.reset()
        self.captures += 1
        self.replays += 1       # the capture's iteration ran its graphs

    def replay(self) -> None:
        """The captured iteration again: each segment, and between them the
        kernel calls anew, an argument that an earlier call returned at the
        capture replaced by what that call returns now, which is copied
        where the segments read it."""
        done = []               # (the capture's result, this replay's)
        for graph, call in itertools.zip_longest(self.segments, self.calls):
            graph.replay()
            if call is None:
                break
            fn, args, kept = call
            got = fn(*(_now(a, done) for a in args))
            for k, g in zip(_tensors(kept), _tensors(got)):
                k.copy_(g)
            done.append((kept, got))
        self.replays += 1

    def release(self) -> None:
        """The phase is over: let go of the capture's tensors, so that only
        the pool's reserved blocks stay for the next capture."""
        self.calls = []

    def tally(self):
        """(captures, iterations run from the graphs) since the last
        call."""
        out = (self.captures, self.replays)
        self.captures = self.replays = 0
        return out


def _now(arg, done):
    """`arg`, or this replay's result in its place where it is a result of
    the capture's calls."""
    for kept, got in done:
        for k, g in zip(_tensors(kept), _tensors(got)):
            if arg is k:
                return g
    return arg


def _refine(loss_fn, init_rel, num_iters: int, exposure0,
            tcfg: TrackerConfig, warm=None, record=None, graph=None):
    """Pose refinement loop; returns (rel_best 4x4, exposure, stats (5,)
    np.float32 of STAT_NAMES, (Adam step, moments, plateau)). `warm`
    continues a previous phase's optimizer state. `record`: an (I, 12)
    array whose row `it` gets iteration it's DEBUG_ITER_NAMES values.
    `graph`: a `RefineGraph` that captures the second iteration and replays
    it for the others (not with `record`), the same iterations."""
    if graph is not None and record is not None:
        raise ValueError("a refine graph records no iterations")
    f32 = np.float32
    x = torch.cat([rotmat_to_quat(init_rel[:3, :3]), init_rel[:3, 3],
                   exposure0])
    if warm is None:
        step, plateau = 0, optim.plateau_init()
        moments = torch.zeros(3, x.shape[0], dtype=x.dtype, device=x.device)
    else:
        step, moments, plateau = warm
    st = _RefineState(x, moments)
    it, break_cnt, done = 0, 0, False
    prev_loss = f32(np.inf)
    best_loss, best_cl, best_dl, best_it = (f32(np.inf), f32(np.inf),
                                            f32(np.inf), 0)
    while it < num_iters and not done:
        with tracing.span("track.iter"):
            lr = plateau.lr_scale
            step += 1
            st.stage(step, [tcfg.cam_rot_lr * lr] * 4
                     + [tcfg.cam_trans_lr * lr] * 3
                     + [tcfg.exposure_lr * lr] * 2)
            if graph is None or it == 0:
                _run(_iteration(loss_fn, st))
            elif it == 1:
                with tracing.span("track.capture"):
                    graph.capture(_iteration(loss_fn, st))
            else:
                graph.replay()
            with tracing.span("track.readback"):
                vals = st.vals.cpu()
            total_f, cl_f, dl_f = (f32(v) for v in vals.numpy())

            with np.errstate(invalid="ignore"):   # inf - inf: not flat
                flat = abs(f32(total_f - prev_loss)) < tcfg.early_stop_thre
            break_cnt = break_cnt + 1 if flat else 0
            done = break_cnt > tcfg.early_stop_cnt
            if tcfg.stale_best_cnt > 0:
                done = done or (it - best_it > tcfg.stale_best_cnt)
            plateau = optim.plateau_update(plateau, total_f,
                                           tcfg.plateau_patience,
                                           tcfg.plateau_factor)
            if total_f < best_loss:
                st.best.copy_(st.old)
                best_cl, best_dl, best_it = cl_f, dl_f, it
            if record is not None:
                record[it, :5] = (total_f, best_cl, best_dl, lr, 1.0)
                record[it, 5:] = st.old[:7].cpu().numpy()
            best_loss = min(total_f, best_loss)
            prev_loss = total_f
            it += 1
    if graph is not None:
        graph.release()
    best = _split(st.best)
    rel = _rel_matrix(best["quat"], best["trans"])
    stats = np.array([best_loss, best_cl, best_dl, it, best_it], np.float32)
    return rel, best["exposure"], stats, (step, st.moments, plateau)


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
                cam: Camera, rcfg: RasterConfig, tcfg: TrackerConfig,
                graph: RefineGraph = None):
    """Candidate scoring (full-image renders), iteration doubling, then the
    refinement (tile subset + polish when configured, sorted backend only),
    each refine phase replayed as a CUDA graph by `graph` when given.
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
                                                exposure0, tcfg, graph=graph)
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
                                          warm=opt_state, graph=graph)
        stats = np.array([stats[0], stats[1], stats[2],
                          stats1[3] + stats[3], stats1[3] + stats[4]],
                         np.float32)
    else:
        rel, exposure, stats, _ = _refine(loss_fn, init_rel, num_iters,
                                          exposure0, tcfg, record=per_iter,
                                          graph=graph)
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
    and the per-iteration records of `debug_per_iter` are dropped. On the
    card, without `sp_track`, the refinement replays its iterations as a
    CUDA graph (`RefineGraph`, one a tracker, `_refine_graph`); each
    tracked frame counts its captures and replays (`track.graph_captures`,
    `track.graph_replays`) beside its iterations."""

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
        self._graph = None          # RefineGraph, made at the first use
        self._sp_refine = None
        if mesh is not None and sp_track:
            from ..parallel.mesh import sp_track_refine

            if tcfg.debug_per_iter:
                import warnings

                warnings.warn("sp_track drops debug_per_iter records "
                              "(per-iteration diagnostics stay on the "
                              "single-device path)")
            self._sp_refine, _ = sp_track_refine(mesh, cam, rcfg, tcfg)

    def _refine_graph(self, device):
        """The refinement's CUDA graph where the inputs allow one: a CUDA
        device, the sorted backend, frozen binning and no per-iteration
        record; else None, the eager loop."""
        if (device.type != "cuda" or backend_of(self.rcfg) != "sorted"
                or not self.tcfg.frozen_binning or self.tcfg.debug_per_iter):
            return None
        if self._graph is None:
            self._graph = RefineGraph(device)
        return self._graph

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
        graph = None
        if self._sp_refine is not None:
            rel, exposure, stats_vec, self.last_per_iter = \
                self._track_sp(*args)
        else:
            graph = self._refine_graph(dev)
            rel, exposure, stats_vec, self.last_per_iter = track_frame(
                *args, self.cam, self.rcfg, self.tcfg, graph=graph)
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
        captures, replays = (0, 0) if graph is None else graph.tally()
        tracing.count("track.graph_captures", captures)
        tracing.count("track.graph_replays", replays)
        w2c = last_w2c @ np.asarray(rel, np.float64)
        c2w = np.linalg.inv(w2c)
        c2w[3] = [0.0, 0.0, 0.0, 1.0]
        return c2w, exposure, stats

    def report(self) -> dict:
        return {"init_pose_cnt": dict(self.init_pose_cnt),
                "iters_avg": float(np.mean(self.iter_cnt))
                if self.iter_cnt else 0.0}
