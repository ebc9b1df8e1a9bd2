"""Global map merge and refinement (port of
eags_slam_tpu.evaluation.merged_map).

`merge_submaps` (host numpy, as in the JAX package) concatenates the
submaps' world-frame gaussians, keeps the first gaussian of each hashed
voxel and caps the count at 5M with `default_rng(0)`.

`refine_global_map` trains the merged map with full SH (the reference's
`refine_global_map`, evaluate_merged_map.py:54-158): a Python loop of
torch steps, each rendering one keyframe through the sorted rasterizer
(K1 forward, K2 backward on the card) and taking a masked Adam step. The
JAX package's chunking is kept: every `chunk_iters` iterations a batch of
`batch_frames` keyframes is drawn by `np.random.default_rng(seed)` (the
same draws as the JAX package) and the SH degree is re-read as
min(done // 1000, 3); each iteration picks its frame within the batch
with a `torch.Generator` seeded from `seed` (JAX's key stream cannot be
reproduced). The xyz learning rate is a log-lerp from 1e-4 to 1.6e-6 over
`iterations`; the other rates are fixed.

As in the JAX package, the prune test reads the chunk-local iteration
index: with `chunk_iters == prune_every` (500, the defaults) it never
fires, so the reference never prunes, and neither does this port.
The JAX package pads the map to a power-of-two capacity to reuse its
compiled programs; the port does not pad.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..core.camera import Camera
from ..core.gaussians import GaussianParams, state_from_numpy
from ..core.sh import sh_colors
from ..ops.losses import isotropic_loss, masked_l1, ssim
from ..ops.rasterizer import RasterConfig, render
from ..utils import optim

LAMBDA_DSSIM = 0.2   # the colour loss's SSIM weight


def merge_submaps(gaussian_dicts: List[Dict[str, np.ndarray]],
                  voxel: float = 0.005, max_points: int = 5_000_000
                  ) -> Dict[str, np.ndarray]:
    """Concatenate world-frame submap gaussians, voxel-dedup, cap count."""
    cat = {
        k: np.concatenate([g[k] for g in gaussian_dicts], axis=0)
        for k in gaussian_dicts[0]
    }
    xyz = cat["xyz"]
    key = np.floor(xyz / voxel).astype(np.int64)
    # Hash voxel ids; keep the first gaussian per voxel.
    h = key[:, 0] * 73856093 ^ key[:, 1] * 19349663 ^ key[:, 2] * 83492791
    _, keep = np.unique(h, return_index=True)
    if keep.shape[0] > max_points:
        keep = np.random.default_rng(0).choice(keep, max_points, replace=False)
    return {k: v[keep] for k, v in cat.items()}


def _lr(it: int, max_steps: int) -> Dict[str, float]:
    """Learning rates of iteration `it`: the 3DGS exponential xyz schedule
    (delay 0), fixed rates for the rest."""
    t = min(max(it / max_steps, 0.0), 1.0)
    xyz = math.exp((1.0 - t) * math.log(1e-4) + t * math.log(1.6e-6))
    return {"xyz": xyz, "f_dc": 2.5e-3, "f_rest": 2.5e-3 / 20.0,
            "log_scales": 5e-3, "quats": 1e-3, "opacity_logits": 0.05}


def refine_global_map(
    gauss: Dict[str, np.ndarray],
    frames: Callable,            # id -> (color, depth, c2w, exposure)
    frame_ids: List[int],
    cam: Camera,
    rcfg: RasterConfig,
    iterations: int = 30000,
    batch_frames: int = 8,
    chunk_iters: int = 500,
    max_sh_degree: int = 3,
    seed: int = 0,
    prune_every: int = 500,
    device="cuda",
) -> Tuple[GaussianParams, torch.Tensor]:
    """Full-SH refinement of a merged map (numpy dict in the layout of
    `core.gaussians.state_from_numpy`; an all-zero `f_rest` may be the
    (0, 15, 3) marker). `frames(id)` gives the keyframe's colour
    (H, W, 3) and depth (H, W) (tensors on `device` or numpy), its c2w
    (4, 4) and exposure (a, b). Returns (params, alive (N,) bool) on
    `device`."""
    dev = torch.device(device)
    params = state_from_numpy(gauss, dev).params
    n = params.xyz.shape[0]
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    gmask = alive.to(torch.float32)
    adam = optim.adam_init(params.as_dict())
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    done = 0
    while done < iterations:
        sh_degree = min(done // 1000, max_sh_degree)
        batch = rng.choice(len(frame_ids), min(batch_frames, len(frame_ids)),
                           replace=False)
        data = []
        for bi in batch:
            color, depth, c2w, exposure = frames(frame_ids[int(bi)])
            c2w = np.asarray(c2w)
            data.append((f32(color), f32(depth),
                         f32(np.linalg.inv(c2w).astype(np.float32)),
                         f32(c2w[:3, 3].astype(np.float32)),
                         f32(np.asarray(exposure, np.float32))))
        it = min(chunk_iters, iterations - done)
        for i in range(it):
            fi = int(torch.randint(len(batch), (1,), generator=gen))
            gt_c, gt_d, w2c, center, expo = data[fi]
            p = {k: v.detach().requires_grad_(True)
                 for k, v in params.as_dict().items()}
            rgb = sh_colors(sh_degree, p["f_dc"], p["f_rest"], p["xyz"],
                            center)
            out = render(p["xyz"], p["quats"], p["log_scales"],
                         p["opacity_logits"], rgb, w2c, cam, rcfg,
                         alive=alive)
            img = torch.clamp(out.color * torch.exp(expo[0]) + expo[1],
                              0.0, 1.0)
            mask = ((gt_d > 0) & ~torch.isnan(out.depth)).to(img.dtype)
            cl = (1 - LAMBDA_DSSIM) * masked_l1(img, gt_c, mask) \
                + LAMBDA_DSSIM * (1.0 - ssim(img, gt_c))
            dl = masked_l1(out.depth, gt_d, mask)
            loss = cl + dl + 10.0 * isotropic_loss(p["log_scales"], alive)
            keys = list(p)
            grads = torch.autograd.grad(loss, [p[k] for k in keys],
                                        allow_unused=True)
            grads = {k: (torch.zeros_like(p[k]) if g is None else
                         g * gmask.reshape((-1,) + (1,) * (g.dim() - 1)))
                     for k, g in zip(keys, grads)}
            new, adam = optim.adam_update(adam, params.as_dict(), grads,
                                          _lr(done + i, iterations))
            params = GaussianParams(**new)
            # The chunk-local index, as in the JAX package (see above).
            if i % prune_every == 0 and i != 0:
                alive = alive & ~(torch.sigmoid(
                    params.opacity_logits[:, 0]) < 0.005)
                gmask = alive.to(torch.float32)
        done += it
    return params, alive
