"""TSDF volume fusion on a dense voxel grid (port of eags_slam_tpu.ops.tsdf).

The evaluator fuses its rendered keyframes into this grid (the reference
uses Open3D's ScalableTSDFVolume at voxel 5/512 with a 4-voxel truncation)
and extracts the mesh with `evaluation.mesh.surface_nets`.

Integration is voxel-major: project every voxel centre into the frame,
take the nearest pixel's depth, truncate, and update a weighted running
average of sdf and colour, with the JAX package's arithmetic in its order.
The grid is updated in place, one slab along X at a time, so the
temporaries stay bounded: at `mesh_max_dim` 512 the grid itself holds
512^3 voxels (1 GB of sdf and weight, 1.5 GB of colour), and a slab's
temporaries about 1 GB.

`grid_bounds_from_trajectory` and `grid_bounds_from_depths` are host numpy,
as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.camera import Camera

SLAB_VOXELS = 1 << 24   # voxels a slab holds at most


class TSDFGrid(NamedTuple):
    sdf: torch.Tensor      # (X, Y, Z) f32 in [-1, 1]
    weight: torch.Tensor   # (X, Y, Z) f32
    color: torch.Tensor    # (X, Y, Z, 3) f32
    origin: torch.Tensor   # (3,) f32
    voxel: float
    trunc: float


def make_grid(origin, dims: Tuple[int, int, int], voxel: float,
              trunc: float, device="cuda") -> TSDFGrid:
    f32 = dict(dtype=torch.float32, device=device)
    dims = tuple(int(d) for d in dims)
    return TSDFGrid(
        sdf=torch.ones(dims, **f32),
        weight=torch.zeros(dims, **f32),
        color=torch.zeros(dims + (3,), **f32),
        origin=torch.as_tensor(np.asarray(origin, np.float32), **f32),
        voxel=float(voxel),
        trunc=float(trunc),
    )


def grid_bounds_from_trajectory(c2ws: np.ndarray, depth_max: float,
                                voxel: float, max_dim: int = 384):
    """Host helper: bounding box covering the trajectory +- depth range."""
    centers = np.asarray(c2ws)[:, :3, 3]
    lo = centers.min(0) - depth_max
    hi = centers.max(0) + depth_max
    dims = np.minimum(np.ceil((hi - lo) / voxel).astype(int) + 1, max_dim)
    # When the box exceeds the capped grid, centre the grid on the
    # trajectory instead of anchoring it at the box corner.
    span = dims * voxel
    mid = 0.5 * (lo + hi)
    lo = np.where(span < hi - lo, mid - 0.5 * span, lo)
    return lo.astype(np.float32), tuple(int(d) for d in dims)


def grid_bounds_from_depths(depths, c2ws, cam: Camera, voxel: float,
                            margin: float = 0.3, max_dim: int = 512,
                            stride: int = 8):
    """Host helper: tight scene box from backprojected sensor depths.

    A strided subsample of a few depth frames at their (estimated) poses
    bounds the observed surface; `margin` absorbs pose error plus the
    truncation band. Without any valid depth it falls back to the
    trajectory box."""
    pts = []
    for depth, c2w in zip(depths, c2ws):
        d = np.asarray(depth)[::stride, ::stride].astype(np.float64)
        H, W = d.shape
        v, u = np.meshgrid(
            np.arange(0, cam.height, stride, dtype=np.float64)[:H],
            np.arange(0, cam.width, stride, dtype=np.float64)[:W],
            indexing="ij",
        )
        m = d > 0
        if not m.any():
            continue
        z = d[m]
        x = (u[m] - cam.cx) / cam.fx * z
        y = (v[m] - cam.cy) / cam.fy * z
        pc = np.stack([x, y, z], -1)
        c2w = np.asarray(c2w, np.float64)
        pts.append(pc @ c2w[:3, :3].T + c2w[:3, 3])
    if not pts:
        return grid_bounds_from_trajectory(np.asarray(c2ws), 6.0, voxel,
                                           max_dim)
    allp = np.concatenate(pts)
    lo = allp.min(0) - margin
    hi = allp.max(0) + margin
    dims = np.minimum(np.ceil((hi - lo) / voxel).astype(int) + 1, max_dim)
    span = dims * voxel
    mid = 0.5 * (lo + hi)
    lo = np.where(span < hi - lo, mid - 0.5 * span, lo)
    return lo.astype(np.float32), tuple(int(d) for d in dims)


@torch.no_grad()
def integrate(grid: TSDFGrid, color_img, depth_img, w2c, cam: Camera
              ) -> TSDFGrid:
    """Fuse one RGB-D frame (colour (H, W, 3), depth (H, W), w2c (4, 4),
    all on the grid's device) into `grid`, in place; returns it."""
    X, Y, Z = grid.sdf.shape
    dev = grid.sdf.device
    f32 = dict(dtype=torch.float32, device=dev)
    w2c = w2c.to(**f32)
    R, t = w2c[:3, :3], w2c[:3, 3]
    trunc = torch.tensor(grid.trunc, **f32)
    py = (grid.origin[1] + grid.voxel * torch.arange(Y, **f32))[None, :, None]
    pz = (grid.origin[2] + grid.voxel * torch.arange(Z, **f32))[None, None, :]
    step = max(1, SLAB_VOXELS // (Y * Z))
    for x0 in range(0, X, step):
        x1 = min(X, x0 + step)
        px = (grid.origin[0] + grid.voxel
              * torch.arange(x0, x1, **f32))[:, None, None]
        # The voxel centres' camera coordinates, (x1 - x0, Y, Z) each.
        cx, cy, z = (px * R[i, 0] + py * R[i, 1] + pz * R[i, 2] + t[i]
                     for i in range(3))
        inv = torch.clamp(z, min=1e-6)
        u = torch.round(cx / inv * cam.fx + cam.cx)
        v = torch.round(cy / inv * cam.fy + cam.cy)
        del cx, cy, inv
        inb = ((z > 0.05) & (u >= 0) & (u < cam.width) & (v >= 0)
               & (v < cam.height))
        ui = torch.clamp(u, 0, cam.width - 1).long()
        vi = torch.clamp(v, 0, cam.height - 1).long()
        del u, v
        d = depth_img[vi, ui]
        c = color_img[vi, ui]
        del ui, vi
        sdf = (d - z) / trunc
        valid = inb & (d > 0) & (sdf > -1.0)
        del d, z, inb
        sdf = torch.clamp(sdf, -1.0, 1.0)
        w_new = valid.to(torch.float32)
        w_old = grid.weight[x0:x1]
        s_old = grid.sdf[x0:x1]
        c_old = grid.color[x0:x1]
        w_tot = w_old + w_new
        safe = torch.clamp(w_tot, min=1e-6)
        s_upd = torch.where(valid, (s_old * w_old + sdf * w_new) / safe,
                            s_old)
        c_upd = torch.where(valid[..., None],
                            (c_old * w_old[..., None] + c * w_new[..., None])
                            / safe[..., None], c_old)
        s_old.copy_(s_upd)
        c_old.copy_(c_upd)
        w_old.copy_(w_tot)
    return grid
