"""Per-frame edge pyramid (port of eags_slam_tpu.vo.pyramid).

Per level: the gray pyrDown / hole-aware depth subsample, Canny edges with
the low-density edge fill-in from the finer level, and a fixed-capacity
cloud of 3D edge points: a deterministic hash-priority subset of the edge
pixels with valid depth, backprojected with the level's intrinsics.
Keyframe promotion adds the distance transform and its gradients per level
(`make_keyframe`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.camera import Camera
from ..ops.image import (canny, depth_pyr_down, dt_with_gradients, pyr_down,
                         rgb_to_gray)

_HASH = 2654435761
_U32 = 0xFFFFFFFF


class PyramidLevel(NamedTuple):
    gray: torch.Tensor       # (H, W) f32 [0, 255]
    depth: torch.Tensor      # (H, W) f32 metres (0 = hole)
    edges: torch.Tensor      # (H, W) bool
    pts: torch.Tensor        # (P, 3) camera-frame 3D edge points (padded)
    pts_valid: torch.Tensor  # (P,) bool
    edge_count: torch.Tensor  # () int64


class KeyframeLevel(NamedTuple):
    gx: torch.Tensor
    gy: torch.Tensor
    dt: torch.Tensor


class FramePyramid(NamedTuple):
    levels: tuple            # of PyramidLevel, finest first
    timestamp: float


def _build_level(gray, depth, finer_edges: Optional[torch.Tensor],
                 cam: Camera, max_pts: int, low: float, high: float,
                 depth_min: float, depth_max: float,
                 fill_percentage: float = 0.3) -> PyramidLevel:
    edges = canny(gray, low, high)
    if finer_edges is not None:
        # Edge fill-in: when this level kept too few edges against the
        # finer level's (2x2-OR downsampled), take the union.
        h2, w2 = edges.shape
        fe_ds = finer_edges[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2) \
            .any(3).any(1)
        need_fill = edges.sum() < fill_percentage * fe_ds.sum()
        edges = torch.where(need_fill, edges | fe_ds, edges)
    valid_depth = (depth > depth_min) & (depth < depth_max)
    flat = (edges & valid_depth).reshape(-1)
    edge_count = flat.sum()
    # Hash priority (uint32 arithmetic in int64): the smallest-priority
    # edge pixels win; non-edge pixels all tie at 0xFFFFFFFF, so the sort
    # must be stable like jnp.argsort.
    idx = torch.arange(flat.shape[0], device=flat.device, dtype=torch.int64)
    prio = torch.where(flat, (idx * _HASH) & _U32,
                       torch.full_like(idx, _U32))
    sel = torch.sort(prio, stable=True).indices[:max_pts]
    sel_valid = flat[sel]
    v = sel // cam.width
    u = sel % cam.width
    z = depth.reshape(-1)[sel]
    x = (u.to(torch.float32) - cam.cx) / cam.fx * z
    y = (v.to(torch.float32) - cam.cy) / cam.fy * z
    return PyramidLevel(gray, depth, edges, torch.stack([x, y, z], -1),
                        sel_valid, edge_count)


def _build_all_levels(gray, depth, cam: Camera, n_levels: int, max_pts: int,
                      low: float, high: float, depth_min: float,
                      depth_max: float) -> tuple:
    levels = []
    finer_edges = None
    for lvl in range(n_levels):
        level = _build_level(gray, depth, finer_edges, cam.scaled(lvl),
                             max(max_pts >> lvl, 256), low, high, depth_min,
                             depth_max)
        levels.append(level)
        finer_edges = level.edges
        if lvl + 1 < n_levels:
            gray, depth = pyr_down(gray), depth_pyr_down(depth)
    return tuple(levels)


@torch.no_grad()
def build_pyramid(rgb_u8: torch.Tensor, depth: torch.Tensor, cam: Camera,
                  n_levels: int, max_pts: int, low: float, high: float,
                  depth_min: float, depth_max: float,
                  timestamp: float = 0.0) -> FramePyramid:
    """rgb_u8 (H, W, 3) uint8 and depth (H, W) f32 on the VO's device."""
    gray = rgb_to_gray(rgb_u8.to(torch.float32))
    levels = _build_all_levels(gray, depth.to(torch.float32), cam, n_levels,
                               max_pts, low, high, depth_min, depth_max)
    return FramePyramid(levels, timestamp)


@torch.no_grad()
def make_keyframe(pyr: FramePyramid, window: int = 32) -> tuple:
    """Distance transform + gradient structure per level (`makeKeyframe`)."""
    return tuple(KeyframeLevel(*dt_with_gradients(lv.edges, window))
                 for lv in pyr.levels)
