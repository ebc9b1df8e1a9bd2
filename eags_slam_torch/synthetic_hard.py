"""Model-mismatch synthetic scene: a ray-cast textured room (port of
eags_slam_tpu.synthetic_hard).

  - geometry: an axis-aligned box room, an inner sphere and an inner box,
    ray cast per pixel (not splatted), so a gaussian map can only
    approximate the frames;
  - appearance: procedural multi-frequency textures with hard checker
    edges;
  - sensor model: depth noise sigma = depth_noise * depth^2, random depth
    dropout, and a smooth per-frame exposure drift (gain / bias) baked into
    the observed colour.

GT poses are exact. The noise comes from numpy, `default_rng(seed * 100003
+ idx)` per frame, the same draws as the JAX dataset. Frames are ray cast on
the dataset's device at start-up and kept there as uint8 colour and float16
depth, the form in which the SLAM loop reads them.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .core.camera import Camera
from .datasets import BaseDataset, orbit_poses

HALF = 2.0                                # room half-size (m)
SPH_C = (1.25, -0.45, 0.85)
SPH_R = 0.45
BOX_LO = (-1.5, -0.9, -1.25)
BOX_HI = (-0.7, 0.35, -0.55)
EPS = 1e-4
BIG = 1e9
FACE_BASE = ((0.75, 0.35, 0.30), (0.30, 0.60, 0.75), (0.40, 0.70, 0.35),
             (0.75, 0.65, 0.30), (0.55, 0.40, 0.70), (0.70, 0.50, 0.45))
FACE_ACCENT = ((0.20, 0.55, 0.60), (0.70, 0.40, 0.25), (0.65, 0.30, 0.55),
               (0.25, 0.35, 0.65), (0.35, 0.65, 0.35), (0.30, 0.55, 0.30))


def _face_tex(face_id: int, a, b):
    """Procedural texture on local face coords (a, b) in [-2, 2]."""
    base = a.new_tensor(FACE_BASE[face_id])
    accent = a.new_tensor(FACE_ACCENT[face_id])
    checker = torch.remainder(torch.floor(a / 0.35) + torch.floor(b / 0.35),
                              2.0)
    stripes = 0.5 + 0.5 * torch.sin(9.0 * a + 5.0 * b)
    fine = 0.5 + 0.5 * torch.sin(23.0 * a) * torch.sin(19.0 * b)
    w = (0.45 + 0.35 * checker + 0.10 * fine)[..., None]
    return torch.clamp(base * w + accent * (0.28 * stripes
                                            + 0.08 * fine)[..., None],
                       0.0, 1.0)


@torch.no_grad()
def raycast(c2w: torch.Tensor, cam: Camera):
    """Colour (H, W, 3) in [0, 1] and z-depth (H, W) of the room seen from
    c2w (4, 4) float32; rays that hit nothing keep depth 1e9."""
    dev = c2w.device
    H, W = cam.height, cam.width
    u = (torch.arange(W, dtype=torch.float32, device=dev) - cam.cx) / cam.fx
    v = (torch.arange(H, dtype=torch.float32, device=dev) - cam.cy) / cam.fy
    # Camera rays with z = 1: the ray parameter t IS the z-depth.
    dirs_cam = torch.stack([u[None, :].expand(H, W), v[:, None].expand(H, W),
                            torch.ones((H, W), device=dev)], -1)
    R = c2w[:3, :3]
    o = c2w[:3, 3]
    d = dirs_cam @ R.T
    best_t = torch.full((H, W), BIG, device=dev)
    best_c = torch.zeros((H, W, 3), device=dev)

    def take(t, col, cond):
        nonlocal best_t, best_c
        hit = cond & (t > EPS) & (t < best_t)
        best_c = torch.where(hit[..., None], col, best_c)
        best_t = torch.where(hit, t, best_t)

    for axis in range(3):                  # room walls: the nearest wins
        for si, sign in enumerate((-1.0, 1.0)):
            denom = d[..., axis]
            t = (sign * HALF - o[axis]) / torch.where(
                torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9), denom)
            p = o + t[..., None] * d
            oa, ob = [i for i in range(3) if i != axis]
            inside = (torch.abs(p[..., oa]) <= HALF + 1e-3) & (
                torch.abs(p[..., ob]) <= HALF + 1e-3)
            take(t, _face_tex(axis * 2 + si, p[..., oa], p[..., ob]), inside)

    # Sphere.
    sph_c = d.new_tensor(SPH_C)
    oc = o - sph_c
    a_q = (d * d).sum(-1)
    b_q = 2.0 * (d * oc).sum(-1)
    c_q = (oc * oc).sum() - SPH_R * SPH_R
    disc = b_q * b_q - 4.0 * a_q * c_q
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_s = (-b_q - sq) / (2.0 * a_q)
    n = o + t_s[..., None] * d - sph_c
    ang1 = torch.atan2(n[..., 1], n[..., 0])
    ang2 = torch.arccos(torch.clamp(n[..., 2] / SPH_R, -1.0, 1.0))
    band = 0.5 + 0.5 * torch.sin(6.0 * ang1) * torch.sin(8.0 * ang2)
    swirl = torch.remainder(torch.floor(ang1 / 0.6) + torch.floor(ang2 / 0.5),
                            2.0)
    col_s = torch.clamp(torch.stack([0.85 * band + 0.1, 0.3 + 0.5 * swirl,
                                     0.9 - 0.6 * band], -1), 0.0, 1.0)
    take(t_s, col_s, disc > 0.0)

    # Inner box (slab method).
    lo, hi = d.new_tensor(BOX_LO), d.new_tensor(BOX_HI)
    d_safe = torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
    t1 = (lo - o) / d_safe
    t2 = (hi - o) / d_safe
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    hit_b = (tmax > tmin) & (tmin > EPS)
    p = o + tmin[..., None] * d
    rel = (p - 0.5 * (lo + hi)) / (0.5 * (hi - lo))
    fid = torch.argmax(torch.abs(rel), -1)
    lu = torch.gather(p, -1, ((fid + 1) % 3)[..., None])[..., 0]
    lv = torch.gather(p, -1, ((fid + 2) % 3)[..., None])[..., 0]
    grid = torch.remainder(torch.floor(lu / 0.12) + torch.floor(lv / 0.12),
                           2.0)
    col_b = torch.clamp(torch.stack([0.15 + 0.75 * grid, 0.8 - 0.5 * grid,
                                     0.25 + 0.3 * torch.sin(17.0 * lu)], -1),
                        0.0, 1.0)
    take(tmin, col_b, hit_b)
    return best_c, best_t


class SyntheticHard(BaseDataset):
    """Ray-cast textured room with sensor noise and exposure drift. Config
    keys under `data`: n_frames, orbit_speed, depth_noise (sigma =
    depth_noise * depth^2, default 0.002), depth_dropout (default 0.003),
    exposure_amp (default 0.08)."""

    def __init__(self, config: Dict, device="cpu"):
        super().__init__(config, device)
        d = config["data"]
        self.n_frames = int(d.get("n_frames", 40))
        self.depth_noise = float(d.get("depth_noise", 0.002))
        self.depth_dropout = float(d.get("depth_dropout", 0.003))
        self.exposure_amp = float(d.get("exposure_amp", 0.08))
        self._seed = int(config.get("seed", 0))
        self.poses = orbit_poses(self.n_frames,
                                 float(d.get("orbit_speed", 1.0 / 300.0)))
        self.timestamps = [i / 30.0 for i in range(self.n_frames)]
        for i in range(len(self)):
            self._frames[i] = self._render(i)

    def _render(self, idx: int):
        c2w = torch.as_tensor(np.asarray(self.poses[idx], np.float32),
                              device=self.device)
        color, depth = raycast(c2w, self.full_camera)
        # Exposure drift baked into the observed colour.
        t = idx / max(self.n_frames, 1)
        gain = 1.0 + self.exposure_amp * math.sin(2 * math.pi * t * 2.0)
        bias = 0.5 * self.exposure_amp * math.sin(2 * math.pi * t * 3.0 + 1.0)
        color = torch.clamp(color * gain + bias, 0.0, 1.0)
        rgb8 = torch.clamp(color * 255.0 + 0.5, 0, 255).to(torch.uint8)
        depth = depth.to(torch.float16).cpu().numpy().astype(np.float32)
        # Sensor noise from numpy (deterministic per frame).
        rng = np.random.default_rng(self._seed * 100003 + idx)
        depth = depth + rng.normal(scale=self.depth_noise,
                                   size=depth.shape).astype(np.float32) \
            * depth * depth
        drop = rng.uniform(size=depth.shape) < self.depth_dropout
        depth = np.where(drop, 0.0, np.maximum(depth, 0.0)).astype(np.float32)
        return rgb8, torch.as_tensor(depth.astype(np.float16),
                                     device=self.device)

    def __len__(self):
        return self.n_frames if self.frame_limit < 0 else min(
            self.n_frames, self.frame_limit)
