"""The benchmark's frozen copy of the synthetic_hard scene and its orbit.

A ray-cast textured room (an axis-aligned box room, an inner sphere and an
inner box with procedural textures), seen from `orbit_poses`' circle of
0.5 m radius with +-0.6 rad of yaw, with the sensor model of the SLAM
package's `synthetic_hard` dataset: depth noise sigma = depth_noise *
depth^2, random depth dropout, and a smooth exposure drift over the
sequence. The noise of frame i comes from numpy, `default_rng(seed *
100003 + i)`, so the same seed gives the same frames.

Frozen: later changes to the program's scene do not move the benchmark's
frames. `perfbench/tests/test_perfbench_frozen.py` holds it equal to the
program's scene at a small size.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

HALF = 2.0
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


def orbit_poses(n_frames: int, orbit_speed: float) -> List[np.ndarray]:
    """c2w (float64) of a smooth orbit around the room centre,
    `orbit_speed` turns a frame."""
    poses = []
    for i in range(n_frames):
        t = i * orbit_speed
        ang = 0.6 * math.sin(2 * math.pi * t)
        c2w = np.eye(4)
        c2w[:3, :3] = np.array([[math.cos(ang), 0, math.sin(ang)],
                                [0, 1, 0],
                                [-math.sin(ang), 0, math.cos(ang)]])
        c2w[:3, 3] = [0.5 * math.sin(2 * math.pi * t),
                      0.1 * math.sin(4 * math.pi * t),
                      0.5 * math.cos(2 * math.pi * t)]
        poses.append(c2w)
    return poses


def _face_tex(face_id: int, a, b):
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
def raycast(c2w: torch.Tensor, fx: float, fy: float, cx: float, cy: float,
            width: int, height: int):
    """Colour (H, W, 3) in [0, 1] and z-depth (H, W) of the room seen from
    c2w (4, 4) float32; rays that hit nothing keep depth 1e9."""
    dev = c2w.device
    H, W = height, width
    u = (torch.arange(W, dtype=torch.float32, device=dev) - cx) / fx
    v = (torch.arange(H, dtype=torch.float32, device=dev) - cy) / fy
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

    for axis in range(3):
        for si, sign in enumerate((-1.0, 1.0)):
            denom = d[..., axis]
            t = (sign * HALF - o[axis]) / torch.where(
                torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9), denom)
            p = o + t[..., None] * d
            oa, ob = [i for i in range(3) if i != axis]
            inside = (torch.abs(p[..., oa]) <= HALF + 1e-3) & (
                torch.abs(p[..., ob]) <= HALF + 1e-3)
            take(t, _face_tex(axis * 2 + si, p[..., oa], p[..., ob]), inside)

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


def render_frame(idx: int, pose: np.ndarray, cam: dict, n_frames: int,
                 seed: int, noise: dict, device) -> tuple:
    """Frame `idx` of a sequence of `n_frames`: (uint8 colour (H, W, 3),
    float32 depth (H, W) in metres, stored through float16 as the program's
    synthetic dataset stores it), host arrays. `cam`: fx, fy, cx, cy, W, H;
    `noise`: depth_noise, depth_dropout, exposure_amp."""
    c2w = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    color, depth = raycast(c2w, cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                           cam["W"], cam["H"])
    amp = float(noise["exposure_amp"])
    t = idx / max(n_frames, 1)
    gain = 1.0 + amp * math.sin(2 * math.pi * t * 2.0)
    bias = 0.5 * amp * math.sin(2 * math.pi * t * 3.0 + 1.0)
    color = torch.clamp(color * gain + bias, 0.0, 1.0)
    rgb8 = torch.clamp(color * 255.0 + 0.5, 0, 255).to(torch.uint8)
    depth = depth.to(torch.float16).cpu().numpy().astype(np.float32)
    rng = np.random.default_rng(seed * 100003 + idx)
    depth = depth + rng.normal(scale=float(noise["depth_noise"]),
                               size=depth.shape).astype(np.float32) \
        * depth * depth
    drop = rng.uniform(size=depth.shape) < float(noise["depth_dropout"])
    depth = np.where(drop, 0.0, np.maximum(depth, 0.0)).astype(np.float32)
    return (rgb8.cpu().numpy(),
            depth.astype(np.float16).astype(np.float32))
