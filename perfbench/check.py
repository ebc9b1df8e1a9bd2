"""What decides `correct`: the timed path's outputs against the plain
reference (`reference.py`), each number beside its limit.

  - `frame_color_mae`, `frame_depth_mae_m`: the reader's frames that the
    window's loop received (a sample drawn from the seed) against the
    reference's decode of the same files (the layout's `read_reference`,
    `layouts.LAYOUTS`):
    the largest over the sample of the mean absolute difference (colour in
    [0, 1], depth in metres).
  - `render_mae`, `render_depth_rel`, `grad_rel`: the map and the pose the
    window reached (the estimate of the last frame the window mapped, the
    view the map was last optimised on), rendered through
    the program's rasterizer entry at the map camera (K1) and
    differentiated (K2) under a cotangent drawn from the seed, against the
    reference's render and autograd: the largest over r, g, b, alpha of
    the mean absolute difference; the mean absolute depth difference over
    the mean reference depth; the largest over the parameter leaves of
    |g_program - g_reference| / |g_reference| (L2 norms).
  - `ate_cm`: RMSE of the estimated camera centres of every completed
    frame against the generated trajectory, both taken relative to frame
    0 (the reader's pose convention; frames 0 and 1 take its pose).

Every limit is an upper one.
"""
from __future__ import annotations

import math

import numpy as np
import torch


PARAM_NAMES = ("xyz", "quats", "log_scales", "opacity_logits", "f_dc")


def passes(value, limit) -> bool:
    return value is not None and math.isfinite(value) and value <= limit


def frames(kept: dict, paths, cam: dict, read, device) -> dict:
    """`kept`: frame id -> (colour, depth) as the loop received them;
    `paths`: each frame's files; `read(colour, depth, cam)`: the stream
    layout's reference reader."""
    col = dep = 0.0
    for i, (c, d) in kept.items():
        rc, rd = read(paths[i][0], paths[i][1], cam)
        rc = torch.as_tensor(rc, device=device)
        rd = torch.as_tensor(rd, device=device)
        col = max(col, float((c.double() - rc.double()).abs().mean()))
        dep = max(dep, float((d.double() - rd.double()).abs().mean()))
    return {"frame_color_mae": col, "frame_depth_mae_m": dep}


def cotangent(h: int, w: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed % (2 ** 63) + 7)
    return torch.as_tensor(rng.standard_normal((h, w, 5)).astype(np.float32),
                           device=device)


def render_numbers(prog: dict, ref: tuple) -> dict:
    """`prog`: the program's color / depth / alpha / grads; `ref`: the
    reference's (color, depth, alpha, grads)."""
    rc, rd, ra, rg = ref
    mae = max(float((prog["color"][..., k].double() - rc[..., k]).abs().mean())
              for k in range(3))
    mae = max(mae, float((prog["alpha"].double() - ra).abs().mean()))
    depth_rel = float((prog["depth"].double() - rd).abs().mean()
                      / rd.abs().mean().clamp(min=1e-12))
    grad = 0.0
    for k in PARAM_NAMES:
        g_ref = rg[k].double()
        g_prog = prog["grads"][k].double()
        grad = max(grad, float((g_prog - g_ref).norm()
                               / g_ref.norm().clamp(min=1e-30)))
    return {"render_mae": mae, "render_depth_rel": depth_rel,
            "grad_rel": grad}


def ate_cm(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE (cm) of the camera centres, each trajectory relative to its
    frame 0."""
    e = np.linalg.inv(est[0]) @ est
    g = np.linalg.inv(gt[0]) @ gt
    d = e[:, :3, 3] - g[:, :3, 3]
    return float(100.0 * np.sqrt((d * d).sum(-1).mean()))

