"""Spherical harmonics up to degree 3 (port of eags_slam_tpu.core.sh).

SLAM-time mapping uses degree 0 only (`rgb_to_sh`, `sh_to_rgb`); the global
refinement of the merged map (`evaluation/merged_map.py`) raises the degree
to 3 (`eval_sh`, `sh_colors`). Plain tensor functions, differentiable by
autograd.
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * C0 + 0.5


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH colours before the +0.5 shift of 3DGS (callers add it).

    sh: (..., (deg+1)^2, 3) coefficients (more are ignored); dirs: (..., 3)
    unit view directions. Returns (..., 3)."""
    result = C0 * sh[..., 0, :]
    if deg > 0:
        x, y, z = dirs[..., :1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - C1 * y * sh[..., 1, :] + C1 * z * sh[..., 2, :]
                  - C1 * x * sh[..., 3, :])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + C2[0] * xy * sh[..., 4, :]
                      + C2[1] * yz * sh[..., 5, :]
                      + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                      + C2[3] * xz * sh[..., 7, :]
                      + C2[4] * (xx - yy) * sh[..., 8, :])
            if deg > 2:
                result = (
                    result
                    + C3[0] * y * (3 * xx - yy) * sh[..., 9, :]
                    + C3[1] * xy * z * sh[..., 10, :]
                    + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11, :]
                    + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12, :]
                    + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13, :]
                    + C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + C3[6] * x * (xx - 3 * yy) * sh[..., 15, :])
    return result


def sh_colors(deg: int, f_dc: torch.Tensor, f_rest: torch.Tensor,
              means3d: torch.Tensor, cam_center: torch.Tensor
              ) -> torch.Tensor:
    """Per-gaussian RGB seen from `cam_center` (3,), clamped at 0 as in
    3DGS. f_dc (N, 3), f_rest (N, 15, 3), means3d (N, 3)."""
    if deg == 0:
        rgb = C0 * f_dc + 0.5
    else:
        sh = torch.cat([f_dc[:, None, :], f_rest], dim=1)
        d = means3d - cam_center[None, :]
        d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                            min=1e-8)
        rgb = eval_sh(deg, sh, d) + 0.5
    return torch.clamp(rgb, min=0.0)
