"""Pinhole camera model and (back)projection (port of eags_slam_tpu.core.camera)."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class Camera(NamedTuple):
    """Static pinhole intrinsics (Python floats/ints, hashable)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @staticmethod
    def from_intrinsics(K, width: int, height: int) -> "Camera":
        K = np.asarray(K)
        return Camera(float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                      float(K[1, 2]), int(width), int(height))

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    def scaled(self, level: int) -> "Camera":
        """Intrinsics at pyramid level `level` (half-pixel convention
        cx' = (cx + 0.5) / 2^lvl - 0.5)."""
        s = 1.0 / (2**level)
        return Camera(
            self.fx * s,
            self.fy * s,
            (self.cx + 0.5) * s - 0.5,
            (self.cy + 0.5) * s - 0.5,
            self.width >> level,
            self.height >> level,
        )

    def crop(self, edge: int) -> "Camera":
        return Camera(
            self.fx, self.fy, self.cx - edge, self.cy - edge,
            self.width - 2 * edge, self.height - 2 * edge,
        )


def project(cam: Camera, pts_cam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., 3) -> pixel coords (..., 2) and depth (...,)."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.clamp(z, min=1e-8)
    u = pts_cam[..., 0] * inv_z * cam.fx + cam.cx
    v = pts_cam[..., 1] * inv_z * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1), z


def pixel_rays(cam: Camera, device=None, dtype=torch.float32) -> torch.Tensor:
    """(H, W, 3) unit-depth rays ((u-cx)/fx, (v-cy)/fy, 1)."""
    u = torch.arange(cam.width, dtype=dtype, device=device)
    v = torch.arange(cam.height, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    x = (uu - cam.cx) / cam.fx
    y = (vv - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def backproject(cam: Camera, depth: torch.Tensor) -> torch.Tensor:
    """Depth (H, W) -> camera-frame points (H, W, 3)."""
    return pixel_rays(cam, depth.device, depth.dtype) * depth[..., None]


def w2c_from_c2w(c2w: torch.Tensor) -> torch.Tensor:
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    Rt = R.transpose(-1, -2)
    w2c = torch.zeros_like(c2w)
    w2c[..., :3, :3] = Rt
    w2c[..., :3, 3] = -torch.einsum("...ij,...j->...i", Rt, t)
    w2c[..., 3, 3] = 1.0
    return w2c
