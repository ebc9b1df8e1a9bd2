"""Spherical-harmonics degree-0 colour conversion (port of
eags_slam_tpu.core.sh; SLAM-time mapping uses degree 0 only)."""
from __future__ import annotations

import torch

C0 = 0.28209479177387814


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * C0 + 0.5
