"""Visualisation helpers (port of eags_slam_tpu.utils.vis): a depth
colouriser, a TUM trajectory reader, and matplotlib figures written to
disk (matplotlib is imported inside the plot functions, which swallow any
failure: they are debugging aids on no path of the pipeline).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def colorize_depth(depth: np.ndarray, d_min: Optional[float] = None,
                   d_max: Optional[float] = None) -> np.ndarray:
    """Depth (H, W) -> uint8 RGB on a jet-like ramp; pixels without depth
    are black."""
    d = np.asarray(depth, np.float32)
    valid = d > 0
    if d_min is None:
        d_min = float(d[valid].min()) if valid.any() else 0.0
    if d_max is None:
        d_max = float(d[valid].max()) if valid.any() else 1.0
    t = np.clip((d - d_min) / max(d_max - d_min, 1e-6), 0, 1)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    rgb = np.stack([r, g, b], -1)
    rgb[~valid] = 0
    return (rgb * 255).astype(np.uint8)


def read_tum_trajectory(path: str) -> np.ndarray:
    """A TUM-format trajectory file (`t tx ty tz qx qy qz qw` rows, `#`
    comments) -> (N, 4, 4) c2w."""
    from ..datasets import TUM_RGBD

    poses = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            poses.append(TUM_RGBD._tum_pose(line.split()[1:8]))
    return np.stack(poses) if poses else np.zeros((0, 4, 4))


def save_trajectory_plot(path: str, est_c2ws: np.ndarray,
                         gt_c2ws: Optional[np.ndarray] = None):
    """Top-down (x, z) trajectory plot, the estimate and optionally the
    ground truth."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 6))
        e = np.asarray(est_c2ws)[:, :3, 3]
        ax.plot(e[:, 0], e[:, 2], label="estimate")
        if gt_c2ws is not None:
            g = np.asarray(gt_c2ws)[:, :3, 3]
            ax.plot(g[:, 0], g[:, 2], "--", label="ground truth")
        ax.set_aspect("equal")
        ax.legend()
        fig.savefig(path, dpi=100)
        plt.close(fig)
    except Exception:
        pass


def save_registration_vis(path: str, src_pts: np.ndarray, tgt_pts: np.ndarray,
                          transform: np.ndarray):
    """Point clouds of a registration before and after `transform` moves
    the target, seen from above."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        moved = tgt_pts @ np.asarray(transform)[:3, :3].T + transform[:3, 3]
        fig, axes = plt.subplots(1, 2, figsize=(10, 5))
        for ax, tgt, title in ((axes[0], tgt_pts, "before"),
                               (axes[1], moved, "after")):
            ax.scatter(src_pts[:, 0], src_pts[:, 2], s=0.5, label="source")
            ax.scatter(tgt[:, 0], tgt[:, 2], s=0.5, label="target")
            ax.set_title(title)
            ax.set_aspect("equal")
        axes[0].legend()
        fig.savefig(path, dpi=100)
        plt.close(fig)
    except Exception:
        pass
