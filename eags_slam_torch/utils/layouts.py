"""Write a sequence of frames in the on-disk layout of a reader in
`datasets.py` (the smoke run and the tests feed the readers this way):

  - `write_tum`: rgb/<t>.png, depth/<t>.png (16-bit), rgb.txt, depth.txt and
    groundtruth.txt (`t tx ty tz qx qy qz qw`), with optional stamp offsets
    for depth and ground truth and an orphan pair that has no ground truth;
  - `write_replica`: results/frame%06d.jpg (Pillow), results/depth%06d.png
    and traj.txt (flattened 4x4 c2w rows);
  - `write_scannet`: rgb/<i>.png, depth/<i>.TIFF (float32 metres) and
    gt_pose.txt in TUM format.

Colour is (N, H, W, 3) uint8, depth (N, H, W) float metres, poses (N, 4, 4)
camera-to-world.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np

from ..slam.submap import _rotmat_to_quat_np
from .image_io import write_png, write_tiff


def _tum_row(t: float, c2w: np.ndarray) -> str:
    q = _rotmat_to_quat_np(np.asarray(c2w, np.float64)[:3, :3])   # wxyz
    tr = np.asarray(c2w, np.float64)[:3, 3]
    return (f"{t:.6f} {tr[0]:.9f} {tr[1]:.9f} {tr[2]:.9f} "
            f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}")


def _depth_u16(depth: np.ndarray, scale: float) -> np.ndarray:
    return np.clip(np.asarray(depth, np.float64) * scale + 0.5, 0,
                   65535).astype(np.uint16)


def write_tum(root, colors, depths, poses, t0: float = 100.0,
              fps: float = 30.0, depth_scale: float = 5000.0,
              depth_dt: float = 0.0, gt_dt: float = 0.0,
              filters: Union[None, int, Sequence[int]] = None,
              orphan_after: Optional[float] = None) -> None:
    """The TUM RGB-D layout. Frame i is stamped t0 + i / fps; its depth
    `depth_dt` and its ground truth `gt_dt` seconds later. `filters`: the
    PNG filter of every colour row (image_io.write_png). `orphan_after`:
    also write an rgb / depth pair that many seconds after the last frame,
    with no ground truth near it."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = ["# rgb"], ["# depth"], ["# gt"]

    def pair(t, rgb, depth):
        name_c = f"rgb/{t:.6f}.png"
        name_d = f"depth/{t + depth_dt:.6f}.png"
        write_png(os.path.join(root, name_c), rgb, filters)
        write_png(os.path.join(root, name_d), _depth_u16(depth, depth_scale))
        rgb_lines.append(f"{t:.6f} {name_c}")
        depth_lines.append(f"{t + depth_dt:.6f} {name_d}")

    n = len(colors)
    for i in range(n):
        t = t0 + i / fps
        pair(t, colors[i], depths[i])
        gt_lines.append(_tum_row(t + gt_dt, poses[i]))
    if orphan_after is not None:
        pair(t0 + (n - 1) / fps + orphan_after,
             np.zeros_like(np.asarray(colors[0])),
             np.zeros_like(np.asarray(depths[0])))
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def write_replica(root, colors, depths, poses, depth_scale: float = 6553.5,
                  quality: int = 95) -> None:
    """The Replica layout; the JPEG colour needs Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{root}: writing Replica's JPEG colour needs "
                          "Pillow, which is not installed") from e
    res = os.path.join(root, "results")
    os.makedirs(res, exist_ok=True)
    for i in range(len(colors)):
        Image.fromarray(np.asarray(colors[i], np.uint8)).save(
            os.path.join(res, f"frame{i:06d}.jpg"), quality=quality)
        write_png(os.path.join(res, f"depth{i:06d}.png"),
                  _depth_u16(depths[i], depth_scale))
    np.savetxt(os.path.join(root, "traj.txt"),
               np.stack([np.asarray(p, np.float64).reshape(-1)
                         for p in poses]))


def write_scannet(root, colors, depths, poses) -> None:
    """The preprocessed ScanNet layout (scripts/scannet_preprocess.py)."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    for i in range(len(colors)):
        write_png(os.path.join(root, "rgb", f"{i}.png"), colors[i])
        write_tiff(os.path.join(root, "depth", f"{i}.TIFF"),
                   np.asarray(depths[i], np.float32))
    with open(os.path.join(root, "gt_pose.txt"), "w") as f:
        f.write("\n".join(_tum_row(float(i), p)
                          for i, p in enumerate(poses)) + "\n")
