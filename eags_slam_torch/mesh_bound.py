"""Mesh F1 ceiling: ground-truth depth fused at ground-truth poses (port of
scripts/mesh_bound.py).

The bench's mesh F1 scores a TSDF fusion of rendered depth at estimated
poses. This entry fuses the sensor depth itself at the exact poses through
the same grid, fusion, surface nets, cleaning and metric code the
evaluator runs (`ops/tsdf.py`, `evaluation/mesh.py`), so its F1 is the
ceiling of that pipeline on the scene: what is left below it is map and
pose error.

    python -m eags_slam_torch.mesh_bound           # 1200x680, on the card
    python -m eags_slam_torch.mesh_bound --small   # 240x136, on the CPU

The scene is bench.py's synthetic_hard orbit (1.5/72 a frame, depth noise
0.002, dropout 0.003, exposure 0.08); every `--kf_every`-th of `--frames`
frames is fused. The GT surface is 20,000 points of each fused frame's
depth (the evaluator's sampling). For each voxel size and each of two grid
bounds (the trajectory's box widened by 6 m at most 384 a side, and the
box of every third fused frame's depth points at most 512 a side) one JSON
line: {"mode": "gt_depth_gt_pose", "voxel", "bounds", "dims",
"n_vertices", "n_faces", accuracy, completion, precision, recall, f1
(over 200,000 mesh samples at tau 1 cm), "wall_s"}.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import load_config
from .core.camera import Camera
from .evaluation.mesh import (clean_mesh, mesh_metrics, sample_surface,
                              surface_nets)
from .ops.tsdf import (grid_bounds_from_depths, grid_bounds_from_trajectory,
                       integrate, make_grid)
from .synthetic_hard import SyntheticHard

BOUNDS = ("trajectory", "depths")
GT_PER_FRAME = 20000     # GT surface points a fused frame
SAMPLES = 200000         # mesh samples scored


def scene_config(small: bool, frames: int) -> Dict:
    """The bench scene (or its 240x136 cut), as the script builds it."""
    config = load_config(str(Path(__file__).resolve().parents[1] / "configs"
                             / "synthetic" / "base.yaml"))
    if small:
        config["cam"].update({"H": 136, "W": 240, "fx": 120.0, "fy": 120.0,
                              "cx": 119.5, "cy": 67.5})
    else:
        config["cam"].update({"H": 680, "W": 1200, "fx": 600.0, "fy": 600.0,
                              "cx": 599.5, "cy": 339.5})
    config["data"].update({
        "dataset_name": "synthetic_hard", "n_frames": frames,
        "orbit_speed": 1.5 / 72.0, "depth_noise": 0.002,
        "depth_dropout": 0.003, "exposure_amp": 0.08})
    return config


def gt_surface(depths: List[np.ndarray], poses: List[np.ndarray],
               cam: Camera, per_frame: int = GT_PER_FRAME, seed: int = 0):
    """`per_frame` points of each frame's depth in the world frame, drawn
    from one numpy stream in frame order (the evaluator's sampling)."""
    rng = np.random.default_rng(seed)
    pts = []
    for depth, c2w in zip(depths, poses):
        h, w = depth.shape
        v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        m = depth > 0
        z = depth[m]
        pc = np.stack([(u[m] - cam.cx) / cam.fx * z,
                       (v[m] - cam.cy) / cam.fy * z, z], -1)
        sel = rng.choice(len(pc), min(per_frame, len(pc)), replace=False)
        c2w = np.asarray(c2w)
        pts.append(pc[sel] @ c2w[:3, :3].T + c2w[:3, 3])
    return np.concatenate(pts)


def bound_line(colors, depths, poses, surface: np.ndarray, cam: Camera,
               voxel: float, bounds_kind: str, device,
               n_samples: int = SAMPLES) -> Dict:
    """Fuse the frames (colour, depth tensors on `device`; host depth and
    poses for the bounds) into a grid of `bounds_kind`, mesh it and score
    it against `surface`: one JSON line of the script."""
    t0 = time.time()
    depths_h = [d.cpu().numpy() if torch.is_tensor(d) else d for d in depths]
    if bounds_kind == "trajectory":
        origin, dims = grid_bounds_from_trajectory(
            np.stack([np.asarray(p) for p in poses]), 6.0, voxel,
            max_dim=384)
    else:
        origin, dims = grid_bounds_from_depths(
            depths_h[::3], poses[::3], cam, voxel, max_dim=512)
    grid = make_grid(origin, dims, voxel, 4 * voxel, device=device)
    for color, depth, c2w in zip(colors, depths, poses):
        w2c = torch.as_tensor(np.linalg.inv(np.asarray(c2w)),
                              dtype=torch.float32, device=device)
        integrate(grid, torch.as_tensor(color, device=device),
                  torch.as_tensor(depth, device=device), w2c, cam)
    verts, faces = surface_nets(grid.sdf, grid.weight, grid.origin,
                                grid.voxel)
    del grid
    verts, faces = clean_mesh(verts, faces)
    line = {"mode": "gt_depth_gt_pose", "voxel": round(voxel, 5),
            "bounds": bounds_kind, "dims": [int(d) for d in dims],
            "n_vertices": int(len(verts)), "n_faces": int(len(faces))}
    if len(faces):
        pred = sample_surface(verts, faces, n_samples)
        line.update({k: round(float(v), 4) for k, v in mesh_metrics(
            pred, surface, tau=0.01, device=device).items()})
    line["wall_s"] = round(time.time() - t0, 1)
    return line


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="the 240x136 scene on the CPU")
    ap.add_argument("--frames", type=int, default=72)
    ap.add_argument("--kf_every", type=int, default=5)
    ap.add_argument("--voxels", type=float, nargs="*",
                    default=[0.02, 5.0 / 512.0])
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.small else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mesh_bound: no CUDA device (--small runs on the "
                         "CPU)")
    ds = SyntheticHard(scene_config(args.small, args.frames), device=device)
    cam = ds.camera
    kf_ids = list(range(0, len(ds), args.kf_every))
    print(f"# scene {cam.width}x{cam.height}, {len(ds)} frames, "
          f"{len(kf_ids)} keyframes", file=sys.stderr)
    frames = [ds.frame(i) for i in kf_ids]          # device colour, depth
    poses = [np.asarray(ds.poses[i], np.float64) for i in kf_ids]
    surface = gt_surface([d.cpu().numpy() for _, d in frames], poses, cam,
                         GT_PER_FRAME)
    lines = []
    try:
        for voxel in args.voxels:
            for kind in BOUNDS:
                line = bound_line([c for c, _ in frames],
                                  [d for _, d in frames], poses, surface,
                                  cam, voxel, kind, device, SAMPLES)
                print(json.dumps(line), flush=True)
                lines.append(line)
    finally:
        ds.close()
    return lines


if __name__ == "__main__":
    main()
