"""Frame sources for the port (port of `BaseDataset` + `Synthetic` of
eags_slam_tpu.datasets; the ray-cast `synthetic_hard` scene is in
`synthetic_hard.py`).

`Synthetic` is the procedural gaussian-splat room with exact GT poses: the
scene and trajectory come from numpy with the config's seed (the same
numbers as the JAX package), and the frames are rendered on the config's
device with this package's sorted renderer (the K1 kernel on the card). The
frames are quantised exactly as the JAX dataset quantises them (uint8 colour,
float16 depth of alpha > 0.5 pixels); that quantisation is part of the data.

Frames are generated on the device once at start-up, so the SLAM loop never
uploads a frame.

`ArrayDataset` wraps frames that already exist as arrays (e.g. another
implementation's frames, for parity tests).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .core.camera import Camera


def room_scene(seed: int, n_per_wall: int) -> Dict[str, np.ndarray]:
    """The synthetic room: a box whose six walls carry jittered coloured
    gaussians (numpy, same draws as the JAX dataset for the same seed)."""
    rng = np.random.default_rng(seed)
    half = 2.0
    walls, colors = [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            p = rng.uniform(-half, half, (n_per_wall, 3)).astype(np.float32)
            p[:, axis] = sign * half + rng.normal(0, 0.01, n_per_wall)
            walls.append(p)
            base = rng.uniform(0.2, 0.9, 3).astype(np.float32)
            c = np.clip(base + rng.normal(0, 0.18, (n_per_wall, 3)),
                        0.05, 1.0).astype(np.float32)
            colors.append(c)
    xyz = np.concatenate(walls)
    rgb = np.concatenate(colors)
    n = xyz.shape[0]
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(
        means=xyz, quats=q,
        log_scales=np.log(rng.uniform(0.06, 0.16, (n, 3))).astype(np.float32),
        opac=rng.uniform(2.0, 6.0, (n, 1)).astype(np.float32),
        colors=rgb,
    )


def orbit_poses(n_frames: int, orbit_speed: float) -> List[np.ndarray]:
    """Smooth orbit around the room centre (c2w, float64)."""
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


class BaseDataset:
    """Camera, GT poses and device-resident frames."""

    def __init__(self, config: Dict, device="cpu"):
        cam = config["cam"]
        self.device = torch.device(device)
        self.crop_edge = int(cam.get("crop_edge", 0))
        if self.crop_edge:
            raise NotImplementedError(
                "cam.crop_edge: the port has no real-data readers yet "
                "(ROADMAP Queue 1 item 13)")
        self.full_camera = Camera(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                                  cam["W"], cam["H"])
        self.camera = self.full_camera
        self.frame_limit = int(config.get("frame_limit", -1))
        self.poses: List[np.ndarray] = []
        self.timestamps: List[float] = []
        self._frames: Dict[int, tuple] = {}

    def __len__(self) -> int:
        n = len(self.poses)
        return n if self.frame_limit < 0 else min(n, self.frame_limit)

    def frame(self, idx: int):
        """(color (H, W, 3) f32 in [0, 1], depth (H, W) f32 metres), both on
        the dataset's device."""
        rgb8, d16 = self._frames[idx]
        return rgb8.to(torch.float32) / 255.0, d16.to(torch.float32)

    def frame_u8(self, idx: int):
        """(color (H, W, 3) uint8, depth (H, W) f32 metres) on the
        dataset's device: the VO's input."""
        rgb8, d16 = self._frames[idx]
        return rgb8, d16.to(torch.float32)

    def __getitem__(self, idx: int):
        color, depth = self.frame(idx)
        return (idx, color.cpu().numpy(), depth.cpu().numpy(),
                np.asarray(self.poses[idx], np.float64))

    def close(self):
        self._frames.clear()


class Synthetic(BaseDataset):
    """Procedural gaussian-splat room rendered with the port's renderer."""

    def __init__(self, config: Dict, device="cpu"):
        super().__init__(config, device)
        from .ops.rasterizer import RasterConfig, render

        d = config["data"]
        self.n_frames = int(d.get("n_frames", 40))
        scene = room_scene(int(config.get("seed", 0)),
                           int(d.get("gaussians_per_wall", 700)))
        self.n_scene = scene["means"].shape[0]
        self.poses = orbit_poses(self.n_frames,
                                 float(d.get("orbit_speed", 1.0 / 300.0)))
        self.timestamps = [i / 30.0 for i in range(self.n_frames)]
        cfg = RasterConfig(tile=16, dup_side=4)
        t = {k: torch.as_tensor(v, device=self.device)
             for k, v in scene.items()}
        with torch.no_grad():
            for i in range(len(self)):
                w2c = torch.as_tensor(np.linalg.inv(self.poses[i]),
                                      dtype=torch.float32, device=self.device)
                out = render(t["means"], t["quats"], t["log_scales"],
                             t["opac"], t["colors"], w2c, self.full_camera,
                             cfg)
                rgb8 = torch.clamp(out.color * 255.0 + 0.5, 0, 255).to(
                    torch.uint8)
                depth = torch.where(
                    out.alpha > 0.5,
                    out.depth / torch.clamp(out.alpha, min=1e-6),
                    torch.zeros_like(out.depth)).to(torch.float16)
                self._frames[i] = (rgb8, depth)

    def __len__(self):
        return self.n_frames if self.frame_limit < 0 else min(
            self.n_frames, self.frame_limit)


class ArrayDataset(BaseDataset):
    """Frames given as arrays: colour uint8 (N, H, W, 3), depth float
    (N, H, W), GT c2w poses (N, 4, 4)."""

    def __init__(self, config: Dict, colors_u8, depths, poses, device="cpu"):
        super().__init__(config, device)
        self.poses = [np.asarray(p, np.float64) for p in poses]
        self.timestamps = [i / 30.0 for i in range(len(self.poses))]
        for i in range(len(self)):
            self._frames[i] = (
                torch.as_tensor(np.asarray(colors_u8[i], np.uint8),
                                device=self.device),
                torch.as_tensor(np.asarray(depths[i], np.float32),
                                device=self.device))


def get_dataset(name: str):
    name = name.lower()
    if name == "synthetic":
        return Synthetic
    if name == "synthetic_hard":
        from .synthetic_hard import SyntheticHard

        return SyntheticHard
    raise NotImplementedError(
        f"dataset {name!r}: the real-data readers are not ported yet "
        "(ROADMAP Queue 1 item 13)")
