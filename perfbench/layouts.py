"""Frozen writers of the readers' on-disk layouts, and the lens
pre-distortion of the generated frames.

  - `write_png`: 8-bit RGB or 16-bit gray PNG, a filter type a row (0-4)
    and zlib level 6;
  - `write_tum_frame` / `write_tum_text`: rgb/<t>.png, depth/<t>.png
    (16-bit at `depth_scale`), rgb.txt, depth.txt and groundtruth.txt
    (`t tx ty tz qx qy qz qw`), the depth and ground truth stamped
    `depth_dt` / `gt_dt` after the colour, and an orphan rgb / depth pair
    with no ground truth after the last frame, as recorded TUM sequences
    have;
  - `write_replica_frame` / `write_replica_text`: results/frame%06d.jpg
    (Pillow, `quality`), results/depth%06d.png (16-bit at `depth_scale`)
    and traj.txt (flattened 4x4 c2w rows);
  - `predistort_maps`: where a capture through the lens samples the clean
    image, so that undistorting it gives the clean image back.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .reference import distort_points

PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _filter_rows(img: np.ndarray, ftypes: np.ndarray) -> np.ndarray:
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    pred = np.choose(ftypes[:, None, None].astype(np.intp), preds)
    return ((x - pred) & 255).astype(np.uint8)


def write_png(path, img: np.ndarray, filters=None) -> None:
    """(H, W, 3) uint8 RGB or (H, W) uint16 gray; `filters`: one filter
    type for every row, or one a row; None writes every row unfiltered."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype = 16, 0
        pix = img.astype(">u2").view(np.uint8).reshape(*img.shape, 2)
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[-1] == 3:
        depth, ctype = 8, 2
        pix = img
    else:
        raise ValueError(f"{path}: cannot write dtype {img.dtype} shape "
                         f"{img.shape}")
    h, w = img.shape[:2]
    if filters is None:
        ftypes = np.zeros(h, np.uint8)
        rows = pix.reshape(h, -1)
    else:
        ftypes = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
        rows = _filter_rows(pix, ftypes).reshape(h, -1)
    raw = np.concatenate([ftypes[:, None], rows], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(PNG_SIG
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def depth_u16(depth: np.ndarray, scale: float) -> np.ndarray:
    return np.clip(np.asarray(depth, np.float64) * scale + 0.5, 0,
                   65535).astype(np.uint16)


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = (0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s)
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = ((R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s)
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = ((R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
             (R[1, 2] + R[2, 1]) / s)
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = ((R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, 0.25 * s)
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def tum_stamp(i: int, t0: float, fps: float) -> float:
    return t0 + i / fps


def write_tum_text(root, n: int, poses, layout: dict) -> None:
    """rgb.txt, depth.txt and groundtruth.txt of `n` frames (and the orphan
    pair's lines) in `layout`'s stamps."""
    t0, fps = float(layout["t0"]), float(layout["fps"])
    ddt, gdt = float(layout["depth_dt"]), float(layout["gt_dt"])
    rgb, dep, gt = ["# rgb"], ["# depth"], ["# gt"]
    stamps = [tum_stamp(i, t0, fps) for i in range(n)]
    if layout.get("orphan_after") is not None:
        stamps.append(tum_stamp(n - 1, t0, fps)
                      + float(layout["orphan_after"]))
    for k, t in enumerate(stamps):
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{t + ddt:.6f} depth/{t + ddt:.6f}.png")
        if k < n:
            q = rotmat_to_quat(np.asarray(poses[k], np.float64)[:3, :3])
            tr = np.asarray(poses[k], np.float64)[:3, 3]
            gt.append(f"{t + gdt:.6f} {tr[0]:.9f} {tr[1]:.9f} {tr[2]:.9f} "
                      f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}")
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep),
                        ("groundtruth.txt", gt)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def tum_paths(root, i: int, n: int, layout: dict):
    """(colour path, depth path) of frame i (i == n: the orphan pair)."""
    t0, fps = float(layout["t0"]), float(layout["fps"])
    t = tum_stamp(i, t0, fps) if i < n else \
        tum_stamp(n - 1, t0, fps) + float(layout["orphan_after"])
    ddt = float(layout["depth_dt"])
    return (os.path.join(root, "rgb", f"{t:.6f}.png"),
            os.path.join(root, "depth", f"{t + ddt:.6f}.png"))


def write_tum_frame(root, i: int, n: int, rgb, depth, layout: dict) -> None:
    c, d = tum_paths(root, i, n, layout)
    h = rgb.shape[0]
    write_png(c, rgb, np.arange(h) % 5 if layout.get("paeth_mix") else None)
    write_png(d, depth_u16(depth, float(layout["depth_scale"])))


def replica_paths(root, i: int):
    res = os.path.join(root, "results")
    return (os.path.join(res, f"frame{i:06d}.jpg"),
            os.path.join(res, f"depth{i:06d}.png"))


def write_replica_frame(root, i: int, rgb, depth, layout: dict) -> None:
    from PIL import Image

    c, d = replica_paths(root, i)
    Image.fromarray(np.asarray(rgb, np.uint8)).save(
        c, quality=int(layout["quality"]))
    write_png(d, depth_u16(depth, float(layout["depth_scale"])))


def write_replica_text(root, poses) -> None:
    np.savetxt(os.path.join(root, "traj.txt"),
               np.stack([np.asarray(p, np.float64).reshape(-1)
                         for p in poses]))


def predistort_maps(cam: dict, dist, iters: int = 25):
    """For each pixel x_d of the capture, the clean-image pixel it shows:
    undistort(x_d), by fixed-point iteration of the forward model. Returns
    (map_u, map_v) float32 (H, W)."""
    u, v = np.meshgrid(np.arange(cam["W"], dtype=np.float64),
                       np.arange(cam["H"], dtype=np.float64))
    xyd = np.stack([(u - cam["cx"]) / cam["fx"],
                    (v - cam["cy"]) / cam["fy"]], -1)
    xy = xyd.copy()
    for _ in range(iters):
        xy = xy + (xyd - distort_points(xy, np.asarray(dist, np.float64)))
    return ((cam["fx"] * xy[..., 0] + cam["cx"]).astype(np.float32),
            (cam["fy"] * xy[..., 1] + cam["cy"]).astype(np.float32))
