"""Frozen writers of the readers' on-disk layouts, the table that names
each layout's files, and the lens pre-distortion of the generated frames.

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
  - `write_scannetpp_frame` / `write_scannetpp_transforms`: ScanNet++'s
    undistorted DSLR layout, dslr/undistorted_images/DSC%05d.JPG (Pillow,
    `quality`), dslr/undistorted_depths/DSC%05d.png (16-bit at
    `depth_scale`) and dslr/nerfstudio/transforms_undistorted.json (the
    camera, each frame's OpenGL c2w, no held-out `test_frames`); no lens,
    as the undistorted images have none;
  - `LAYOUTS`: a layout's directories, paths, frame writer, end-of-sequence
    writer and reference reader, keyed by `stream.layout.kind`;
  - `predistort_maps`: where a capture through the lens samples the clean
    image, so that undistorting it gives the clean image back.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Callable, NamedTuple, Tuple

import numpy as np

from . import reference

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


def replica_paths(root, i: int, n: int, layout: dict):
    res = os.path.join(root, "results")
    return (os.path.join(res, f"frame{i:06d}.jpg"),
            os.path.join(res, f"depth{i:06d}.png"))


def write_replica_frame(root, i: int, n: int, rgb, depth,
                        layout: dict) -> None:
    from PIL import Image

    c, d = replica_paths(root, i, n, layout)
    Image.fromarray(np.asarray(rgb, np.uint8)).save(
        c, quality=int(layout["quality"]))
    write_png(d, depth_u16(depth, float(layout["depth_scale"])))


def write_replica_text(root, n: int, poses, cam: dict, layout: dict) -> None:
    np.savetxt(os.path.join(root, "traj.txt"),
               np.stack([np.asarray(p, np.float64).reshape(-1)
                         for p in poses]))


def scannetpp_paths(root, i: int, n: int, layout: dict):
    dslr = os.path.join(root, "dslr")
    return (os.path.join(dslr, "undistorted_images", f"DSC{i:05d}.JPG"),
            os.path.join(dslr, "undistorted_depths", f"DSC{i:05d}.png"))


def write_scannetpp_frame(root, i: int, n: int, rgb, depth,
                          layout: dict) -> None:
    from PIL import Image

    c, d = scannetpp_paths(root, i, n, layout)
    Image.fromarray(np.asarray(rgb, np.uint8)).save(
        c, format="JPEG", quality=int(layout["quality"]))
    write_png(d, depth_u16(depth, float(layout["depth_scale"])))


# nerfstudio's c2w is OpenGL's (y up, z backwards); the reader flips it
# back with the same diagonal.
GL_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def write_scannetpp_transforms(root, n: int, poses, cam: dict,
                               layout: dict) -> None:
    meta = {"w": int(cam["W"]), "h": int(cam["H"]),
            "fl_x": float(cam["fx"]), "fl_y": float(cam["fy"]),
            "cx": float(cam["cx"]), "cy": float(cam["cy"]),
            "frames": [{"file_path": os.path.basename(
                            scannetpp_paths(root, i, n, layout)[0]),
                        "transform_matrix": (np.asarray(poses[i], np.float64)
                                             @ GL_FLIP).tolist()}
                       for i in range(n)],
            "test_frames": []}
    with open(os.path.join(root, "dslr", "nerfstudio",
                           "transforms_undistorted.json"), "w") as f:
        json.dump(meta, f)


def finish_tum(root, n: int, poses, cam: dict, layout: dict) -> None:
    """The orphan pair, then the three texts."""
    if layout.get("orphan_after") is not None:
        h, w = cam["H"], cam["W"]
        write_tum_frame(root, n, n, np.zeros((h, w, 3), np.uint8),
                        np.zeros((h, w), np.float32), layout)
    write_tum_text(root, n, poses, layout)


class Layout(NamedTuple):
    """One reader's layout. `dirs`: the directories under the root;
    `paths(root, i, n, layout)`: frame i's (colour, depth) files;
    `write_frame(root, i, n, rgb, depth, layout)`; `finish(root, n, poses,
    cam, layout)`: the files written after the last frame;
    `read_reference(colour path, depth path, rcam)`: frame i as the
    layout's reader returns it, by the plain reference; `lens`: whether
    a capture through a lens (`cam.distortion`) can be stored."""
    dirs: Tuple[str, ...]
    paths: Callable
    write_frame: Callable
    finish: Callable
    read_reference: Callable
    lens: bool


LAYOUTS = {
    "tum": Layout(
        ("rgb", "depth"), tum_paths, write_tum_frame, finish_tum,
        reference.frame, True),
    "replica": Layout(
        ("results",), replica_paths, write_replica_frame, write_replica_text,
        reference.frame, True),
    "scannetpp": Layout(
        ("dslr/undistorted_images", "dslr/undistorted_depths",
         "dslr/nerfstudio"),
        scannetpp_paths, write_scannetpp_frame, write_scannetpp_transforms,
        reference.scannetpp_frame, False),
}


def entry(layout: dict) -> Layout:
    """The table's entry of `layout["kind"]`."""
    try:
        return LAYOUTS[layout["kind"]]
    except KeyError:
        raise ValueError(f"unknown layout {layout['kind']!r}; layouts: "
                         f"{sorted(LAYOUTS)}") from None


def predistort_maps(cam: dict, dist, iters: int = 25):
    """For each pixel x_d of the capture, the clean-image pixel it shows:
    undistort(x_d), by fixed-point iteration of the forward model. Returns
    (map_u, map_v) float32 (H, W)."""
    u, v = np.meshgrid(np.arange(cam["W"], dtype=np.float64),
                       np.arange(cam["H"], dtype=np.float64))
    xyd = np.stack([(u - cam["cx"]) / cam["fx"],
                    (v - cam["cy"]) / cam["fy"]], -1)
    xy = xyd.copy()
    dist = np.asarray(dist, np.float64)
    for _ in range(iters):
        xy = xy + (xyd - reference.distort_points(xy, dist))
    return ((cam["fx"] * xy[..., 0] + cam["cx"]).astype(np.float32),
            (cam["fy"] * xy[..., 1] + cam["cy"]).astype(np.float32))
