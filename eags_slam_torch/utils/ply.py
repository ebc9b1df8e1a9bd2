"""3DGS-convention PLY export / import of gaussian clouds (port of
eags_slam_tpu.utils.ply; host numpy, byte for byte the same file).

Binary little-endian PLY with the standard 3DGS attribute names (x y z,
nx ny nz, f_dc_*, f_rest_*, opacity, scale_*, rot_*), readable by common
3DGS viewers; no plyfile dependency.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _fields(n_rest: int):
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += ["f_dc_0", "f_dc_1", "f_dc_2"]
    names += [f"f_rest_{i}" for i in range(n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_gaussian_ply(path: str, g: Dict[str, np.ndarray]) -> None:
    """g: host dict with xyz, f_dc, f_rest (N, 15, 3), log_scales, quats,
    opacity_logits."""
    n = g["xyz"].shape[0]
    f_rest = np.asarray(g["f_rest"]).reshape(n, -1)  # (N, 45), as 3DGS
    cols = [
        g["xyz"],
        np.zeros((n, 3), np.float32),           # normals (unused, convention)
        g["f_dc"],
        f_rest,
        np.asarray(g["opacity_logits"]).reshape(n, 1),
        g["log_scales"],
        g["quats"],
    ]
    data = np.concatenate([np.asarray(c, np.float32) for c in cols], axis=1)
    names = _fields(f_rest.shape[1])
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        header += [f"property float {nm}" for nm in names]
        header += ["end_header", ""]
        f.write("\n".join(header).encode())
        f.write(data.astype("<f4").tobytes())


def load_gaussian_ply(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        names = []
        n = 0
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(4 * n * len(names)), "<f4").reshape(
            n, len(names))
    col = {nm: i for i, nm in enumerate(names)}
    n_rest = sum(1 for nm in names if nm.startswith("f_rest_"))
    return {
        "xyz": data[:, [col["x"], col["y"], col["z"]]],
        "f_dc": data[:, [col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]]],
        "f_rest": data[:, [col[f"f_rest_{i}"] for i in range(n_rest)]]
        .reshape(n, -1, 3),
        "opacity_logits": data[:, [col["opacity"]]],
        "log_scales": data[:, [col[f"scale_{i}"] for i in range(3)]],
        "quats": data[:, [col[f"rot_{i}"] for i in range(4)]],
    }
