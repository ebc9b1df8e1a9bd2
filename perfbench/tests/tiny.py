"""A cell at a size the CPU runs in seconds: the configuration's camera
cut to 96 x 64 (intrinsics scaled), a few mapping and tracking iterations,
small seed budgets; everything else as the cell has it."""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


# The tiny size's own `ate_cm` limit: a dozen frames at 96 x 64 with a few
# iterations read 3.1 / 3.5 cm sound (replica / tum), 6.8 / 8.3 cm with the
# tracker and 13.2 / 5.1 cm with the mapper returning their state.
ATE_CM = 5.0


def load(workload: str):
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {c["name"]: c for c in man["workloads"]}[workload]
    entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config_file = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((ROOT / "perfbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return cell, config_file, mix


def at_tiny(config_file: dict) -> dict:
    """The configuration file with the tiny size's `ate_cm` limit."""
    return {**config_file,
            "limits": {**config_file["limits"], "ate_cm": ATE_CM}}


def overrides(config_file: dict, frames: int = 9):
    cam = config_file["stream"]["cam"]
    s = 96.0 / cam["W"]
    crop = config_file["config"]["cam"].get("crop_edge", 0)
    out = [("cam", "W", 96), ("cam", "H", 64),
           ("cam", "fx", cam["fx"] * s), ("cam", "fy", cam["fy"] * s),
           ("cam", "cx", (cam["cx"] + 0.5) * s - 0.5),
           ("cam", "cy", (cam["cy"] + 0.5) * s - 0.5),
           ("cam", "crop_edge", min(crop, 4))]
    for k, v in (("iterations", 10), ("new_submap_iterations", 10),
                 ("new_submap_points_num", 2000),
                 ("new_submap_gradient_points_num", 500),
                 ("new_frame_sample_size", 1000), ("max_gaussians", 16384),
                 ("raster_tile", 16)):
        out.append(("mapping", k, v))
    out.append(("tracking", "iterations", 20))
    return out, frames


def mix_of(mix: dict, frames: int):
    return {**mix, "frames": frames}
