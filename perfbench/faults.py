"""Planted faults of the timed path, and their readings through the check.

    python3 perfbench/faults.py --workload <cell> --fault <name> \
        --seed <n> [--seed <n> ...] --seconds <s>

runs the cell once a seed with the fault planted underneath the program's
timed path (never in a measured run: `run.py` plants nothing) and prints
one JSON line a run: the numbers the check compared, and those that fail
their limit. A fault that crashes the run reads as failed.

Faults a one-card cell can have:
  - `tracker_unchanged`: the tracker hands back the previous pose;
  - `tracker_one_iteration`: the tracker stops after its first iteration
    (two where it doubles them), its refinement cut short;
  - `mapper_unchanged`: the mapper hands back the map it was given;
  - `half_tiles`: K1 composites every other tile of its launch, the rest
    read as empty (half of the batch left out);
  - `brighter_frames`: the reader's colour one level brighter (an answer
    altered where it is produced);
  - `control`: the check's control (the program's bf16 kernels, the
    reference's frames rounded to bfloat16 in the program's place).
The exchange between cards has no counterpart on one card.
`perfbench/tests/test_perfbench_faults.py` plants each at a CPU size.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _patch(undo, obj, name, new):
    undo.append((obj, name, getattr(obj, name)))
    setattr(obj, name, new)


def _tracker_unchanged(undo):
    from eags_slam_torch.slam import tracker as T

    def unchanged(self, params, alive, last_c2w, init_candidates, gt_color,
                  gt_depth, exposure0=None):
        return np.asarray(last_c2w, np.float64), np.zeros(2), {}

    _patch(undo, T.Tracker, "track", unchanged)


def _mapper_unchanged(undo):
    from eags_slam_torch.slam import gaussian_slam as GS

    optimize = GS.M.optimize_and_describe

    def unchanged(state, kfs, n_kf, iterations, *args, **kw):
        out = optimize(state, kfs, n_kf, 1, *args, **kw)
        return (state,) + tuple(out[1:])

    _patch(undo, GS.M, "optimize_and_describe", unchanged)


def _half_tiles(undo):
    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.ops import rasterizer as rz

    fwd = cs.composite_sorted_fwd

    def half(attrs, seg_start, seg_cnt, tile_ids, *args, **kw):
        out, cols = fwd(attrs, seg_start, seg_cnt, tile_ids, *args, **kw)
        out = out.clone()
        out[1::2, :6] = 0.0
        return out, cols

    _patch(undo, cs, "composite_sorted_fwd", half)
    _patch(undo, rz, "composite_sorted_fwd", half)


def _brighter_frames(undo):
    from eags_slam_torch import datasets as D

    frame = D.FileDataset.frame

    def brighter(self, idx):
        color, depth = frame(self, idx)
        return torch.clamp(color + 1.0 / 255.0, max=1.0), depth

    _patch(undo, D.FileDataset, "frame", brighter)


# name -> (planter or None, configuration overrides, control)
FAULTS = {
    "tracker_unchanged": (_tracker_unchanged, (), False),
    "tracker_one_iteration": (None, (("tracking", "iterations", 1),), False),
    "mapper_unchanged": (_mapper_unchanged, (), False),
    "half_tiles": (_half_tiles, (), False),
    "brighter_frames": (_brighter_frames, (), False),
    "control": (None, (), True),
}


@contextlib.contextmanager
def planted(name: str):
    """Plant fault `name` for the `with` block; yields (overrides,
    control) for `harness.run_cell`."""
    plant, overrides, control = FAULTS[name]
    undo = []
    try:
        if plant is not None:
            plant(undo)
        yield list(overrides), control
    finally:
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)


def run_fault(cell, config_file, traffic_mix, name: str, seed: int,
              seconds: float, device="cuda", overrides=(), log=None):
    """One run of the cell with fault `name`: (numbers or None, the names
    of the numbers that fail their limit, or ["crashed"])."""
    from perfbench import check, harness

    with planted(name) as (fault_overrides, control):
        try:
            res = harness.run_cell(
                cell, config_file, traffic_mix, seed, seconds, False,
                device=device, overrides=list(overrides) + fault_overrides,
                control=control, log=log or (lambda _: None))
        except Exception:  # noqa: BLE001 - a crash fails the check
            traceback.print_exc(file=sys.stderr)
            return None, ["crashed"]
    limits = config_file["limits"]
    fails = sorted(k for k, lim in limits.items()
                   if not check.passes(res["numbers"][k], lim))
    return res["numbers"], fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, action="append",
                    choices=sorted(FAULTS))
    ap.add_argument("--seed", type=int, required=True, action="append")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from perfbench import run

    man = run.manifest()
    cell, config_file, traffic_mix = run.cell_files(man, args.workload)
    run.set_caches()
    if not torch.cuda.is_available():
        print("perfbench faults: no CUDA card", file=sys.stderr)
        return 3
    for name in args.fault:
        for seed in args.seed:
            numbers, fails = run_fault(cell, config_file, traffic_mix, name,
                                       seed, args.seconds)
            print(json.dumps({"workload": args.workload, "fault": name,
                              "seed": seed, "numbers": numbers,
                              "fails": fails,
                              "limits": config_file["limits"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
