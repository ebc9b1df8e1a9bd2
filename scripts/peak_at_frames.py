"""The card memory of a benchmark cell's run at a fixed number of frames.

`perfbench`'s `peak_mem_gib` is the peak over a fixed time, which a faster
loop reaches at a later frame with a larger map. This runs the cell's
set-up and loop (`perfbench.harness.run_cell`, its check included) and
stops when the loop asks for frame `--frames`, so that two trees are read
at the same frame:

    python /path/to/scripts/peak_at_frames.py --workload tum_fr1_desk.steady \
        --seed 1414213562 --frames 30 [--keep-keyframes] [--eager-tracker]

run from the root of the checkout to measure (its `perfbench` and
`eags_slam_torch` are imported from the current directory), on a CUDA card.
It prints, a line each, every frame's allocated peak inside
`Tracker.track` and `GaussianSLAM.map_frame` (the peak statistics reset at
each call's start), then one JSON line: the run's
`torch.cuda.max_memory_allocated()` and `max_memory_reserved()` in GiB
from its start to frame `--frames` (the benchmark's check after it left
out, as `peak_mem_gib` leaves it out).

Two options change the program from here, for the comparison only:
`--keep-keyframes` keeps every VO keyframe's pyramid and distance
transforms alive, as the VO did before it released all but the newest
keyframe's; `--eager-tracker` refines every frame without the tracker's
CUDA graph (`Tracker._refine_graph`, where the tree has one).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

from eags_slam_torch.slam import gaussian_slam as G  # noqa: E402
from eags_slam_torch.slam import tracker as T  # noqa: E402
from eags_slam_torch.vo import system as V  # noqa: E402
from perfbench import harness  # noqa: E402
from perfbench import run as R  # noqa: E402

GIB = float(1 << 30)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, required=True,
                    help="stop when the loop asks for this frame (> 4)")
    ap.add_argument("--keep-keyframes", action="store_true")
    ap.add_argument("--eager-tracker", action="store_true")
    args = ap.parse_args()
    if args.frames <= harness.WARM_FRAMES:
        ap.error(f"--frames must exceed the {harness.WARM_FRAMES} warm frames")
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    cell, config_file, mix = R.cell_files(R.manifest(), args.workload)

    peaks = []          # (frame, stage, allocated peak) of each call

    def measured(stage, fn):
        def call(self, *a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            peaks.append((frame[0], stage, torch.cuda.max_memory_allocated()))
            return out
        return call

    frame = [-1]
    on_frame = harness.Run.on_frame

    def stop_at(run, idx, read):
        if idx >= args.frames:
            note()
            overall.append(None)        # the loop's peak is read
            run.t_end = time.perf_counter()
            run.ended_by = "frames"
            run.completed = idx - run.first
            raise harness.Closed()
        frame[0] = idx
        return on_frame(run, idx, read)

    harness.Run.on_frame = stop_at
    T.Tracker.track = measured("track", T.Tracker.track)
    G.GaussianSLAM.map_frame = measured("map", G.GaussianSLAM.map_frame)
    kept = []
    if args.keep_keyframes:
        promote = V.EdgeVO._promote_keyframe

        def keep(self, *a, **k):
            promote(self, *a, **k)
            kf = self.keyframes[-1]
            kept.append((kf.pyramid, kf.dt_levels))
        V.EdgeVO._promote_keyframe = keep
    if args.eager_tracker and hasattr(T.Tracker, "_refine_graph"):
        T.Tracker._refine_graph = lambda self, device: None

    # The peaks from set-up to frame `--frames`, the check after it left
    # out: the statistics are reset at every call measured above, so the
    # run's are the largest of the calls' and of the work between them.
    overall = [0, 0]

    def note():
        if len(overall) == 2:
            overall[0] = max(overall[0], torch.cuda.max_memory_allocated())
            overall[1] = max(overall[1], torch.cuda.max_memory_reserved())

    reset = torch.cuda.reset_peak_memory_stats

    def reset_noted(*a, **k):
        note()
        reset(*a, **k)
    torch.cuda.reset_peak_memory_stats = reset_noted
    res = harness.run_cell(cell, config_file, mix, args.seed, 1e9, False,
                           log=lambda line: None)
    for f, stage, peak in peaks:
        print(f"frame {f} {stage} peak {peak / GIB:.4f} GiB")
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "frames": args.frames,
        "completed": res["frames"], "keep_keyframes": args.keep_keyframes,
        "eager_tracker": args.eager_tracker,
        "peak_allocated_gib": overall[0] / GIB,
        "peak_reserved_gib": overall[1] / GIB,
        "device": torch.cuda.get_device_name()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
