"""bench.py's end-to-end protocol for the port, on the card:

    python -m eags_slam_torch.bench            # quick run, then full run
    python -m eags_slam_torch.bench --quick    # the quick run only (with
                                               # the heavy evaluation)
    python -m eags_slam_torch.bench --full_only --lc off   # no loop closure

The full system of the repo's `bench.py` (`make_config`): the
model-mismatch `synthetic_hard` scene at 1200x680 with depth noise,
dropout and exposure drift, bench.py's 1.5/72 orbit a frame, the edge VO as
odometer, render tracking with exposure on the top-1/8 tiles and a 1/4
polish, edge-assisted mapping every 5th frame, a submap every 20 frames
(warm-started), and loop closure with gs_reg registration and PGO on its
own thread and CUDA stream. A 24-frame run (`"phase": "quick"`) goes
first, then the 72-frame run (`"phase": "full"`), whose 1.5 orbits revisit
the first half-orbit.

Each run prints one flushed JSON line when `GaussianSLAM.run` returns (FPS,
closures, stage totals) and a second with the cheap evaluation added (ATE /
RPE, PSNR / SSIM / MS-SSIM / depth-L1 of the submaps' keyframes), with
bench.py's `emit` keys plus the card's `nvidia-smi` name and power limit.
The full run (the quick run with `--quick`) then takes bench.py's heavy
evaluation, each stage's line printed as soon as its number exists: the
mesh F-score (`mesh_f1`; the unseen-view depth-L1 off, as in bench.py)
when more than 900 s of the deadline are left, then the global refine's
PSNR (`global_psnr_db`, 2000 iterations) when more than 600 s are; a stage
that raises leaves bench.py's `mesh_error` / `global_error` in place of
its number. The last line, without a `phase`, carries both.

bench.py's switches: `EAGS_BENCH_MESH` sets `force_mesh` (the mapping's
mesh path, on a one-rank NCCL group on one card; parallel/mesh.py), and
`EAGS_GT_CAMERA` runs the protocol at ground-truth poses. The JAX
orchestrator's run-level overrides apply, env over config:
`EAGS_INIT_HALFRES`, `EAGS_INIT_WARM`, `EAGS_MAP_STALE`, `EAGS_STALE_BEST`,
`EAGS_POSE_KERNEL` and `EAGS_SP_TRACK` (the tracking refinement split over
the mesh), e.g.

    EAGS_BENCH_MESH=1 EAGS_SP_TRACK=1 python -m eags_slam_torch.bench --quick

Under torchrun (RANK / WORLD_SIZE set) every rank runs the protocol on the
mesh of the run's cards and rank 0 prints the lines.
`EAGS_BENCH_DEADLINE_S` (default 2700 s from `EAGS_BENCH_T0`, default now)
stops a run cleanly between frames 180 s before the deadline, and the full
run is skipped when less than 420 s are left. `--lc off` runs the same
protocol without loop closure, to measure what the closer costs the SLAM
loop (the lines then say `"lc": "off"`).

There is no CPU path: without a card GaussianSLAM raises.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

BASELINE_FPS = 1.5   # bench.py's comparison point (GS-SLAM on an RTX 4090)
METRIC = "e2e_slam_fps_replica_scale_full_system"
# bench.py's heavy evaluation: the deadline seconds each stage needs left,
# and its settings.
RECON_MIN_LEFT_S = 900
GLOBAL_MIN_LEFT_S = 600
HEAVY_EVAL = {"unseen_views": 0, "global_refine_iters": 2000}


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _deadline_left() -> float:
    t0 = float(os.environ.get("EAGS_BENCH_T0", "0") or time.time())
    total = float(os.environ.get("EAGS_BENCH_DEADLINE_S", "2700"))
    return total - (time.time() - t0)


def make_config(n_frames: int, out: str, device: str = "cuda",
                lc: bool = True) -> dict:
    """bench.py's make_config, setting by setting, on the port's config
    (`lc` False: loop closure off)."""
    from .config import load_config

    config = load_config("configs/synthetic/base.yaml")
    config["device"] = device
    config["data"]["output_path"] = out
    config["cam"].update({"H": 680, "W": 1200, "fx": 600.0, "fy": 600.0,
                          "cx": 599.5, "cy": 339.5})
    config["data"].update({
        "dataset_name": "synthetic_hard",
        "n_frames": n_frames,
        "orbit_speed": 1.5 / 72.0,
        "depth_noise": 0.002,
        "depth_dropout": 0.003,
        "exposure_amp": 0.08,
    })
    config["mapping"].update({
        "map_every": 5,
        "new_submap_every": 20,
        "iterations": 100,
        "new_submap_iterations": 360,
        "new_submap_points_num": 100000,
        "new_submap_gradient_points_num": 50000,
        "new_frame_sample_size": 30000,
        "max_gaussians": 1 << 18,
        "tile_capacity": 1024,
        "max_keyframes": 32,
        "freeze_frac": 0.25,
        "freeze_after": 0.3,
        "init_warm_start": True,
        "stale_best_cnt": 20,
    })
    config["tracking"].update({
        "iterations": 60,
        "odometry_type": "odometer",
        "help_camera_initialization": False,
        "enable_exposure": True,
        "tile_subset_frac": 0.125,
        "polish_iters": 12,
        "polish_frac": 0.25,
        "stale_best_cnt": 15,
    })
    config["lc"] = {
        "enabled": lc, "parallel": True, "min_interval": 2,
        "registration": "gs_reg", "final": True,
        "capacity": 1 << 18,
    }
    if os.environ.get("EAGS_BENCH_MESH"):
        # The mapping's mesh path on the run's ranks (one card: one rank).
        config["force_mesh"] = True
    t0 = float(os.environ.get("EAGS_BENCH_T0", "0") or time.time())
    total = float(os.environ.get("EAGS_BENCH_DEADLINE_S", "2700"))
    config["bench_deadline_ts"] = t0 + total - 180.0
    if os.environ.get("EAGS_GT_CAMERA"):
        # The quality upper bound: the same protocol at ground-truth poses.
        config["tracking"]["gt_camera"] = True
        config["lc"]["enabled"] = False
    return config


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else ""


def emit(report: dict, quality: dict, card_line: str,
         phase: str = None) -> dict:
    """Print one flushed JSON line; metrics not (yet) measured are left
    out (NaN would not be JSON). `phase` None: the final line, unphased."""
    lc = report.get("lc", {})
    line = {"metric": METRIC, "value": round(report["fps"], 3),
            "unit": "frames/s",
            "vs_baseline": round(report["fps"] / BASELINE_FPS, 3)}
    if phase:
        line["phase"] = phase
    for key, src, nd in (
            ("ate_cm", "ate_rmse_cm", 3), ("rpe_cm", "rpe_trans_cm", 3),
            ("psnr_db", "psnr_db", 2), ("ssim", "ssim", 3),
            ("ms_ssim", "ms_ssim", 3), ("depth_l1_cm", "depth_l1_cm", 2),
            ("mesh_f1", "mesh_f1", 3), ("global_psnr_db", "global_psnr_db",
                                        2)):
        v = quality.get(src)
        if v is not None and not (isinstance(v, float) and math.isnan(v)):
            line[key] = round(float(v), nd)
    for err_key in ("mesh_error", "global_error"):
        if quality.get(err_key):
            line[err_key] = quality[err_key]
    line["n_closures"] = lc.get("n_closures", 0)
    line["lc_submit_ms_mean"] = round(lc.get("submit_ms_mean", 0.0), 1)
    line["stages_s"] = report.get("stage_totals_s", {})
    line["frames"] = report["frames"]
    line["lc"] = "on" if "lc" in report else "off"
    line["card"] = card_line
    print(json.dumps(line), flush=True)
    return line


def evaluate_cheap(gslam, config: dict, out: str) -> dict:
    """ATE / RPE and the keyframes' rendering metrics of a finished run."""
    from .evaluation.evaluator import Evaluator

    ev = Evaluator(out, gslam.dataset, config)
    traj = ev.run_trajectory_eval()
    rend = ev.run_rendering_eval()
    return {
        "ate_rmse_cm": 100.0 * float(traj["ate_aligned"]["rmse"]),
        "rpe_trans_cm": 100.0 * float(traj["rpe"]["rpe_trans_rmse"]),
        "rpe_rot_deg": float(traj["rpe"]["rpe_rot_rmse_deg"]),
        "psnr_db": float(rend["mean_psnr"]),
        "ssim": float(rend["mean_ssim"]),
        "ms_ssim": rend.get("mean_ms_ssim"),
        "depth_l1_cm": 100.0 * float(rend["mean_depth_l1"]),
    }


def evaluate_recon(gslam, config: dict, out: str) -> dict:
    """The mesh F-score of a finished run (bench.py's `_evaluate_recon`);
    a stage that raises reports `mesh_error` instead."""
    from .evaluation.evaluator import Evaluator

    config.setdefault("evaluation", {})["unseen_views"] = \
        HEAVY_EVAL["unseen_views"]
    try:
        recon = Evaluator(out, gslam.dataset,
                          config).run_reconstruction_eval()
        return {"mesh_f1": float(recon.get("f1", 0.0))}
    except Exception as exc:  # noqa: BLE001 -- bench.py's report, not a stop
        return {"mesh_error": repr(exc)[:200]}


def evaluate_global(gslam, config: dict, out: str) -> dict:
    """The global refine's PSNR (bench.py's `_evaluate_global`, 2000
    iterations); a stage that raises reports `global_error` instead."""
    from .evaluation.evaluator import Evaluator

    config.setdefault("evaluation", {})["global_refine_iters"] = \
        HEAVY_EVAL["global_refine_iters"]
    try:
        glob = Evaluator(out, gslam.dataset, config).run_global_map_eval()
        return {"global_psnr_db": float(glob["mean_psnr"])}
    except Exception as exc:  # noqa: BLE001 -- bench.py's report, not a stop
        return {"global_error": repr(exc)[:200]}


def run_once(n_frames: int, out: str, phase: str, card_line: str,
             device: str = "cuda", lc: bool = True,
             heavy_eval: bool = False):
    """One timed SLAM run: its FPS line, then its cheap-eval line; with
    `heavy_eval`, bench.py's mesh and global stages after it, each
    stage's line as soon as its number exists, then the final unphased
    line."""
    from .slam.gaussian_slam import GaussianSLAM

    config = make_config(n_frames, out, device, lc)
    gslam = GaussianSLAM(config)
    try:
        report = gslam.run()
        if _rank() != 0:       # rank 0 evaluates and prints
            return report, None
        emit(report, {}, card_line, phase)
        q = evaluate_cheap(gslam, config, out)
        line = emit(report, q, card_line, phase)
        if heavy_eval:
            if _deadline_left() > RECON_MIN_LEFT_S:
                q.update(evaluate_recon(gslam, config, out))
                line = emit(report, q, card_line)
                if _deadline_left() > GLOBAL_MIN_LEFT_S:
                    q.update(evaluate_global(gslam, config, out))
                else:
                    sys.stderr.write("eags_slam_torch.bench: skipping the "
                                     "global eval (deadline budget low)\n")
            else:
                sys.stderr.write("eags_slam_torch.bench: skipping the "
                                 "mesh / global eval (deadline budget "
                                 "low)\n")
            line = emit(report, q, card_line)
    finally:
        gslam.cleanup()
    return report, line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true",
                   help="the 24-frame run only")
    p.add_argument("--full_only", action="store_true",
                   help="skip the 24-frame run")
    p.add_argument("--lc", choices=("on", "off"), default="on",
                   help="loop closure (bench.py: on)")
    p.add_argument("--out", default="output/bench",
                   help="output path prefix (_quick / _full appended)")
    args = p.parse_args(argv)
    os.environ.setdefault("EAGS_BENCH_T0", str(time.time()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("eags_slam_torch.bench: no CUDA device; the bench "
                         "runs only on a card\n")
        sys.exit(1)
    # Full float32 matmuls and convolutions, as the smoke's phases run.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    np.random.seed(0)
    torch.manual_seed(0)
    card_line = card()
    lc = args.lc == "on"
    if not args.full_only:
        run_once(24, args.out + "_quick", "quick", card_line, lc=lc,
                 heavy_eval=args.quick)
    if args.quick:
        return
    if _deadline_left() < 420:
        sys.stderr.write("eags_slam_torch.bench: too little of the deadline "
                         "left for the full run\n")
        return
    run_once(72, args.out + "_full", "full", card_line, lc=lc,
             heavy_eval=True)


if __name__ == "__main__":
    main()
