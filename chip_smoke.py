#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`eags_slam_torch`) on one CUDA card.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line; any failure exits non-zero:
  1. device   - CUDA must be present; card name and power limit
                (nvidia-smi); TF32 off for matmuls and convolutions.
  2. build    - nvcc builds the K1/K2 kernels from eags_slam_torch/csrc.
  3. kernels  - K1 and K2 against their plain PyTorch twins at the main-path
                shape (1200x680, tile 32, bands 3, seg_cap 1024) on the
                synthetic room (>= 100k gaussians): full frame and a tile
                subset; max abs / rel errors per channel and grad row against
                the stated tolerances; median kernel and twin times.
  4. slice    - the port's GaussianSLAM, 12 frames of the bench protocol on
                the synthetic room; K1/K2 launch counts on that run (twins
                must not run); the port's evaluator: ATE, and PSNR / SSIM /
                MS-SSIM / depth-L1 of the saved submaps rendered at the
                estimated poses; FPS, track/map ms, peak device memory.
Then the kernel summary line, then the result line.

There is no CPU path: without CUDA the script exits 1 before any result.
"""
import argparse
import json
import subprocess
import sys
import time


def emit(obj):
    print(json.dumps(obj), flush=True)


# Tolerances of the kernel-vs-twin check, and why:
#  - K1 outputs: kernel and twin do the same per-(pixel, survivor) float32
#    operations (the kernels are built with -fmad=false); they differ only in
#    the order in which log T and the colour sums accumulate (running sum in
#    the kernel, per-chunk sums in the twin), i.e. float32 rounding.
#    rgb / alpha: 1e-3 absolute; depth sum (metres): 1e-3 + 1e-4 * |d|;
#    log T: 1e-3 + 1e-4 * |log T|. Survivor counts and columns are exact.
#    Chunks used may differ only on tiles whose largest log T sits at the
#    -11.5 stop threshold to within rounding: at most 0.5% of tiles.
#  - K2 grads: cross-tile sums by atomicAdd in a run-dependent order, plus
#    the running-sum order above: per grad row, max abs err <= 1e-3 x the
#    row's max |grad|.
TOL = {"rgb_alpha_abs": 1e-3, "depth_abs": 1e-3, "depth_rel": 1e-4,
       "logt_abs": 1e-3, "logt_rel": 1e-4, "eff_mismatch_frac": 5e-3,
       "grad_rel_to_rowmax": 1e-3}
REPLACES = {
    "K1": "eags_slam_tpu/ops/rasterizer_pallas_v2.py:260",
    "K2": "eags_slam_tpu/ops/rasterizer_pallas_v2.py:491",
}
SOURCES = {
    "K1": "eags_slam_torch/csrc/composite_sorted_fwd.cu",
    "K2": "eags_slam_torch/csrc/composite_sorted_bwd.cu",
}


# The slice: 17000 gaussians a wall (a 102,000-gaussian room), 12 frames
# (the frame-0 init and mapped frames 5, 10, 11); kernels timed as the
# median of REPS launches.
PER_WALL = 17000
N_FRAMES = 12
REPS = 20
ORBIT_SPEED = 1.0 / 300.0


def bench_config(out_dir: str, n_frames: int, per_wall: int):
    """bench.py's make_config protocol on the plain synthetic room with
    const-speed tracking and loop closure off.

    One more change from bench.py: the orbit runs at the synthetic dataset's
    own default speed (1/300 orbit a frame, about 1 cm and 0.7 deg), not
    bench.py's 1.5/72 (about 6.5 cm and 4.5 deg a frame). bench.py tracks
    with the edge VO as the initial guess; with the constant-speed guess
    alone the tracker leaves the basin at 1.5/72, in the JAX package as in
    this port (both diverge by tens of centimetres within 6 frames on a
    240x136 cut of this protocol)."""
    from eags_slam_torch.config import load_config

    config = load_config("configs/synthetic/base.yaml")
    config["device"] = "cuda"
    config["data"]["output_path"] = out_dir
    config["cam"].update({"H": 680, "W": 1200, "fx": 600.0, "fy": 600.0,
                          "cx": 599.5, "cy": 339.5})
    config["data"].update({"dataset_name": "synthetic", "n_frames": n_frames,
                           "orbit_speed": ORBIT_SPEED,
                           "gaussians_per_wall": per_wall})
    config["mapping"].update({
        "map_every": 5, "new_submap_every": 20, "iterations": 100,
        "new_submap_iterations": 360, "new_submap_points_num": 100000,
        "new_submap_gradient_points_num": 50000,
        "new_frame_sample_size": 30000, "max_gaussians": 1 << 18,
        "max_keyframes": 32,
        "freeze_frac": 0.25, "freeze_after": 0.3,
        "init_warm_start": True, "stale_best_cnt": 20,
    })
    config["tracking"].update({
        "iterations": 60, "odometry_type": "const_speed",
        "help_camera_initialization": False, "enable_exposure": True,
        "tile_subset_frac": 0.125, "polish_iters": 12, "polish_frac": 0.25,
        "stale_best_cnt": 15,
    })
    config["lc"] = {"enabled": False}
    config["vo"] = {"enabled": False}
    return config


def phase_device():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card\n")
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


def phase_build(verbose: bool):
    from eags_slam_torch.ops import composite_sorted as cs

    t0 = time.perf_counter()
    cs.load_kernels(verbose=verbose)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": cs.build_seconds})


def _median_ms(fn, reps: int):
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _kernel_inputs(per_wall: int, n_map: int = 150000, seed: int = 0,
                   device="cuda"):
    """Main-path shape: a map like the SLAM loop's after its first frame --
    `n_map` gaussians backprojected from a rendered frame of the synthetic
    room (`per_wall` gaussians a wall), 4-20 mm scales, opacity 0.5 --
    projected at a nearby pose and centre-sorted by the port's rasterizer.
    """
    import numpy as np
    import torch

    from eags_slam_torch.core.camera import Camera, backproject
    from eags_slam_torch.datasets import orbit_poses, room_scene
    from eags_slam_torch.ops.rasterizer import (RasterConfig, _sorted_attrs,
                                                _v2_radius_cap,
                                                project_gaussians, render)

    cam = Camera(600.0, 600.0, 599.5, 339.5, 1200, 680)
    cfg = RasterConfig(tile=32, dup_side=3, seg_cap=1024, bands=3)
    sc = {k: torch.as_tensor(v, device=device)
          for k, v in room_scene(seed, per_wall).items()}
    poses = orbit_poses(3, 1.5 / 72.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        c2w0 = torch.as_tensor(poses[0], dtype=torch.float32, device=device)
        gt = render(sc["means"], sc["quats"], sc["log_scales"], sc["opac"],
                    sc["colors"], torch.linalg.inv(c2w0), cam,
                    RasterConfig(tile=16, dup_side=4))
        depth = torch.where(gt.alpha > 0.5,
                            gt.depth / gt.alpha.clamp(min=1e-6),
                            torch.zeros_like(gt.depth))
        pix = torch.nonzero(depth.reshape(-1) > 0)[:, 0]
        pix = pix[torch.randperm(pix.shape[0], generator=gen,
                                 device=device)[:n_map]]
        pts = backproject(cam, depth).reshape(-1, 3)[pix]
        xyz = pts @ c2w0[:3, :3].T + c2w0[:3, 3]
        m = xyz.shape[0]
        scales = 0.004 + 0.016 * torch.rand((m, 3), generator=gen,
                                            device=device)
        q = torch.randn((m, 4), generator=gen, device=device)
        colors = gt.color.reshape(-1, 3)[pix]
        w2c = torch.as_tensor(np.linalg.inv(poses[1]), dtype=torch.float32,
                              device=device)
        proj = project_gaussians(xyz, q, torch.log(scales),
                                 torch.zeros((m, 1), device=device), w2c,
                                 cam, cfg, radius_cap=_v2_radius_cap(cfg))
        attrs, seg_start, seg_cnt = _sorted_attrs(proj, colors, cam, cfg)
    tiles_x = -(-cam.width // cfg.tile)
    tiles_y = -(-cam.height // cfg.tile)
    n_vis = int((proj.radius > 0).sum())
    return (attrs.contiguous(), seg_start.contiguous(),
            seg_cnt.contiguous(), cfg, tiles_x, tiles_y, n_vis, m)


def _compare_fwd(out_k, cols_k, out_t, cols_t):
    import torch

    LOG_T_MIN = -11.5
    rep = {}
    ok = True
    for ch, name in enumerate(("r", "g", "b", "depth", "alpha", "log_t")):
        d = (out_k[:, ch] - out_t[:, ch]).abs()
        ref = out_t[:, ch].abs()
        rep[name] = {"max_abs": float(d.max()),
                     "max_rel": float((d / ref.clamp(min=1e-6)).max())}
        if name == "depth":
            bad = d > TOL["depth_abs"] + TOL["depth_rel"] * ref
        elif name == "log_t":
            live = out_t[:, 5] > LOG_T_MIN
            bad = (d > TOL["logt_abs"] + TOL["logt_rel"] * ref) & live
        else:
            bad = d > TOL["rgb_alpha_abs"]
        rep[name]["n_bad"] = int(bad.sum())
        ok &= rep[name]["n_bad"] == 0
    n_surv_k = out_k[:, 7, 0].long()
    n_surv_t = out_t[:, 7, 0].long()
    surv_ok = bool(torch.equal(n_surv_k, n_surv_t))
    lane = torch.arange(cols_k.shape[1], device=cols_k.device)
    m = lane[None, :] < n_surv_t[:, None]
    cols_ok = surv_ok and bool(torch.equal(cols_k[m], cols_t[m]))
    eff_mis = float((out_k[:, 6, 0] != out_t[:, 6, 0]).float().mean())
    rep["survivors_equal"] = surv_ok
    rep["columns_equal"] = cols_ok
    rep["eff_mismatch_frac"] = eff_mis
    rep["mean_survivors"] = float(n_surv_t.float().mean())
    rep["max_survivors"] = int(n_surv_t.max())
    ok &= surv_ok and cols_ok and eff_mis <= TOL["eff_mismatch_frac"]
    return ok, rep


def _compare_bwd(g_k, g_t):
    rows = ("mean_u", "mean_v", "conic_a", "conic_b", "conic_c", "opacity",
            "r", "g", "b", "depth")
    rep, ok, worst = {}, True, 0.0
    for i, name in enumerate(rows):
        d = (g_k[i] - g_t[i]).abs().max()
        rowmax = g_t[i].abs().max().clamp(min=1e-12)
        rel = float(d / rowmax)
        worst = max(worst, rel)
        rep[name] = {"max_abs": float(d), "rel_to_rowmax": rel}
        ok &= rel <= TOL["grad_rel_to_rowmax"]
    rest = float(g_k[10:].abs().max())
    rep["rows_10_15_max_abs"] = rest
    ok &= rest == 0.0
    return ok, rep, worst


def phase_kernels(per_wall: int, reps: int):
    import torch

    from eags_slam_torch.ops import composite_sorted as cs

    attrs, seg_start, seg_cnt, cfg, tiles_x, tiles_y, n_vis, n_scene = \
        _kernel_inputs(per_wall)
    T = tiles_x * tiles_y
    gen = torch.Generator(device="cuda").manual_seed(0)
    subset = torch.randperm(T, generator=gen, device="cuda")[
        : round(0.125 * T)].to(torch.int32)
    results, summary = {}, {}
    all_ok = True
    for label, tile_ids in (("full", torch.arange(T, dtype=torch.int32,
                                                   device="cuda")),
                            ("subset", subset)):
        args = (attrs, seg_start, seg_cnt, tile_ids, cfg.tile, tiles_x,
                cfg.bands, cfg.seg_cap)
        out_k, cols_k = cs.composite_sorted_fwd(*args)
        out_t, cols_t = cs.composite_sorted_fwd_plain(*args)
        torch.cuda.synchronize()
        ok_f, rep_f = _compare_fwd(out_k, cols_k, out_t, cols_t)
        dout = torch.randn(out_t.shape, generator=gen, device="cuda")
        dout[:, 5:] = 0.0
        g_k = cs.composite_sorted_bwd(attrs, tile_ids, out_k, cols_k, dout,
                                      cfg.tile, tiles_x)
        g_t = cs.composite_sorted_bwd_plain(attrs, tile_ids, out_t, cols_t,
                                            dout, cfg.tile, tiles_x)
        torch.cuda.synchronize()
        ok_b, rep_b, worst = _compare_bwd(g_k, g_t)
        res = {"fwd_ok": ok_f, "fwd": rep_f, "bwd_ok": ok_b, "bwd": rep_b,
               "tiles": int(tile_ids.shape[0])}
        if label == "full":
            res["k1_ms"] = _median_ms(lambda: cs.composite_sorted_fwd(*args),
                                      reps)
            res["k1_plain_ms"] = _median_ms(
                lambda: cs.composite_sorted_fwd_plain(*args), max(3, reps // 4))
            res["k2_ms"] = _median_ms(lambda: cs.composite_sorted_bwd(
                attrs, tile_ids, out_k, cols_k, dout, cfg.tile, tiles_x), reps)
            res["k2_plain_ms"] = _median_ms(lambda: cs.composite_sorted_bwd_plain(
                attrs, tile_ids, out_t, cols_t, dout, cfg.tile, tiles_x),
                max(3, reps // 4))
            summary = {
                "K1": {"max_abs_err": max(rep_f[c]["max_abs"] for c in
                                          ("r", "g", "b", "depth", "alpha")),
                       "ms": res["k1_ms"], "plain_ms": res["k1_plain_ms"]},
                "K2": {"max_abs_err": max(rep_b[c]["max_abs"] for c in
                                          rep_b if isinstance(rep_b[c], dict)),
                       "ms": res["k2_ms"], "plain_ms": res["k2_plain_ms"],
                       "max_rel_to_rowmax": worst},
            }
        results[label] = res
        all_ok &= ok_f and ok_b
    emit({"phase": "kernels", "ok": all_ok, "shape": {
        "H": 680, "W": 1200, "tile": cfg.tile, "bands": cfg.bands,
        "seg_cap": cfg.seg_cap, "tiles": T, "npad": int(attrs.shape[1]),
        "scene_gaussians": n_scene, "visible_gaussians": n_vis},
        "tolerances": TOL, **results})
    if not all_ok:
        raise SystemExit("kernel vs twin check failed")
    return summary


def phase_slice(per_wall: int, n_frames: int, out_dir: str):
    import torch

    from eags_slam_torch.evaluation.evaluator import Evaluator
    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.slam.gaussian_slam import GaussianSLAM

    config = bench_config(out_dir, n_frames, per_wall)
    gslam = GaussianSLAM(config)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cs.reset_counts()
        report = gslam.run()
        torch.cuda.synchronize()
        launches = cs.counts()
        peak = torch.cuda.max_memory_allocated()
        results = Evaluator(out_dir, gslam.dataset, config).run()
        traj, rend = results["trajectory"], results["rendering"]
    finally:
        gslam.cleanup()
    ate_cm = 100.0 * traj["ate"]["rmse"]
    ok = (launches["fwd_launches"] > 0 and launches["bwd_launches"] > 0
          and launches["fwd_twin_calls"] == 0
          and launches["bwd_twin_calls"] == 0
          and ate_cm < 5.0 and rend["mean_psnr"] > 20.0
          and report["frames"] == n_frames)
    emit({"phase": "slice", "ok": ok, "frames": report["frames"],
          "scene_gaussians": gslam.dataset.n_scene,
          "launches": launches, "ate_cm": ate_cm,
          "rpe_cm": 100.0 * traj["rpe"]["rpe_trans_rmse"],
          "psnr_db": rend["mean_psnr"], "ssim": rend["mean_ssim"],
          "ms_ssim": rend["mean_ms_ssim"],
          "depth_l1_cm": 100.0 * rend["mean_depth_l1"],
          "psnr_views": rend["num_views"],
          "fps": report["fps"], "total_s": report["total_s"],
          "track_ms": report["track_ms_avg"], "map_ms": report["map_ms_avg"],
          "peak_mem_gb": peak / 2**30, "tracker": report["tracker"],
          "map_frames": report.get("map_frames")})
    if not ok:
        raise SystemExit("slice check failed")
    return launches


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="device,build,kernels,slice")
    p.add_argument("--out", default="output/chip_smoke_slice")
    p.add_argument("--ptxas", action="store_true",
                   help="print nvcc -Xptxas -v (registers, spills)")
    args = p.parse_args()
    phases = set(args.phases.split(","))

    phase_device()
    import torch

    phase_build(args.ptxas)
    summary = phase_kernels(PER_WALL, REPS) if "kernels" in phases else {}
    # Without the slice phase no main-path run was counted: launches null.
    launches = phase_slice(PER_WALL, N_FRAMES, args.out) \
        if "slice" in phases else {}
    kernels = []
    for kid, lkey in (("K1", "fwd_launches"), ("K2", "bwd_launches")):
        s = summary.get(kid, {})
        kernels.append({"name": kid, "route": "cuda", "source": SOURCES[kid],
                        "replaces": REPLACES[kid],
                        "launches": launches.get(lkey),
                        "max_abs_err": s.get("max_abs_err"),
                        "ms": s.get("ms"), "plain_ms": s.get("plain_ms")})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
