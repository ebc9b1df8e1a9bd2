#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`eags_slam_torch`) on one CUDA card.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line; any failure exits non-zero:
  1. device   - CUDA must be present; card name and power limit
                (nvidia-smi); the Pillow version (null without it: the
                replica phase's JPEG needs it); whether the native frame
                loader's library loads ("tracked": native/libloader.so;
                "built": native/loader.cpp compiled into build/; null,
                with each attempt's error); TF32 off for matmuls and
                convolutions.
  2. build    - K1-K7 from eags_slam_torch/csrc: one nvcc per source, in
                parallel, then one link, all with FMA (every kernel rounds
                its alpha decisions as the twin does through _rn
                intrinsics). With --ptxas, also the registers, spills and
                shared bytes of K3, K4, K5 and K6.
  3. kernels  - at the main-path shape (1200x680, tile 32) on the synthetic
                room (>= 100k gaussians): K1 and K2 against their plain
                PyTorch twins (bands 3, seg_cap 1024), full frame and a
                shuffled 1/8 tile subset (both timed on both); K3 against
                K2's twin and K2 on the same residuals, timed on both shapes
                with the run length its wrapper takes; K4 against its twin,
                twice bit for bit, and against the K2 + autograd chain on
                the frozen-sorted tracking layout (the 1/8 subset, the 1/4
                polish set and the full grid, timed on all three); K5 and
                K6 against their twins on the entry layout (dup_side 3,
                entry_cap_factor 4, max_per_tile 8192), full frame and the
                frozen binning at a shifted tracking pose, K6 twice bit for
                bit, both timed on both, and K7 (the entry gather's
                backward) on K6's grads of the render layout, twice bit
                for bit and against its plain version, timed beside it and
                index_add_; then K1 and K2 at the loop
                closer's shape (tile 16 on the 600x340 localisation camera,
                a 65,536-gaussian map like the closer's subsample, the full
                836-tile grid and a shuffled 209-tile quarter, both timed),
                and at the TUM RGB-D map camera's (tile 32 on 540x380, a
                50,000-gaussian map, the full 204-tile grid and the
                tracker's shuffled 51-tile quarter, both timed); then
                K1-K4 under kernel_quadform, kernel_bf16 and both on the
                main shape's full grid and 1/8 subset (K4 on the
                frozen-sorted layout) against their twins under the same
                option, K4 twice bit for bit, each variant timed beside the
                default one with its bound on its own work (quadform
                operations, the bf16 layout's bytes); K2 and K3 in each of
                the four variants, on the full grid and the subset, twice
                bit for bit and with the same bits on the ascending and a
                shuffled copy of the same tile ids;
                max errors against the stated tolerances; median kernel,
                twin and backward times; each kernel's bound on every timed
                shape.
  4. slice    - the port's GaussianSLAM, 12 frames of the bench protocol on
                the synthetic room with const-speed tracking, the default
                sorted configuration; K1/K2 launch counts on that run
                (twins must not run); the port's evaluator: ATE, and PSNR /
                SSIM / MS-SSIM / depth-L1 of the saved submaps rendered at
                the estimated poses; FPS, track / map ms, peak device memory.
 4b. lpips    - LPIPS(alex) on seeded weights with AlexNet's shapes
                (a temporary file; the module's path pointed at it): two
                1200x680 images on the card and on the CPU within 1e-4
                relative, ms a call; the evaluator's rendering stage on the
                slice's output directory, its mean_lpips finite.
 4c. dense    - the golden check: the dense reference splatter
                (`ops/rasterizer_ref.py` render_dense) on the card against
                the jnp backend, K1 and K5 at the JAX rasterizer tests'
                cameras (48x32, 128x64 at tiles 32 and 64) and tolerances,
                the kernels launched and no twin; then the slice's
                protocol for 3 frames on the dense `jnp` backend
                (EAGS_RCFG=backend=jnp, tile_capacity 1024): no K1-K6
                launch, no twin, ATE < 5 cm, PSNR > 20 dB; FPS, track / map
                ms and peak memory beside the slice's.
  5. window   - the slice's 12 frames again with `mapping.rmw_window` on:
                every sorted backward (tracking and mapping) through K3, no
                K2 launch; the same gates and metrics, and the default
                slice's FPS / ATE / PSNR beside them.
  6. c2f      - coarse-to-fine tracking: bench.py's protocol with loop
                closure off and the pose-contraction backward on, 24 frames
                of synthetic_hard at bench.py's 1.5/72 orbit, the edge VO
                giving the odometer candidate; K1/K2/K4 launches (twins must
                not run), odometer wins, VO keyframes and ms, the evaluator's
                metrics, FPS, track / map ms, peak memory. Gate: ATE < 5
                cm, PSNR > 19 dB, SSIM > 0.55.
 6'. repeat   - c2f again with the same config and seeds into a second
                directory: evaluation.pose_spread over the two runs finds
                no differing frame in the poses, the VO trajectory or any
                mapping or tracking record of log.jsonl (timings left
                out), and the evaluator's ATE, PSNR, SSIM, MS-SSIM and
                depth-L1 are equal (one input, one answer, as on the TPU).
 6a. vo_cpu   - c2f's 24 frames with `vo.device: cpu`: the edge VO on the
                host CPU, pipelined one frame ahead on its worker thread;
                c2f's gates, every VO step on CPU tensors and frames 1-23
                stepped on the worker; FPS, track / map / VO ms and the
                loop's wait for the VO a frame beside c2f's.
 6b. mesh     - the mesh path on the card: a one-rank NCCL process group,
                then c2f's frames with EAGS_BENCH_MESH=1 (force_mesh: the
                mapper's plain loop) and EAGS_SP_TRACK=1 (the tracking
                refinement tile-split over the mesh: K1 + K2 on the full
                836-tile grid, no K4 though pose_grad_kernel is on); the
                world-size-1 sp_map_step and sp_track_refine held against
                the single-device functions on the run's final map and last
                frame (loss within 1e-4, gradients rtol 2e-3 plus 1e-3 of
                each leaf's largest for K2's atomics); K1 / K2 launches (no
                K4, no twin), FPS, track / map ms, peak memory and the
                collectives a frame beside c2f's numbers. Gate: c2f's
                bounds.
  7. entries  - the slice's protocol with EAGS_RCFG=backend=pallas for that
                run: candidate scoring, frozen-binning tracking and the
                plain mapping loop all through K5 / K6, the entry gather's
                backward through K7 (no K1-K4 launch, no twin); the same
                metrics, and the slice's ATE / PSNR beside them.
  8. slice_k4 - the slice's 12 frames with `tracking.pose_grad_kernel`
                on (off by default, as in the reference): every tracking
                backward through K4, mapping on K2; the same gates, and the
                default slice's FPS / track / map ms beside them.
  9. slice_opts - the slice's 12 frames with `mapping.kernel_quadform`,
                `mapping.kernel_bf16` and `tracking.pose_grad_kernel`:
                tracking through K1 + K4, mapping through K1 + K2, every
                launch the quadform_bf16 variant (no default-variant launch,
                no twin); the slice's gates, and FPS / track / map ms / peak
                memory beside the default slice's.
 10. slice_mapopts - the slice's 12 frames with `mapping.tile_subset` 279
                (a third of the 836 tiles), `mapping.init_halfres_frac`
                0.25 and `tracking.debug_per_iter`: the half-resolution
                init at every new submap through K1 / K2 on 600x340 (209
                tiles), every full-resolution mapped iteration on exactly
                279 tiles, one per-iteration record (12 columns, as many
                active rows as the frame's iterations) a tracked frame in
                log.jsonl; the slice's gates, no twin.
 11. lc       - bench.py's full protocol (`eags_slam_torch.bench`'s
                make_config(72)): 72 frames of synthetic_hard with loop
                closure on its own thread and CUDA stream (gs_reg through K1
                / K2 at tile 16, Gauss-Newton PGO on the host); K1 / K2
                launches of the main path and of the closer apart (no
                twin in either), closures, submit / register / PGO ms, the
                lc_drain stage, FPS, track / map / VO ms beside c2f's and
                the SLAM loop's track / map ms split by whether a closer
                pass was in flight, ATE and PSNR, peak memory. Gate: ATE
                < 5 cm, PSNR > 19 dB, SSIM > 0.55, at least one closure, its
                corrections drained into the live pose array and its
                submaps' files rewritten.
 12. heavy    - bench.py's heavy evaluation on the lc phase's output
                directory (its 72 frames, four submaps, loop-corrected
                anchors), at the evaluator's settings: K1 and K2 against
                their twins at the global refine's shape (tile 16 on the
                full 1200x680 image, 3225 tiles, the merged map at one
                keyframe), timed with their bounds, with the tiles whose
                bands seg_cap clips; then, with the launch counts set to 0,
                the reconstruction (TSDF at voxel 5/512 on a grid of at
                most 512^3, 20k GT points a keyframe, 200k mesh samples,
                1000 unseen views at 128 x 128: grid, integrate ms a
                keyframe, surface nets / clean / sample / metrics seconds,
                vertices, faces, accuracy, completion, precision, recall,
                F1, depth-L1) and the global refine (bench.py's 2000
                iterations, its K1 / K2 launches counted under the tag
                "global": seconds, ms an iteration, PSNR / SSIM / MS-SSIM
                beside the lc phase's per-submap PSNR, alive before and
                after, peak memory). Gates: faces > 0, F1 > 0.4, global
                PSNR > 19 dB, every number finite, no twin, and
                mesh/global_splats.ply read back with the alive count.
 12b. mesh_bound - `python -m eags_slam_torch.mesh_bound`'s main at bench
                scale (72 frames, every 5th fused, voxel 5/512, both grid
                bounds): GT depth at GT poses through the evaluator's TSDF,
                mesh and metrics. Gate: faces and a finite F1 on each line,
                the depth-bounds F1 above the heavy phase's F1 of the same
                call; F1, precision, recall and wall seconds beside the
                reference's 0.797.
 13. tum      - the TUM RGB-D reader at configs/TUM_RGBD/fr1_desk.yaml's
                full size: 24 frames of synthetic_hard rendered at its
                calibration (640x480), colour pre-distorted with its lens
                coefficients (the model inverted by fixed-point iteration,
                its residual printed over the part the crop keeps), written
                in the TUM layout with the port's writer (colour rows with
                every PNG filter type, 16-bit depth at 5000 stamped 12 ms
                later, ground truth 4 ms later, one orphan pair 5 s after
                the last frame); then fr1_desk.yaml as it stands (crop 50,
                the odometer, exposure, outlier removal, loop closure) read
                back through GaussianSLAM.run and the evaluator. Gate: 24
                frames (the orphan rejected), frame 0's undistorted colour
                within mean abs 0.02 of the clean render over the map
                camera's pixels, the map camera 540x380 and the VO stepped
                on 640x480 frames, every mapped frame seeded from the VO's
                edges (no Canny fallback), ATE < 5 cm, PSNR > 19 dB, no
                twin. Prints FPS, track / map / VO ms, the reader that
                ran (the native pool where its library loads, else the
                Python preloader), data_wait and the preloader's decode ms
                a frame (null under the native pool), a Paeth-filtered
                frame's
                decode alone (beside Pillow's), peak memory, K1 / K2
                launches a frame.
 14. replica  - the Replica reader: 24 frames of bench.py's synthetic_hard
                at 1200x680 written as JPEG colour (quality 95, Pillow),
                16-bit depth at 6553.5 and traj.txt, run through
                configs/Replica/room0.yaml with the heavy evaluation off
                (the heavy phase covers it); the tum phase's gates.
 15. tum_cost - not run by default (`--phases ...,tum,tum_cost`): what the
                reader costs the loop. The tum phase's 24 frames run eight
                more times from four sources: the reader on its Python
                preloader (decode beside the loop), the native pool (when
                its library loads; its frames first held equal to the
                Python reader's), the reader handed the same frames decoded
                beforehand (thread and pinned uploads, no decode) and an
                ArrayDataset of those frames on the card; reader / native /
                cached / decoded / decoded / cached / native / reader
                (without the pool: six runs, no native). Prints FPS, track
                / map / VO ms and data_wait of each run and each source's
                FPS over the reader's. Gate: every run's frames and reader,
                the tum gates on ATE and PSNR, no twin.
Then the kernel summary line (K1-K4 launches also by variant: default,
quadform, bf16, quadform_bf16, with each variant's times and bounds; K5 /
K6 launches also by layout: render binning, frozen tracking binning; K1 / K2 at the global shape and
`launches_global`, the refine's; K1 / K2 at the closer's and the TUM
shapes) and the result line. The card line (from
the device phase) comes first.

There is no CPU path: without CUDA the script exits 1 before any result.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def emit(obj):
    print(json.dumps(obj), flush=True)


# Tolerances of the kernel-vs-twin check, and why:
#  - K1 outputs: kernel and twin take the same alpha decisions (the kernel
#    rounds them with explicit intrinsics, csrc/alpha_box.cuh); they differ
#    in how the sums accumulate (the kernel keeps T linear with FMA and takes
#    log T once at the end, the twin sums log1p per chunk), i.e. float32
#    rounding.
#    rgb / alpha: 1e-3 absolute; depth sum (metres): 1e-3 + 1e-4 * |d|;
#    log T: 1e-3 + 1e-4 * |log T|. Survivor counts and columns are exact.
#    Chunks used may differ only on tiles whose largest log T sits at the
#    -11.5 stop threshold to within rounding: at most 0.5% of tiles.
#  - K2 grads: the running-sum order above (K2 recovers T by reciprocals
#    from K1's log T) and another order of the pixel sums; the cross-tile
#    sums take the twin's slot order: per grad row, max abs err <= 1e-3 x
#    the row's max |grad|. No atomics: two runs, and two orders of the same
#    tile ids, are equal bit for bit.
#  - K4 dpose (7,): the same replay as K2, summed per survivor and then
#    over each block in a fixed order; the twin sums K2's grads over all
#    gaussians in another order: max abs err <= 1e-3 x max |dpose|. No
#    atomics: two runs are equal bit for bit.
#  - K4 path vs the K2 + autograd chain (the same loss): the same chain-rule
#    sum in another association order: max abs err
#    <= 1e-3 x max |dpose| (the JAX golden test holds 2e-4 on the CPU).
#  - K3 grads against K2's twin and against K2: the same sums, the
#    cluster's regions added in rank order in the band windows before they
#    reach K2's slot table: per grad row 1e-3 x the row's max |grad|, as
#    K2; two runs and two tile orders equal bit for bit, as K2.
#  - K5 outputs against the twin: as K1 (the same per-pair operations, the
#    running sums in another order); entry counts exact.
#  - K6 grads: as K2 per row (1e-3 x row max), exact zeros in the columns K5
#    did not composite, and two runs equal bit for bit (no atomics).
#  - K7, the entry gather's backward: each column's entries added in the
#    same order as its plain version, so within 1e-6 of the plain version's
#    largest |grad| (equal bits expected), twice bit for bit, the sentinel
#    column zero.
TOL = {"rgb_alpha_abs": 1e-3, "depth_abs": 1e-3, "depth_rel": 1e-4,
       "logt_abs": 1e-3, "logt_rel": 1e-4, "eff_mismatch_frac": 5e-3,
       "grad_rel_to_rowmax": 1e-3, "dpose_rel_to_max": 1e-3,
       "chain_rel_to_max": 1e-3, "gather_rel_to_max": 1e-6}
REPLACES = {
    "K1": "eags_slam_tpu/ops/rasterizer_pallas_v2.py:260",
    "K2": "eags_slam_tpu/ops/rasterizer_pallas_v2.py:491",
    "K3": "eags_slam_tpu/ops/rasterizer_pallas_v2.py:649",
    "K4": "eags_slam_tpu/ops/rasterizer_pallas_v2.py:1056",
    "K5": "eags_slam_tpu/ops/rasterizer_pallas.py:95",
    "K6": "eags_slam_tpu/ops/rasterizer_pallas.py:180",
    # Not a Pallas kernel: XLA's scatter-add in the entry gather's backward.
    "K7": "eags_slam_tpu/ops/rasterizer.py:329",
}
SOURCES = {
    "K1": "eags_slam_torch/csrc/composite_sorted_fwd.cu",
    "K2": "eags_slam_torch/csrc/composite_sorted_bwd.cu",
    "K3": "eags_slam_torch/csrc/composite_sorted_bwd_window.cu",
    "K4": "eags_slam_torch/csrc/pose_grad_sorted.cu",
    "K5": "eags_slam_torch/csrc/composite_entries_fwd.cu",
    "K6": "eags_slam_torch/csrc/composite_entries_bwd.cu",
    "K7": "eags_slam_torch/csrc/composite_entries_bwd.cu",
}
LAUNCH_KEYS = {"K1": "fwd_launches", "K2": "bwd_launches",
               "K3": "window_launches", "K4": "pose_launches",
               "K5": "entries_fwd_launches", "K6": "entries_bwd_launches",
               "K7": "entries_gather_launches"}
TWIN_KEYS = ("fwd_twin_calls", "bwd_twin_calls", "window_twin_calls",
             "pose_twin_calls", "entries_fwd_twin_calls",
             "entries_bwd_twin_calls", "entries_gather_twin_calls")

# Published peaks of one H100 SXM (NVIDIA data sheet), the yardstick of
# every bound_ms: HBM3 bandwidth and FP32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations the function needs, counted from the kernel sources (a
# transcendental counts as one). A survivor of a tile needs its alpha box
# (csrc/alpha_box.cuh, 40), outside of which its alpha is zero for every
# pixel, so only a pair inside the box needs its Gaussian power (2
# subtractions, 6 multiplies, 2 adds and the test); a pair whose alpha
# passes the 1/255 test then needs K1's exp / clip / log1p / transmittance /
# 4 colour sums (16), K2's replay and 10 gradient terms (55), or K4's replay
# and 6 gradient terms (47). K4 adds 42 multiply-adds (84 operations) per
# survivor for the contraction. K3 replays as K2, K5 composites as K1 and
# K6 replays as K2.
OPS_BOX = 40
OPS_TEST = 10
OPS_CONTRIB = {"K1": 16, "K2": 55, "K3": 55, "K4": 47, "K5": 16, "K6": 55}
OPS_K4_CONTRACT = 84
# The quadform variants (kernel_quadform): a replayed survivor also needs
# its six coefficients (17) and the box's widening (13); a boxed pair
# quad_alpha's 5 multiplies and 5 adds; a contributing pair of the
# backward the six basis moments (11) in place of the five du / dv terms
# (22), and a replayed survivor their contraction to five grads (30).
VARIANTS = ("quadform", "bf16", "quadform_bf16")
OPS_BOX_QUAD = OPS_BOX + 30
OPS_TEST_QUAD = 10
OPS_CONTRIB_QUAD = {"K1": 16, "K2": 44, "K3": 44, "K4": 36}
OPS_QUAD_CONTRACT = 30


# The slice: 17000 gaussians a wall (a 102,000-gaussian room), 12 frames
# (the frame-0 init and mapped frames 5, 10, 11); the c2f phase: 24 frames
# (mapped frames 0, 5, 10, 15, the submap boundary at 20 with its warm
# start, and 23); kernels timed as the median of REPS launches. K3's blocks
# take GROUP tiles (the SLAM's `raster_group` default).
PER_WALL = 17000
GROUP = 8
N_FRAMES = 12
C2F_FRAMES = 24
LC_FRAMES = 72
REPS = 20
ORBIT_SPEED = 1.0 / 300.0
BENCH_ORBIT_SPEED = 1.5 / 72.0


def bench_config(out_dir: str, n_frames: int, per_wall: int):
    """bench.py's make_config protocol on the plain synthetic room with
    const-speed tracking and loop closure off.

    One more change from bench.py: the orbit runs at the synthetic dataset's
    own default speed (1/300 orbit a frame, about 1 cm and 0.7 deg), not
    bench.py's 1.5/72 (about 6.5 cm and 4.5 deg a frame): with the
    constant-speed guess alone the tracker leaves the basin at 1.5/72, in
    the JAX package as in this port. The c2f phase runs bench.py's own
    orbit with the edge VO."""
    config = _bench_common(out_dir)
    config["data"].update({"dataset_name": "synthetic", "n_frames": n_frames,
                           "orbit_speed": ORBIT_SPEED,
                           "gaussians_per_wall": per_wall})
    config["tracking"].update({"odometry_type": "const_speed"})
    config["vo"] = {"enabled": False}
    return config


def c2f_config(out_dir: str, n_frames: int):
    """bench.py's make_config(n_frames) protocol with loop closure off and
    the pose-contraction backward (K4) on: synthetic_hard at 1200x680,
    orbit 1.5/72, depth noise 0.002, dropout 0.003, exposure 0.08; the edge
    VO as the odometer (at 600x340, the automatic half resolution of frames
    wider than 800 px)."""
    config = _bench_common(out_dir)
    config["data"].update({"dataset_name": "synthetic_hard",
                           "n_frames": n_frames,
                           "orbit_speed": BENCH_ORBIT_SPEED,
                           "depth_noise": 0.002, "depth_dropout": 0.003,
                           "exposure_amp": 0.08})
    config["tracking"].update({"odometry_type": "odometer",
                               "pose_grad_kernel": True})
    return config


def _bench_common(out_dir: str):
    """bench.py's make_config settings shared by the slice and c2f phases
    (loop closure off, no deadline)."""
    from eags_slam_torch.config import load_config

    config = load_config("configs/synthetic/base.yaml")
    config["device"] = "cuda"
    config["data"]["output_path"] = out_dir
    config["cam"].update({"H": 680, "W": 1200, "fx": 600.0, "fy": 600.0,
                          "cx": 599.5, "cy": 339.5})
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
        "iterations": 60, "odometry_type": "odometer",
        "help_camera_initialization": False, "enable_exposure": True,
        "tile_subset_frac": 0.125, "polish_iters": 12, "polish_frac": 0.25,
        "stale_best_cnt": 15,
    })
    config["lc"] = {"enabled": False}
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
    try:
        import PIL
        pillow = PIL.__version__
    except ImportError:
        pillow = None
    from eags_slam_torch.utils import native_loader

    native = native_loader.status()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "pillow": pillow, "torch": torch.__version__,
          "cuda": torch.version.cuda, "native": native["native"],
          "native_errors": native["errors"]})
    return card


def phase_build(verbose: bool):
    from eags_slam_torch.ops import composite_sorted as cs

    t0 = time.perf_counter()
    cs.load_kernels(verbose=verbose)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": cs.build_seconds})
    if verbose:
        emit({"phase": "ptxas", **_ptxas_summary(cs.build_log)})


# The mangled-name parts of K3-K6's kernels in nvcc's output.
PTXAS_KERNELS = {"K3": "bwd_window_kernel", "K4": "pose_kernel",
                 "K5": "entries_fwd_kernel", "K6": "entries_bwd_kernel"}


def _ptxas_summary(log: str) -> dict:
    """Registers, spill bytes and static shared bytes of each instance of
    K3-K6's kernels, from nvcc -Xptxas -v (empty when the library came
    from the build cache). K3's and K6's dynamic shared memory is sized at
    launch: K6's warp slots, 5120 bytes a warp; K3's quarter-chunk warp
    slots, 1280 bytes a warp, and a CTA's share of the band rings, 40 bytes
    a column (bands x seg_cap) over the cluster's CTAs."""
    import re

    out = {k: [] for k in PTXAS_KERNELS}
    fn, spill = None, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            for k, part in PTXAS_KERNELS.items():
                if part in fn:
                    out[k].append({
                        "function": fn, "registers": int(m.group(1)),
                        "static_smem_bytes": int(smem.group(1)) if smem
                        else 0,
                        "spill_store_bytes": spill[0] if spill else None,
                        "spill_load_bytes": spill[1] if spill else None})
            fn, spill = None, None
    return out


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
                   device="cuda", cam=None, cfg=None):
    """Main-path shape: a map like the SLAM loop's after its first frame --
    `n_map` gaussians backprojected from a rendered frame of the synthetic
    room (`per_wall` gaussians a wall), 4-20 mm scales, opacity 0.5 --
    projected at a nearby pose and centre-sorted by the port's rasterizer.
    `cam` / `cfg`: another camera and raster config (default 1200x680,
    tile 32).
    """
    import numpy as np
    import torch

    from eags_slam_torch.core.camera import Camera, backproject
    from eags_slam_torch.datasets import orbit_poses, room_scene
    from eags_slam_torch.ops.rasterizer import (RasterConfig, _sorted_attrs,
                                                _v2_radius_cap,
                                                project_gaussians, render)

    cam = cam or Camera(600.0, 600.0, 599.5, 339.5, 1200, 680)
    cfg = cfg or RasterConfig(tile=32, dup_side=3, seg_cap=1024, bands=3)
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
    gmap = (xyz, q, torch.log(scales), torch.zeros((m, 1), device=device),
            colors, w2c)
    return (attrs.contiguous(), seg_start.contiguous(),
            seg_cnt.contiguous(), cfg, cam, tiles_x, tiles_y, n_vis, m, gmap)


def _work(attrs, tile_ids, out, cols, tile: int, tiles_x: int,
          quadform: bool = False):
    """What this run's data makes a compositing kernel do, in the chunks K1
    processed: pairs, the (pixel, survivor) pairs; boxed, those inside
    their survivor's alpha box; contrib, those whose alpha passed the 1/255
    test; replayed, the survivors. `quadform`: the quadform variant's
    alpha and widened box; attrs in the bf16 layout count as rebuilt."""
    import torch

    from eags_slam_torch.ops.composite_sorted import (CHUNK, _as_f32, _basis,
                                                      _chunk_alpha,
                                                      _chunk_alpha_quad,
                                                      _chunk_attrs,
                                                      _pixel_coords,
                                                      _tile_origin,
                                                      alpha_box,
                                                      quad_alpha_box)

    attrs = _as_f32(attrs)

    eff = out[:, 6, 0].long()
    n_surv = out[:, 7, 0].long()
    replayed = int(torch.minimum(n_surv, eff * CHUNK).sum())
    # K1 leaves the columns past each tile's survivor count unwritten.
    lane = torch.arange(cols.shape[1], device=cols.device)
    cols = torch.where(lane[None, :] < n_surv[:, None], cols,
                       torch.zeros_like(cols))
    pu, pv = _pixel_coords(tile_ids, tile, tiles_x)
    slot = torch.arange(CHUNK, device=cols.device)
    boxed = contrib = 0
    with torch.no_grad():
        for ci in range(int(eff.max()) if eff.numel() else 0):
            n_valid = torch.where(ci < eff, n_surv - ci * CHUNK,
                                  torch.zeros_like(n_surv))
            e = _chunk_attrs(attrs, cols, ci)
            if quadform:
                tx0, ty0 = _tile_origin(tile_ids, tile, tiles_x)
                alpha, _, u_, v_ = _chunk_alpha_quad(
                    e, _basis(tile, attrs.device), tx0, ty0, n_valid)
                box = quad_alpha_box(e[0], e[1], e[2], e[3], e[4], e[5], u_,
                                     v_, tile)
            else:
                alpha = _chunk_alpha(e, pu, pv, n_valid)[0]
                box = alpha_box(e[0], e[1], e[2], e[3], e[4], e[5])
            contrib += int((alpha > 0).sum())
            boxed += int(((box[0][:, None] <= pu[:, :, None])
                          & (box[1][:, None] >= pu[:, :, None])
                          & (box[2][:, None] <= pv[:, :, None])
                          & (box[3][:, None] >= pv[:, :, None])
                          & (slot[None, :] < n_valid[:, None])[:, None])
                         .sum())
    return {"pairs": replayed * tile * tile, "boxed": boxed,
            "contrib": contrib, "replayed": replayed}


def _ops(kernel: str, w: dict, quadform: bool = False) -> int:
    """FP32 operations `kernel` needs on the work `w` of `_work` (of its
    quadform variant with `quadform`)."""
    if quadform:
        ops = (OPS_BOX_QUAD * w["replayed"] + OPS_TEST_QUAD * w["boxed"]
               + OPS_CONTRIB_QUAD[kernel] * w["contrib"])
        if kernel != "K1":
            ops += OPS_QUAD_CONTRACT * w["replayed"]
    else:
        ops = (OPS_BOX * w["replayed"] + OPS_TEST * w["boxed"]
               + OPS_CONTRIB[kernel] * w["contrib"])
    return ops + (OPS_K4_CONTRACT * w["replayed"] if kernel == "K4" else 0)


def _bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the FP32 operations over the FP32 peak."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _k4_bytes(tile_ids, out, cols, attr_bytes: int = 40) -> int:
    """The bytes K4 moves on this run's data: attr rows 0-9 (`attr_bytes`
    a column: 40, or 26 from the bf16 layout's 13 rows) and jacobian rows
    0-41 of the distinct survivor columns it replays, the replayed part of
    cols, dout rows 0-4, out row 5 and the two count cells of each tile,
    tile_ids, and the (S, 8) partial it writes; the rest 4-byte words."""
    import torch

    from eags_slam_torch.ops.composite_sorted import CHUNK, P_MAX, PJ

    s, _, px = out.shape
    replayed = torch.minimum(out[:, 7, 0].long(),
                             out[:, 6, 0].long() * CHUNK)
    lane = torch.arange(cols.shape[1], device=cols.device)
    read = cols[lane[None, :] < replayed[:, None]]
    distinct = int(torch.unique(read).numel())
    words = (7 * PJ * distinct + read.numel()
             + s * (6 * px + 2) + s + s * P_MAX)
    return 4 * words + attr_bytes * distinct


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

    (attrs, seg_start, seg_cnt, cfg, cam, tiles_x, tiles_y, n_vis, n_scene,
     gmap) = _kernel_inputs(per_wall)
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
                                      cfg.tile, tiles_x, cfg.bands)
        g_t = cs.composite_sorted_bwd_plain(attrs, tile_ids, out_t, cols_t,
                                            dout, cfg.tile, tiles_x,
                                            cfg.bands)
        g_w = cs.composite_sorted_bwd_window(
            attrs, seg_start, tile_ids, out_k, cols_k, dout, cfg.tile,
            tiles_x, cfg.bands, cfg.seg_cap, GROUP)
        torch.cuda.synchronize()
        ok_b, rep_b, worst = _compare_bwd(g_k, g_t)
        ok_w, rep_w, worst_w = _compare_bwd(g_w, g_t)
        ok_wk, rep_wk, worst_wk = _compare_bwd(g_w, g_k)
        res = {"fwd_ok": ok_f, "fwd": rep_f, "bwd_ok": ok_b, "bwd": rep_b,
               "window_ok": ok_w and ok_wk, "window_vs_twin": rep_w,
               "window_vs_k2_rel_to_rowmax": worst_wk,
               "tiles": int(tile_ids.shape[0]),
               "k3_run": cs.last_window_run}
        work = _work(attrs, tile_ids, out_k, cols_k, cfg.tile, tiles_x)
        k2_bound = _bound(_nbytes(attrs, tile_ids, out_k, cols_k, dout, g_k),
                          _ops("K2", work))
        k3_bound = _bound(_nbytes(attrs, seg_start, tile_ids, out_k, cols_k,
                                  dout, g_w), _ops("K3", work))
        res["k2_bound_ms"] = k2_bound["bound_ms"]
        res["k3_bound_ms"] = k3_bound["bound_ms"]
        if label == "subset":
            res["k1_ms"] = _median_ms(lambda: cs.composite_sorted_fwd(*args),
                                      reps)
            res["k2_ms"] = _median_ms(lambda: cs.composite_sorted_bwd(
                attrs, tile_ids, out_k, cols_k, dout, cfg.tile, tiles_x,
                cfg.bands), reps)
            res["k3_ms"] = _median_ms(lambda: cs.composite_sorted_bwd_window(
                attrs, seg_start, tile_ids, out_k, cols_k, dout, cfg.tile,
                tiles_x, cfg.bands, cfg.seg_cap, GROUP), reps)
            # The subset's times and bounds beside the full grid's.
            summary["K2"]["subset"] = {"ms": res["k2_ms"],
                                       "bound_ms": k2_bound["bound_ms"]}
            summary["K3"]["subset"] = {"ms": res["k3_ms"],
                                       "bound_ms": k3_bound["bound_ms"],
                                       "run": res["k3_run"]}
        if label == "full":
            res["k1_ms"] = _median_ms(lambda: cs.composite_sorted_fwd(*args),
                                      reps)
            res["k1_plain_ms"] = _median_ms(
                lambda: cs.composite_sorted_fwd_plain(*args), max(3, reps // 4))
            res["k2_ms"] = _median_ms(lambda: cs.composite_sorted_bwd(
                attrs, tile_ids, out_k, cols_k, dout, cfg.tile, tiles_x,
                cfg.bands), reps)
            res["k2_plain_ms"] = _median_ms(lambda: cs.composite_sorted_bwd_plain(
                attrs, tile_ids, out_t, cols_t, dout, cfg.tile, tiles_x,
                cfg.bands),
                max(3, reps // 4))
            res["k3_ms"] = _median_ms(lambda: cs.composite_sorted_bwd_window(
                attrs, seg_start, tile_ids, out_k, cols_k, dout, cfg.tile,
                tiles_x, cfg.bands, cfg.seg_cap, GROUP), reps)
            res["pairs"], res["boxed_pairs"], res["contributing_pairs"] = (
                work["pairs"], work["boxed"], work["contrib"])
            summary = {
                "K1": {"max_abs_err": max(rep_f[c]["max_abs"] for c in
                                          ("r", "g", "b", "depth", "alpha")),
                       "ms": res["k1_ms"], "plain_ms": res["k1_plain_ms"],
                       **_bound(_nbytes(attrs, seg_start, seg_cnt, tile_ids,
                                        out_k, cols_k), _ops("K1", work))},
                "K2": {"max_abs_err": max(rep_b[c]["max_abs"] for c in
                                          rep_b if isinstance(rep_b[c], dict)),
                       "ms": res["k2_ms"], "plain_ms": res["k2_plain_ms"],
                       "max_rel_to_rowmax": worst, **k2_bound},
                # K3's plain version is K2's twin (the same sums).
                "K3": {"max_abs_err": max(rep_w[c]["max_abs"] for c in
                                          rep_w if isinstance(rep_w[c], dict)),
                       "ms": res["k3_ms"], "plain_ms": res["k2_plain_ms"],
                       "max_rel_to_rowmax": worst_w, "run": res["k3_run"],
                       **k3_bound},
            }
        results[label] = res
        all_ok &= ok_f and ok_b and ok_w and ok_wk
    polish = torch.randperm(T, generator=gen, device="cuda")[
        : round(0.25 * T)].to(torch.int32)
    ok4, rep4, summary["K4"] = _check_k4(cfg, cam, gmap, subset, polish, T,
                                         reps, gen)
    ok56, rep56, k56 = _check_entries(cam, gmap, reps, gen)
    summary.update(k56)
    ok_lc, rep_lc, k12_lc = _check_lc_shape(per_wall, reps, gen)
    ok_tum, rep_tum, k12_tum = _check_tum_shape(per_wall, reps, gen)
    for kid in k12_lc:
        summary[kid].update(k12_lc[kid])
        summary[kid].update(k12_tum[kid])
    ok_var, rep_var, k1234_var = _check_variants(
        attrs, seg_start, seg_cnt, cfg, cam, tiles_x,
        {"full": torch.arange(T, dtype=torch.int32, device="cuda"),
         "subset": subset}, gmap, reps, gen)
    for kid in k1234_var:
        summary[kid].update(k1234_var[kid])
    all_ok &= ok4 and ok56 and ok_lc and ok_tum and ok_var
    emit({"phase": "kernels", "ok": all_ok, "shape": {
        "H": 680, "W": 1200, "tile": cfg.tile, "bands": cfg.bands,
        "seg_cap": cfg.seg_cap, "group": GROUP, "tiles": T,
        "npad": int(attrs.shape[1]), "scene_gaussians": n_scene,
        "visible_gaussians": n_vis},
        "tolerances": TOL, **results, "k4": rep4, "entries": rep56,
        "lc_shape": rep_lc, "tum_shape": rep_tum, "variants": rep_var,
        "bounds": {k: {f: v[f] for f in ("bound_ms", "bound_by", "bytes",
                                         "ops")}
                   for k, v in summary.items()}})
    if not all_ok:
        raise SystemExit("kernel vs twin check failed")
    return summary


# The loop closer's registration renders: the bench camera at localisation
# level 1 and its raster config (lc/loop_closure.py: tile 16, dup_side 4),
# on a map of its registration subsample's size; a localisation segment
# refines on a quarter of the tiles.
LC_MAP = 1 << 16
LC_SUBSET_FRAC = 0.25
# The TUM RGB-D map camera: configs/TUM_RGBD/tum_rgbd.yaml's calibration
# cropped by its crop_edge of 50 (540 x 380), at the SLAM loop's tile 32
# (17 x 12 = 204 tiles), on a map of the config's new-submap seed count
# (30,000 + 20,000 points); the tracker refines on a quarter of the tiles.
TUM_CAM = (517.306408, 516.469215, 318.643040, 255.313989, 640, 480)
TUM_DIST = [0.262383, -0.953104, -0.005358, 0.002628, 1.163314]
TUM_CROP = 50
TUM_MAP = 50000
TUM_SUBSET_FRAC = 0.25


def _check_lc_shape(per_wall: int, reps: int, gen):
    """K1 and K2 at the loop closer's shape (module docstring, kernels)."""
    from eags_slam_torch.core.camera import Camera
    from eags_slam_torch.ops.rasterizer import RasterConfig

    cam = Camera(600.0, 600.0, 599.5, 339.5, 1200, 680).scaled(1)
    return _check_shape("lc", cam, RasterConfig(tile=16, dup_side=4),
                        LC_MAP, LC_SUBSET_FRAC, per_wall, reps, gen, seed=1)


def _check_tum_shape(per_wall: int, reps: int, gen):
    """K1 and K2 at the TUM RGB-D map camera's shape (540 x 380, tile
    32, the SLAM loop's dup_side 3)."""
    from eags_slam_torch.core.camera import Camera
    from eags_slam_torch.ops.rasterizer import RasterConfig

    cam = Camera(*TUM_CAM).crop(TUM_CROP)
    cfg = RasterConfig(tile=32, dup_side=3, seg_cap=1024, bands=3)
    return _check_shape("tum", cam, cfg, TUM_MAP, TUM_SUBSET_FRAC, per_wall,
                        reps, gen, seed=2)


def _check_shape(prefix: str, cam, cfg, n_map: int, subset_frac: float,
                 per_wall: int, reps: int, gen, seed: int):
    """K1 and K2 on camera `cam` at raster config `cfg` against their twins
    (the tolerances of the main shape), on the full grid and a shuffled
    `subset_frac` of it, each timed with its bound, the twins timed too.
    Returns (ok, report, {kid: {prefix + "_full": ..., prefix + "_subset":
    ...}})."""
    import torch

    from eags_slam_torch.ops import composite_sorted as cs

    (attrs, seg_start, seg_cnt, cfg, cam, tiles_x, tiles_y, n_vis, n_map,
     _) = _kernel_inputs(per_wall, n_map=n_map, seed=seed, cam=cam, cfg=cfg)
    T = tiles_x * tiles_y
    ids_all = torch.arange(T, dtype=torch.int32, device="cuda")
    subset = torch.randperm(T, generator=gen, device="cuda")[
        : round(subset_frac * T)].to(torch.int32)
    rep = {"shape": {"H": cam.height, "W": cam.width, "tile": cfg.tile,
                     "bands": cfg.bands, "seg_cap": cfg.seg_cap, "tiles": T,
                     "map_gaussians": n_map, "visible_gaussians": n_vis}}
    extra = {"K1": {}, "K2": {}}
    ok = True
    for label, tile_ids in ((prefix + "_full", ids_all),
                            (prefix + "_subset", subset)):
        args = (attrs, seg_start, seg_cnt, tile_ids, cfg.tile, tiles_x,
                cfg.bands, cfg.seg_cap)
        out_k, cols_k = cs.composite_sorted_fwd(*args)
        out_t, cols_t = cs.composite_sorted_fwd_plain(*args)
        torch.cuda.synchronize()
        ok_f, rep_f = _compare_fwd(out_k, cols_k, out_t, cols_t)
        dout = torch.randn(out_t.shape, generator=gen, device="cuda")
        dout[:, 5:] = 0.0
        g_k = cs.composite_sorted_bwd(attrs, tile_ids, out_k, cols_k, dout,
                                      cfg.tile, tiles_x, cfg.bands)
        g_t = cs.composite_sorted_bwd_plain(attrs, tile_ids, out_t, cols_t,
                                            dout, cfg.tile, tiles_x,
                                            cfg.bands)
        torch.cuda.synchronize()
        ok_b, rep_b, worst = _compare_bwd(g_k, g_t)
        work = _work(attrs, tile_ids, out_k, cols_k, cfg.tile, tiles_x)
        k1_bound = _bound(_nbytes(attrs, seg_start, seg_cnt, tile_ids, out_k,
                                  cols_k), _ops("K1", work))
        k2_bound = _bound(_nbytes(attrs, tile_ids, out_k, cols_k, dout, g_k),
                          _ops("K2", work))
        k1_ms = _median_ms(lambda: cs.composite_sorted_fwd(*args), reps)
        k2_ms = _median_ms(lambda: cs.composite_sorted_bwd(
            attrs, tile_ids, out_k, cols_k, dout, cfg.tile, tiles_x,
            cfg.bands), reps)
        k1_plain = _median_ms(lambda: cs.composite_sorted_fwd_plain(*args),
                              max(3, reps // 4))
        k2_plain = _median_ms(lambda: cs.composite_sorted_bwd_plain(
            attrs, tile_ids, out_t, cols_t, dout, cfg.tile, tiles_x,
            cfg.bands),
            max(3, reps // 4))
        tiles = int(tile_ids.shape[0])
        extra["K1"][label] = {
            "tiles": tiles, "ms": k1_ms, "plain_ms": k1_plain,
            "bound_ms": k1_bound["bound_ms"],
            "bound_by": k1_bound["bound_by"],
            "bound_share": k1_bound["bound_ms"] / k1_ms,
            "max_abs_err": max(rep_f[c]["max_abs"] for c in
                               ("r", "g", "b", "depth", "alpha"))}
        extra["K2"][label] = {
            "tiles": tiles, "ms": k2_ms, "plain_ms": k2_plain,
            "bound_ms": k2_bound["bound_ms"],
            "bound_by": k2_bound["bound_by"],
            "bound_share": k2_bound["bound_ms"] / k2_ms,
            "max_rel_to_rowmax": worst,
            "max_abs_err": max(rep_b[c]["max_abs"] for c in rep_b
                               if isinstance(rep_b[c], dict))}
        rep[label] = {"fwd_ok": ok_f, "fwd": rep_f, "bwd_ok": ok_b,
                      "bwd": rep_b, "pairs": work["pairs"],
                      "boxed_pairs": work["boxed"],
                      "contributing_pairs": work["contrib"],
                      "bounds": {"K1": k1_bound, "K2": k2_bound}}
        ok &= ok_f and ok_b
    return ok, rep, extra


def _track_loss(out):
    """The loss of the JAX golden test of K4 (tests/test_rasterizer_pose.py)
    on a tile render."""
    return (out.color.sum() + 0.3 * out.depth.sum() + (out.alpha ** 2).sum()
            + (out.color * out.color).sum())


def _check_k4(cfg, cam, gmap, subset, polish, T, reps, gen):
    """K4 at the tracking shape: the frozen-sorted layout of the kernels
    map, a relative pose near identity, the 1/8 tile subset (the refine),
    the 1/4 polish set and the full grid. K4 against its twin on K1's
    residuals and twice bit for bit, then the whole K4 path (K1 + jacobian
    + K4) against the K2 + autograd chain on the same loss; times of K4
    (with its bound), the jacobian, the twin, and of both paths'
    backward. The summary is the subset's, with the polish set's and the
    full grid's times and bounds beside it."""
    import torch

    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.ops import rasterizer as R
    from eags_slam_torch.slam.tracker import _rel_matrix

    xyz, q, log_s, opac, colors, last_w2c = gmap
    fs = R.freeze_sorted(xyz, q, log_s, opac, colors, last_w2c, cam, cfg)
    pv = torch.tensor([0.9995, 0.01, -0.02, 0.015, 0.01, -0.02, 0.03],
                      device="cuda")
    tiles_x = -(-cam.width // cfg.tile)
    rep, ok, summary = {}, True, {}
    extra = {}
    for label, tile_ids in (("subset", subset), ("polish", polish),
                            ("full", torch.arange(T, dtype=torch.int32,
                                                  device="cuda"))):
        with torch.no_grad():
            attrs = R._stack_reproj_rows(fs.e3d, R._pose_rel_w2c(pv, last_w2c),
                                         cam, cfg).contiguous()
            out, cols = cs.composite_sorted_fwd(
                attrs, fs.seg_start.contiguous(), fs.seg_cnt.contiguous(),
                tile_ids, cfg.tile, tiles_x, cfg.bands, cfg.seg_cap)
            jac = R._pose_jacobian(fs.e3d, pv, last_w2c, cam, cfg)
        dout = torch.randn(out.shape, generator=gen, device="cuda")
        dout[:, 5:] = 0.0
        g_k = cs.pose_grad_sorted(attrs, jac, tile_ids, out, cols, dout,
                                  cfg.tile, tiles_x)
        g_k2 = cs.pose_grad_sorted(attrs, jac, tile_ids, out, cols, dout,
                                   cfg.tile, tiles_x)
        g_t = cs.pose_grad_sorted_plain(attrs, jac, tile_ids, out, cols,
                                        dout, cfg.tile, tiles_x)
        torch.cuda.synchronize()
        det = bool(torch.equal(g_k, g_k2))
        err = float((g_k - g_t).abs().max())
        rel = err / max(float(g_t.abs().max()), 1e-12)

        # The two tracking paths on the same loss.
        qt = pv.clone().requires_grad_(True)
        loss4 = _track_loss(R.render_frozen_sorted_tiles_pose(
            fs, qt, last_w2c, tile_ids, cam, cfg))
        loss2 = _track_loss(R.render_frozen_sorted_tiles(
            fs, last_w2c @ _rel_matrix(qt[:4], qt[4:]), tile_ids, cam, cfg))
        (d4,) = torch.autograd.grad(loss4, qt, retain_graph=True)
        (d2,) = torch.autograd.grad(loss2, qt, retain_graph=True)
        chain_err = float((d4 - d2).abs().max())
        chain_rel = chain_err / max(float(d2.abs().max()), 1e-12)
        r = {"tiles": int(tile_ids.shape[0]), "max_abs_err": err,
             "rel_to_max": rel, "k4_deterministic": det,
             "dpose": g_k.tolist(),
             "chain_max_abs_err": chain_err, "chain_rel_to_max": chain_rel,
             "loss_k4_path": float(loss4.detach()),
             "loss_k2_chain": float(loss2.detach()),
             "dpose_k4_path": d4.tolist(), "dpose_k2_chain": d2.tolist()}
        r["k4_ms"] = _median_ms(lambda: cs.pose_grad_sorted(
            attrs, jac, tile_ids, out, cols, dout, cfg.tile, tiles_x), reps)
        r["jacobian_ms"] = _median_ms(lambda: R._pose_jacobian(
            fs.e3d, pv, last_w2c, cam, cfg), reps)
        r["k4_plain_ms"] = _median_ms(lambda: cs.pose_grad_sorted_plain(
            attrs, jac, tile_ids, out, cols, dout, cfg.tile, tiles_x),
            max(3, reps // 4))
        r["backward_k4_path_ms"] = _median_ms(lambda: torch.autograd.grad(
            loss4, qt, retain_graph=True), reps)
        r["backward_k2_chain_ms"] = _median_ms(lambda: torch.autograd.grad(
            loss2, qt, retain_graph=True), reps)
        ok &= rel <= TOL["dpose_rel_to_max"] and \
            chain_rel <= TOL["chain_rel_to_max"] and det and \
            bool(torch.isfinite(g_k).all())
        work = _work(attrs, tile_ids, out, cols, cfg.tile, tiles_x)
        bound = _bound(_k4_bytes(tile_ids, out, cols), _ops("K4", work))
        r["k4_bound_ms"] = bound["bound_ms"]
        if label == "subset":
            summary = {"max_abs_err": err, "ms": r["k4_ms"],
                       "plain_ms": r["k4_plain_ms"], **bound}
        else:
            extra[label] = {"ms": r["k4_ms"], "bound_ms": bound["bound_ms"],
                            "max_abs_err": err, "tiles": r["tiles"]}
        rep[label] = r
    return ok, rep, {**summary, **extra}


def _check_variants(attrs, seg_start, seg_cnt, cfg, cam, tiles_x, shapes,
                    gmap, reps, gen):
    """K1-K4 under kernel_quadform, kernel_bf16 and both at the main-path
    shape, each on the full grid and the shuffled 1/8 subset (`shapes`):
    K1 / K2 / K3 on the kernels map and K4 on its frozen-sorted tracking
    layout, against their twins under the same option (K1's outputs,
    survivors, columns and chunks used, K2 / K3 grads and K4's dpose at the
    default tolerances, K4 twice bit for bit), each timed beside the
    default variant on the same inputs with its bound on its own work: the
    quadform ops per boxed / contributing pair and replayed survivor, the
    bf16 layout's bytes. Returns (ok, report, {kid: {"variants":
    {variant: {shape: ...}}}})."""
    import torch

    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.ops import rasterizer as R

    xyz, q, log_s, opac, colors, last_w2c = gmap
    fs = R.freeze_sorted(xyz, q, log_s, opac, colors, last_w2c, cam, cfg)
    pv = torch.tensor([0.9995, 0.01, -0.02, 0.015, 0.01, -0.02, 0.03],
                      device="cuda")
    with torch.no_grad():
        a4 = R._stack_reproj_rows(fs.e3d, R._pose_rel_w2c(pv, last_w2c), cam,
                                  cfg).contiguous()
        jac = R._pose_jacobian(fs.e3d, pv, last_w2c, cam, cfg)
    ok, rep = True, {}
    summary = {kid: {"variants": {}} for kid in ("K1", "K2", "K3", "K4")}
    for label, tile_ids in shapes.items():
        dout = torch.randn((tile_ids.shape[0], 8, cfg.tile ** 2),
                           generator=gen, device="cuda")
        dout[:, 5:] = 0.0
        # One cotangent a tile of the grid, for the tile-order check.
        dtab = torch.randn((tiles_x * -(-cam.height // cfg.tile), 8,
                            cfg.tile ** 2), generator=gen, device="cuda")
        dtab[:, 5:] = 0.0
        for variant in ("default",) + VARIANTS:
            quad, bf16 = "quadform" in variant, "bf16" in variant
            a = cs.to_bf16_layout(attrs) if bf16 else attrs
            a4v = cs.to_bf16_layout(a4) if bf16 else a4
            fargs = (a, seg_start, seg_cnt, tile_ids, cfg.tile, tiles_x,
                     cfg.bands, cfg.seg_cap, quad)
            f4args = (a4v, fs.seg_start, fs.seg_cnt, tile_ids, cfg.tile,
                      tiles_x, cfg.bands, cfg.seg_cap, quad)
            out_k, cols_k = cs.composite_sorted_fwd(*fargs)
            out4, cols4 = cs.composite_sorted_fwd(*f4args)
            g_k = cs.composite_sorted_bwd(a, tile_ids, out_k, cols_k, dout,
                                          cfg.tile, tiles_x, cfg.bands, quad)
            g_w = cs.composite_sorted_bwd_window(
                a, seg_start, tile_ids, out_k, cols_k, dout, cfg.tile,
                tiles_x, cfg.bands, cfg.seg_cap, GROUP, quad)
            d_k = cs.pose_grad_sorted(a4v, jac, tile_ids, out4, cols4, dout,
                                      cfg.tile, tiles_x, quad)
            order = _check_order(a, seg_start, seg_cnt, cfg, tiles_x,
                                 tile_ids, out_k, cols_k, g_k, g_w, dout,
                                 dtab, quad, gen)
            ok &= all(order.values())
            r = {"tiles": int(tile_ids.shape[0]), "deterministic": order}
            err = {}
            if variant != "default":
                out_t, cols_t = cs.composite_sorted_fwd_plain(*fargs)
                out4_t, cols4_t = cs.composite_sorted_fwd_plain(*f4args)
                g_t = cs.composite_sorted_bwd_plain(a, tile_ids, out_t,
                                                    cols_t, dout, cfg.tile,
                                                    tiles_x, cfg.bands, quad)
                d_k2 = cs.pose_grad_sorted(a4v, jac, tile_ids, out4, cols4,
                                           dout, cfg.tile, tiles_x, quad)
                d_t = cs.pose_grad_sorted_plain(a4v, jac, tile_ids, out4_t,
                                                cols4_t, dout, cfg.tile,
                                                tiles_x, quad)
                torch.cuda.synchronize()
                ok_f, rep_f = _compare_fwd(out_k, cols_k, out_t, cols_t)
                ok_f4, rep_f4 = _compare_fwd(out4, cols4, out4_t, cols4_t)
                ok_b, rep_b, worst = _compare_bwd(g_k, g_t)
                ok_w, rep_w, worst_w = _compare_bwd(g_w, g_t)
                e4 = float((d_k - d_t).abs().max())
                rel4 = e4 / max(float(d_t.abs().max()), 1e-12)
                det = bool(torch.equal(d_k, d_k2))
                ok_v = (ok_f and ok_f4 and ok_b and ok_w and det
                        and rel4 <= TOL["dpose_rel_to_max"])
                ok &= ok_v
                err = {"K1": max(rep_f[c]["max_abs"] for c in
                                 ("r", "g", "b", "depth", "alpha")),
                       "K2": max(rep_b[c]["max_abs"] for c in rep_b
                                 if isinstance(rep_b[c], dict)),
                       "K3": max(rep_w[c]["max_abs"] for c in rep_w
                                 if isinstance(rep_w[c], dict)),
                       "K4": e4}
                r.update({"ok": ok_v, "fwd": rep_f, "fwd_k4_layout": rep_f4,
                          "bwd_rel_to_rowmax": worst,
                          "window_rel_to_rowmax": worst_w,
                          "k4_rel_to_max": rel4, "k4_deterministic": det})
            ms = {
                "K1": _median_ms(lambda: cs.composite_sorted_fwd(*fargs),
                                 reps),
                "K2": _median_ms(lambda: cs.composite_sorted_bwd(
                    a, tile_ids, out_k, cols_k, dout, cfg.tile, tiles_x,
                    cfg.bands,
                    quad), reps),
                "K3": _median_ms(lambda: cs.composite_sorted_bwd_window(
                    a, seg_start, tile_ids, out_k, cols_k, dout, cfg.tile,
                    tiles_x, cfg.bands, cfg.seg_cap, GROUP, quad), reps),
                "K4": _median_ms(lambda: cs.pose_grad_sorted(
                    a4v, jac, tile_ids, out4, cols4, dout, cfg.tile,
                    tiles_x, quad), reps)}
            work = _work(a, tile_ids, out_k, cols_k, cfg.tile, tiles_x, quad)
            work4 = _work(a4v, tile_ids, out4, cols4, cfg.tile, tiles_x,
                          quad)
            bounds = {
                "K1": _bound(_nbytes(a, seg_start, seg_cnt, tile_ids, out_k,
                                     cols_k), _ops("K1", work, quad)),
                "K2": _bound(_nbytes(a, tile_ids, out_k, cols_k, dout, g_k),
                             _ops("K2", work, quad)),
                "K3": _bound(_nbytes(a, seg_start, tile_ids, out_k, cols_k,
                                     dout, g_w), _ops("K3", work, quad)),
                "K4": _bound(_k4_bytes(tile_ids, out4, cols4,
                                       26 if bf16 else 40),
                             _ops("K4", work4, quad))}
            for kid in ms:
                summary[kid]["variants"].setdefault(variant, {})[label] = {
                    "ms": ms[kid], "bound_ms": bounds[kid]["bound_ms"],
                    "bound_by": bounds[kid]["bound_by"],
                    "bound_share": bounds[kid]["bound_ms"] / ms[kid],
                    "max_abs_err": err.get(kid)}
                if kid in ("K2", "K3"):
                    summary[kid]["variants"][variant][label][
                        "deterministic"] = all(
                            v for k, v in order.items() if k.startswith(kid))
            r.update({"ms": ms, "boxed_pairs": work["boxed"],
                      "contributing_pairs": work["contrib"],
                      "bounds": bounds})
            rep[f"{variant}_{label}"] = r
    return ok, rep, summary


def _check_order(a, seg_start, seg_cnt, cfg, tiles_x, tile_ids, out_k,
                 cols_k, g_k, g_w, dout, dtab, quad, gen) -> dict:
    """K2 and K3 (variant of `a` and `quad`) are functions of their inputs:
    a second call on K1's `out_k` / `cols_k` and `dout` gives `g_k` / `g_w`
    to the bit, and the ascending and a shuffled copy of the tiles
    `tile_ids` (K1 run on each, one cotangent a tile from `dtab`) give the
    same bits."""
    import torch

    from eags_slam_torch.ops import composite_sorted as cs

    def k2(ids, out, cols, d):
        return cs.composite_sorted_bwd(a, ids, out, cols, d, cfg.tile,
                                       tiles_x, cfg.bands, quad)

    def k3(ids, out, cols, d):
        return cs.composite_sorted_bwd_window(
            a, seg_start, ids, out, cols, d, cfg.tile, tiles_x, cfg.bands,
            cfg.seg_cap, GROUP, quad)

    det = {"K2_twice": bool(torch.equal(
               g_k, k2(tile_ids, out_k, cols_k, dout))),
           "K3_twice": bool(torch.equal(
               g_w, k3(tile_ids, out_k, cols_k, dout)))}
    asc = torch.sort(tile_ids).values
    shuf = asc[torch.randperm(asc.shape[0], generator=gen, device="cuda")]
    got = []
    for ids in (asc, shuf):
        out, cols = cs.composite_sorted_fwd(a, seg_start, seg_cnt, ids,
                                            cfg.tile, tiles_x, cfg.bands,
                                            cfg.seg_cap, quad)
        d = dtab[ids.long()].contiguous()
        got.append((k2(ids, out, cols, d), k3(ids, out, cols, d)))
    torch.cuda.synchronize()
    det["K2_tile_order"] = bool(torch.equal(got[0][0], got[1][0]))
    det["K3_tile_order"] = bool(torch.equal(got[0][1], got[1][1]))
    return det


def _entries_bytes(start, count, out, grads=None) -> int:
    """The bytes K5 (grads None) or K6 moves on this run's data: rows 0-9 of
    the entry columns in the chunks K5 composited, start and count, and
    K5's (T, 8, PX) output; K6 instead reads out row 5 and two count cells
    a tile and dout rows 0-4, and writes its whole (16, Epad) output."""
    import torch

    from eags_slam_torch.ops.composite_sorted import CHUNK

    t, _, px = out.shape
    read = int(torch.minimum(count.long(), out[:, 6, 0].long() * CHUNK).sum())
    words = 10 * read + 2 * t
    if grads is None:
        words += out.numel()
    else:
        words += t * (6 * px + 2) + grads.numel()
    return 4 * words


def _compare_entries(out_k, out_t):
    """K5 against its twin: channels 0-5 as K1's check, counts exact,
    chunks used may differ on at most 0.5% of tiles."""
    import torch

    rep, ok = {}, True
    for ch, name in enumerate(("r", "g", "b", "depth", "alpha", "log_t")):
        d = (out_k[:, ch] - out_t[:, ch]).abs()
        ref = out_t[:, ch].abs()
        if name == "depth":
            bad = d > TOL["depth_abs"] + TOL["depth_rel"] * ref
        elif name == "log_t":
            bad = (d > TOL["logt_abs"] + TOL["logt_rel"] * ref) & (
                out_t[:, 5] > -11.5)
        else:
            bad = d > TOL["rgb_alpha_abs"]
        rep[name] = {"max_abs": float(d.max()), "n_bad": int(bad.sum())}
        ok &= rep[name]["n_bad"] == 0
    rep["counts_equal"] = bool(torch.equal(out_k[:, 7], out_t[:, 7]))
    rep["eff_mismatch_frac"] = float(
        (out_k[:, 6, 0] != out_t[:, 6, 0]).float().mean())
    rep["mean_entries"] = float(out_t[:, 7, 0].mean())
    rep["max_entries"] = int(out_t[:, 7, 0].max())
    ok &= rep["counts_equal"] and \
        rep["eff_mismatch_frac"] <= TOL["eff_mismatch_frac"]
    return ok, rep


def _check_entries(cam, gmap, reps, gen):
    """K5 / K6 at the main-path shape of the `pallas` backend (tile 32,
    dup_side 3, entry_cap_factor 4, max_per_tile 8192) on the kernels map:
    the render layout at the map's pose and the frozen binning reprojected
    at the K4 check's shifted tracking pose. Each against its twin; K6 twice
    bit for bit and zero in the columns K5 did not composite; times and
    bounds on both layouts (the summary is the render layout's, the frozen
    binning's beside it)."""
    import torch

    from eags_slam_torch.ops import composite_entries as ce
    from eags_slam_torch.ops import rasterizer as R

    xyz, q, log_s, opac, colors, w2c = gmap
    dev = xyz.device
    cfg = R.RasterConfig(tile=32, dup_side=3, entry_cap_factor=4,
                         max_per_tile=8192, backend="pallas")
    tiles_x = -(-cam.width // cfg.tile)
    with torch.no_grad():
        proj = R.project_gaussians(xyz, q, log_s, opac, w2c, cam, cfg)
        slot, pstart, count = R._build_slots(proj, cam, cfg)
        render_entries = R._gather_entries(R._with_sentinel(
            R._stack_attrs(proj, colors)), slot).contiguous()
        fb = R.freeze_binning(xyz, q, log_s, opac, colors, w2c, cam, cfg)
        pv = torch.tensor([0.9995, 0.01, -0.02, 0.015, 0.01, -0.02, 0.03],
                          device=dev)
        rows = R._reproject_rows(fb.e3d, R._pose_rel_w2c(pv, w2c), cam, cfg)
        frozen_entries = torch.cat([torch.stack(rows[:10]), torch.zeros(
            (6, fb.e3d.shape[1]), device=dev)]).contiguous()
    rep, ok, summary = {}, True, {}
    for label, ent, ps, cnt in (("render", render_entries, pstart, count),
                                ("frozen", frozen_entries, fb.pstart,
                                 fb.count)):
        out_k = ce.composite_entries_fwd(ent, ps, cnt, cfg.tile, tiles_x)
        out_t = ce.composite_entries_fwd_plain(ent, ps, cnt, cfg.tile,
                                               tiles_x)
        torch.cuda.synchronize()
        ok_f, rep_f = _compare_entries(out_k, out_t)
        dout = torch.randn(out_t.shape, generator=gen, device=dev)
        dout[:, 5:] = 0.0
        g_k = ce.composite_entries_bwd(ent, ps, cnt, out_k, dout, cfg.tile,
                                       tiles_x)
        g_k2 = ce.composite_entries_bwd(ent, ps, cnt, out_k, dout, cfg.tile,
                                        tiles_x)
        g_t = ce.composite_entries_bwd_plain(ent, ps, cnt, out_k, dout,
                                             cfg.tile, tiles_x)
        torch.cuda.synchronize()
        ok_b, rep_b, worst = _compare_bwd(g_k, g_t)
        lane = torch.arange(ent.shape[1], device=dev)
        tile_of = torch.clamp(torch.searchsorted(ps, lane.to(torch.int32),
                                                 right=True) - 1, min=0)
        off = lane - ps.long()[tile_of]
        visited = (off >= 0) & (off < 128 * out_k[tile_of, 6, 0].long())
        zeros_ok = float(g_k[:, ~visited].abs().max()) == 0.0
        det_ok = bool(torch.equal(g_k, g_k2))
        r = {"tiles": int(ps.shape[0]), "epad": int(ent.shape[1]),
             "fwd_ok": ok_f, "fwd": rep_f, "bwd_ok": ok_b, "bwd": rep_b,
             "unvisited_zero": zeros_ok, "k6_deterministic": det_ok}
        ok &= ok_f and ok_b and zeros_ok and det_ok
        cols, tile_ids = ce._segments(ps, cnt)
        work = _work(ent, tile_ids, out_k, cols, cfg.tile, tiles_x)
        k6_bound = _bound(_entries_bytes(ps, cnt, out_k, g_k),
                          _ops("K6", work))
        r["k6_ms"] = _median_ms(lambda: ce.composite_entries_bwd(
            ent, ps, cnt, out_k, dout, cfg.tile, tiles_x), reps)
        r["k6_bound_ms"] = k6_bound["bound_ms"]
        r["k5_ms"] = _median_ms(lambda: ce.composite_entries_fwd(
            ent, ps, cnt, cfg.tile, tiles_x), reps)
        k5_bound = _bound(_entries_bytes(ps, cnt, out_k), _ops("K5", work))
        r["k5_bound_ms"] = k5_bound["bound_ms"]
        if label == "frozen":
            # The tracking layout's K5 and K6 beside the render layout's.
            summary["K5"]["frozen"] = {
                "ms": r["k5_ms"], "bound_ms": k5_bound["bound_ms"],
                "max_abs_err": max(rep_f[c]["max_abs"] for c in
                                   ("r", "g", "b", "depth", "alpha"))}
            summary["K6"]["frozen"] = {
                "ms": r["k6_ms"], "bound_ms": k6_bound["bound_ms"],
                "max_abs_err": max(rep_b[c]["max_abs"] for c in rep_b
                                   if isinstance(rep_b[c], dict))}
        if label == "render":
            ok_g, r["gather"], k7 = _check_gather(g_k, slot, xyz.shape[0] + 1,
                                                  reps)
            ok &= ok_g
            r["k5_plain_ms"] = _median_ms(
                lambda: ce.composite_entries_fwd_plain(
                    ent, ps, cnt, cfg.tile, tiles_x), max(3, reps // 4))
            r["k6_plain_ms"] = _median_ms(
                lambda: ce.composite_entries_bwd_plain(
                    ent, ps, cnt, out_k, dout, cfg.tile, tiles_x),
                max(3, reps // 4))
            r["pairs"], r["boxed_pairs"], r["contributing_pairs"] = (
                work["pairs"], work["boxed"], work["contrib"])
            summary = {
                "K5": {"max_abs_err": max(rep_f[c]["max_abs"] for c in
                                          ("r", "g", "b", "depth", "alpha")),
                       "ms": r["k5_ms"], "plain_ms": r["k5_plain_ms"],
                       **k5_bound},
                "K6": {"max_abs_err": max(rep_b[c]["max_abs"] for c in
                                          rep_b if isinstance(rep_b[c], dict)),
                       "ms": r["k6_ms"], "plain_ms": r["k6_plain_ms"],
                       "max_rel_to_rowmax": worst, **k6_bound},
                "K7": k7,
            }
        rep[label] = r
    return ok, rep, summary


def _check_gather(g, slot_gid, n_cols: int, reps: int):
    """K7, the entry gather's backward, on K6's render-layout grads `g`
    and the slot layout `slot_gid` they came from: twice bit for bit,
    against its plain version on the same tensors (the same order of
    additions), the sentinel column zero; timed beside the plain version
    and index_add_ (the library call of the same sum), with its bound:
    g's rows of the entries of a gaussian, slot_gid and the (16, n_cols)
    output moved once, 16 adds an entry. Returns (ok, report, summary)."""
    import torch

    from eags_slam_torch.ops import composite_entries as ce

    d1 = ce.gather_entries_bwd(g, slot_gid, n_cols)
    d2 = ce.gather_entries_bwd(g, slot_gid, n_cols)
    dp = ce.gather_entries_bwd_plain(g, slot_gid, n_cols)
    lib = torch.zeros_like(d1).index_add_(1, slot_gid, g)
    torch.cuda.synchronize()
    err = float((d1 - dp).abs().max())
    scale = max(float(dp.abs().max()), 1e-12)
    lib_err = float((d1[:, :-1] - lib[:, :-1]).abs().max())
    rep = {"entries": int(slot_gid.shape[0]), "columns": n_cols,
           "twice_equal": bool(torch.equal(d1, d2)),
           "plain_equal": bool(torch.equal(d1, dp)), "max_abs_err": err,
           "rel_to_max": err / scale, "index_add_rel_to_max":
           lib_err / max(float(lib[:, :-1].abs().max()), 1e-12),
           "sentinel_zero": float(d1[:, -1].abs().max()) == 0.0}
    ok = (rep["twice_equal"] and rep["sentinel_zero"]
          and rep["rel_to_max"] <= TOL["gather_rel_to_max"])
    summed = int((slot_gid < n_cols - 1).sum())
    bound = _bound(4 * g.shape[0] * summed + _nbytes(slot_gid, d1),
                   g.shape[0] * summed)
    out = {"max_abs_err": err,
           "ms": _median_ms(lambda: ce.gather_entries_bwd(g, slot_gid,
                                                          n_cols), reps),
           "plain_ms": _median_ms(lambda: ce.gather_entries_bwd_plain(
               g, slot_gid, n_cols), max(3, reps // 4)),
           "library_ms": _median_ms(lambda: torch.zeros_like(d1).index_add_(
               1, slot_gid, g), reps), **bound}
    rep.update({k: out[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms")})
    return ok, rep, out


def _run_slam(config, n_frames: int, out_dir: str, phase: str,
              rcfg_env: str = "", prepare=None, dataset=None):
    """Drive GaussianSLAM.run on the config with the launch counts set to 0
    just before and read just after (the main path's, and the loop
    closer's apart); then the port's evaluator. `rcfg_env`: EAGS_RCFG for
    this GaussianSLAM (read when it is built); `prepare(gslam)` runs before
    the counts are zeroed; `dataset`: a frame source in place of the
    config's."""
    import torch

    from eags_slam_torch.evaluation.evaluator import Evaluator
    from eags_slam_torch.lc.loop_closure import LC_TAG
    from eags_slam_torch.ops import composite_entries as ce
    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.slam.gaussian_slam import GaussianSLAM

    os.environ["EAGS_RCFG"] = rcfg_env
    try:
        gslam = GaussianSLAM(config, dataset=dataset)
    finally:
        del os.environ["EAGS_RCFG"]
    try:
        if prepare is not None:
            prepare(gslam)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cs.reset_counts()
        ce.reset_counts()
        report = gslam.run()
        torch.cuda.synchronize()
        launches = {**cs.counts(), **ce.counts()}
        launches_lc = {**cs.counts(LC_TAG), **ce.counts(LC_TAG)}
        by_layout = ce.layout_counts()
        by_variant = cs.variant_counts()
        peak = torch.cuda.max_memory_allocated()
        results = Evaluator(out_dir, gslam.dataset, config).run()
        traj, rend = results["trajectory"], results["rendering"]
    finally:
        gslam.cleanup()
    line = {"phase": phase, "frames": report["frames"],
            "launches": launches, "launches_lc": launches_lc,
            "launches_by_layout": by_layout,
            "launches_by_variant": by_variant,
            "ate_cm": 100.0 * traj["ate"]["rmse"],
            "ate_aligned_cm": 100.0 * traj["ate_aligned"]["rmse"],
            "rpe_cm": 100.0 * traj["rpe"]["rpe_trans_rmse"],
            "psnr_db": rend["mean_psnr"], "ssim": rend["mean_ssim"],
            "ms_ssim": rend["mean_ms_ssim"],
            "depth_l1_cm": 100.0 * rend["mean_depth_l1"],
            "psnr_views": rend["num_views"],
            "fps": report["fps"], "total_s": report["total_s"],
            "track_ms": report["track_ms_avg"],
            "map_ms": report["map_ms_avg"],
            "peak_mem_gb": peak / 2**30, "tracker": report["tracker"],
            "map_frames": report.get("map_frames")}
    ok = (all(launches[k] == 0 and launches_lc[k] == 0 for k in TWIN_KEYS)
          and report["frames"] == n_frames)
    return ok, line, report, gslam


def phase_slice(per_wall: int, n_frames: int, out_dir: str,
                window: bool = False, slice_line=None,
                pose_kernel: bool = False):
    """The slice, on the default sorted configuration (K1 + K2) or, as the
    `window` phase, with `mapping.rmw_window` on, which routes every
    backward of the sorted path (tracking without K4, and mapping) through
    K3, or, as the `slice_k4` phase, with `tracking.pose_grad_kernel` on,
    which takes every tracking backward to K4; those lines print the
    default slice's numbers beside their own. Gate: K1 and the backward's
    kernels launched (no K2 launch in the window phase), no twin; every
    frame ran; ATE < 5 cm and PSNR > 20 dB."""
    phase = "window" if window else "slice_k4" if pose_kernel else "slice"
    config = bench_config(out_dir, n_frames, per_wall)
    config["mapping"]["rmw_window"] = window
    config["tracking"]["pose_grad_kernel"] = pose_kernel
    ok, line, _, gslam = _run_slam(config, n_frames, out_dir, phase)
    la = line["launches"]
    ok &= (gslam.rcfg.rmw_window == window and la["fwd_launches"] > 0
           and (la["window_launches"] > 0 and la["bwd_launches"] == 0
                if window else la["bwd_launches"] > 0)
           and (la["pose_launches"] > 0) == pose_kernel
           and line["ate_cm"] < 5.0 and line["psnr_db"] > 20.0)
    extra = {}
    if window or pose_kernel:
        extra["default_slice"] = None if slice_line is None else {
            k: slice_line[k] for k in ("fps", "track_ms", "map_ms", "ate_cm",
                                       "psnr_db")}
    emit({**line, "ok": ok, "scene_gaussians": gslam.dataset.n_scene,
          **extra})
    if not ok:
        raise SystemExit(phase + " check failed")
    return line


def phase_slice_opts(per_wall: int, n_frames: int, out_dir: str,
                     slice_line=None):
    """The slice's frames with `mapping.kernel_quadform`,
    `mapping.kernel_bf16` and `tracking.pose_grad_kernel`: tracking through
    K1 + K4 and mapping through K1 + K2, every launch the quadform_bf16
    variant. Gate: the variant launched for K1, K2 and K4, no launch of a
    default variant, no twin; every frame ran; ATE < 5 cm and PSNR > 20
    dB. The default slice's numbers are printed beside these."""
    config = bench_config(out_dir, n_frames, per_wall)
    config["mapping"].update({"kernel_quadform": True, "kernel_bf16": True})
    config["tracking"]["pose_grad_kernel"] = True
    ok, line, _, gslam = _run_slam(config, n_frames, out_dir, "slice_opts")
    lv = line["launches_by_variant"]
    ok &= (gslam.rcfg.kernel_quadform and gslam.rcfg.kernel_bf16
           and all(lv[k]["quadform_bf16"] > 0 for k in ("K1", "K2", "K4"))
           and all(lv[k][v] == 0 for k in lv
                   for v in ("default", "quadform", "bf16"))
           and line["ate_cm"] < 5.0 and line["psnr_db"] > 20.0)
    emit({**line, "ok": ok, "scene_gaussians": gslam.dataset.n_scene,
          "default_slice": None if slice_line is None else {
              k: slice_line[k] for k in ("fps", "track_ms", "map_ms",
                                         "peak_mem_gb", "ate_cm",
                                         "psnr_db")}})
    if not ok:
        raise SystemExit("slice_opts check failed")
    return line


# The mapper's tile subset in the slice_mapopts phase: a third of the
# 836-tile grid (the 8-of-24 ratio of tests/test_mapper_subset.py), and
# the half-resolution init of tests/test_init_halfres.py.
MAP_TILE_SUBSET = 279
HALFRES_FRAC = 0.25


def phase_slice_mapopts(per_wall: int, n_frames: int, out_dir: str,
                        slice_line=None):
    """The slice's frames with `mapping.tile_subset` 279,
    `mapping.init_halfres_frac` 0.25 and `tracking.debug_per_iter`. The
    mapper's render_tiles calls are recorded (camera, tiles, K1 launched).
    Gate: ATE < 5 cm and PSNR > 20 dB; the half-resolution phase ran at
    every new submap, on the 600x340 camera (all its 209 tiles at tile 32,
    fewer than the subset) through K1; every mapped iteration at full
    resolution rendered exactly 279 tiles and the recorded iterations are the mapping records'; one
    per-iteration record a tracked frame in log.jsonl, 12 columns, as many
    active rows as the frame's iterations; no twin."""
    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.slam import mapper as M

    config = bench_config(out_dir, n_frames, per_wall)
    config["mapping"].update({"tile_subset": MAP_TILE_SUBSET,
                              "init_halfres_frac": HALFRES_FRAC})
    config["tracking"]["debug_per_iter"] = True
    calls = []
    render_tiles = M.render_tiles

    def recording(*args, **kw):
        cam, before = args[7], cs.counts()["fwd_launches"]
        out = render_tiles(*args, **kw)
        calls.append((cam.width, cam.height, int(args[6].shape[0]),
                      cs.counts()["fwd_launches"] > before))
        return out

    M.render_tiles = recording
    try:
        ok, line, _, gslam = _run_slam(config, n_frames, out_dir,
                                       "slice_mapopts",
                                       prepare=lambda g: calls.clear())
    finally:
        M.render_tiles = render_tiles
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        log = [json.loads(r) for r in f]
    maps = [r for r in log if r["kind"] == "mapping"]
    track = {r["frame"]: r for r in log if r["kind"] == "tracking"}
    per = {r["frame_id"]: r for r in log if r["kind"] == "track_iters"}
    w, h = gslam.cam.width, gslam.cam.height
    half = [c for c in calls if (c[0], c[1]) == (w // 2, h // 2)]
    full = [c for c in calls if (c[0], c[1]) == (w, h)]
    ts = gslam.rcfg.tile
    n_half_tiles = -(-(w // 2) // ts) * -(-(h // 2) // ts)
    iters_ok = all(
        len(r["iters"]) == 2 * gslam.tcfg.iterations
        and len(r["names"]) == len(r["iters"][0]) == 12
        and sum(row[4] for row in r["iters"]) == track[f]["iters"]
        for f, r in per.items())
    new_ok = all(m["halfres_iters"] > 0 for m in maps if m["is_new"])
    ok &= (len(half) + len(full) == len(calls)
           and len(calls) == sum(m["iterations"] for m in maps)
           and sum(m["halfres_iters"] for m in maps) == len(half) > 0
           and new_ok and all(c[2] == n_half_tiles and c[3] for c in half)
           and all(c[2] == MAP_TILE_SUBSET and c[3] for c in full)
           and set(per) == set(track) and iters_ok
           and line["ate_cm"] < 5.0 and line["psnr_db"] > 20.0)
    emit({**line, "ok": ok, "scene_gaussians": gslam.dataset.n_scene,
          "mapped_iterations": {"full_res": len(full), "half_res": len(half),
                                "tiles_full": sorted({c[2] for c in full}),
                                "tiles_half": sorted({c[2] for c in half})},
          "halfres_iters": [m["halfres_iters"] for m in maps],
          "new_submaps": sum(1 for m in maps if m["is_new"]),
          "track_iters_records": len(per),
          "default_slice": None if slice_line is None else {
              k: slice_line[k] for k in ("fps", "track_ms", "map_ms",
                                         "peak_mem_gb", "ate_cm",
                                         "psnr_db")}})
    if not ok:
        raise SystemExit("slice_mapopts check failed")
    return line


def phase_c2f(n_frames: int, out_dir: str):
    """Gate: K4 launched and no twin; the odometer candidate won at least
    one frame; every frame ran; ATE < 5 cm, PSNR > 19 dB and SSIM > 0.55
    (the reference's bounds, tests/test_e2e_synthetic.py and
    tests/test_e2e_hard.py:80-82)."""
    ok, line, report, gslam = _run_slam(c2f_config(out_dir, n_frames),
                                        n_frames, out_dir, "c2f")
    wins = report["tracker"]["init_pose_cnt"].get("odometer", 0)
    vo = report["vo"]
    ok &= (line["launches"]["fwd_launches"] > 0
           and line["launches"]["bwd_launches"] > 0
           and line["launches"]["pose_launches"] > 0 and wins >= 1
           and line["ate_cm"] < 5.0 and line["psnr_db"] > 19.0
           and line["ssim"] > 0.55)
    # The submap boundary at frame 20 starts submap 1 from the visible
    # gaussians of submap 0 when enough are visible (init_warm_start).
    line = {**line, "vo_ms": vo["mean_track_ms"],
            "vo_wait_ms": _mean_log(out_dir, "tracking", "vo_wait_ms")}
    emit({**line, "ok": ok, "odometer_wins": wins,
          "submaps": gslam.submap_id + 1, "warm_started": gslam._warm_inited,
          "vo_keyframes": vo["n_keyframes"],
          "vo_dt_host_ms": vo["mean_dt_ms"]})
    if not ok:
        raise SystemExit("c2f check failed")
    return line


REPEAT_METRICS = ("ate_cm", "ate_aligned_cm", "psnr_db", "ssim", "ms_ssim",
                  "depth_l1_cm")


def phase_repeat(n_frames: int, out_dir: str, c2f_dir: str, c2f_line):
    """c2f again, the same config and seeds, into another directory. Gate:
    `evaluation.pose_spread` over the two finds no differing frame in the
    poses, the VO trajectory, or any mapping or tracking record of
    log.jsonl (timings left out), and the evaluator's ATE, PSNR, SSIM,
    MS-SSIM and depth-L1 are equal; K1 / K2 / K4 launched, no twin."""
    from eags_slam_torch.evaluation.pose_spread import pose_spread

    if c2f_line is None:
        raise SystemExit("repeat runs c2f again: run both")
    ok, line, _, _ = _run_slam(c2f_config(out_dir, n_frames), n_frames,
                               out_dir, "repeat")
    spread = pose_spread(c2f_dir, out_dir)
    firsts = {"poses": spread["poses"]["first_differing_frame"],
              "vo": spread["vo"]["first_differing_frame"]
              if "vo" in spread else "missing"}
    for kind in ("mapping", "tracking"):
        rec = spread.get(kind)
        firsts[kind] = ("missing" if rec is None or rec["frames"] == 0
                        else rec["first_difference"])
    equal = {k: line[k] == c2f_line[k] for k in REPEAT_METRICS}
    ok &= (all(v is None for v in firsts.values()) and all(equal.values())
           and spread["poses"]["frames"] == n_frames
           and all(line["launches"][LAUNCH_KEYS[k]] > 0
                   for k in ("K1", "K2", "K4")))
    emit({**line, "ok": ok, "first_differences": firsts,
          "metrics_equal": equal,
          "records": {k: spread[k]["frames"] for k in ("mapping", "tracking")
                      if k in spread},
          "c2f": {k: c2f_line[k] for k in REPEAT_METRICS + ("fps",)}})
    if not ok:
        raise SystemExit("repeat check failed")
    return line


def _grad_err(got: dict, want: dict) -> dict:
    """Per leaf: max |got - want| over the tolerance rtol 2e-3 |want| +
    1e-3 max |want| (<= 1 passes; module docstring, mesh)."""
    out = {}
    for k, w in want.items():
        tol = 2e-3 * w.abs() + 1e-3 * float(w.abs().max())
        out[k] = float(((got[k] - w).abs() / tol.clamp(min=1e-30)).max())
    return out


def _check_mesh_steps(gslam, frame, last_c2w, c2w) -> dict:
    """The world-size-1 sp_map_step and sp_track_refine on the card against
    the port's single-device functions on the same inputs: the mesh run's
    final map, its last frame at its estimated pose (mapping) and from the
    frame before (tracking). Loss within 1e-4; gradients within `_grad_err`
    (rtol 2e-3, plus 1e-3 of the leaf's largest for K2's run-dependent
    float atomics, as the kernels check's grad tolerance); the whole
    refinement's pose and exposure deviation printed (not gated)."""
    import numpy as np
    import torch

    from eags_slam_torch.core.gaussians import OPT_KEYS, GaussianState
    from eags_slam_torch.core.sh import sh_to_rgb
    from eags_slam_torch.ops.losses import isotropic_loss, ssim_batched
    from eags_slam_torch.ops.rasterizer import gt_tiles, render_tiles
    from eags_slam_torch.parallel import mesh as P
    from eags_slam_torch.slam import tracker as T
    from eags_slam_torch.utils import optim

    cam, rcfg, mesh = gslam.cam, gslam.rcfg, gslam.mesh
    color, depth = frame
    dev = color.device
    st = GaussianState(gslam.state.params, gslam.state.alive,
                       optim.adam_init({k: getattr(gslam.state.params, k)
                                        for k in OPT_KEYS}))
    w2c = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32,
                          device=dev)
    step, init_adam, _ = P.sp_map_step(mesh, cam, rcfg, gslam.mcfg)
    _, _, loss_sp, g_sp = step(st, init_adam(st), color, depth, w2c)
    # The single-device full-grid map loss (the tile-subset mapping loss
    # over every tile).
    ts = rcfg.tile
    tiles_x, tiles_y = -(-cam.width // ts), -(-cam.height // ts)
    ids = torch.arange(tiles_x * tiles_y, dtype=torch.int32, device=dev)
    leaves = {k: getattr(st.params, k).detach().clone().requires_grad_(True)
              for k in OPT_KEYS}
    out = render_tiles(leaves["xyz"], leaves["quats"], leaves["log_scales"],
                       leaves["opacity_logits"], sh_to_rgb(st.params.f_dc),
                       w2c, ids, cam, rcfg, alive=st.alive)
    gt_c = gt_tiles(color, ids, ts, tiles_x, tiles_y)
    gt_d = gt_tiles(depth, ids, ts, tiles_x, tiles_y)
    valid = T._in_image_mask(ids, ts, tiles_x, cam)
    m = ((gt_d > 0) & ~torch.isnan(out.depth) & valid).to(torch.float32)
    lam = gslam.mcfg.lambda_dssim
    loss = ((1 - lam) * (torch.abs(out.color - gt_c) * m[..., None]).sum()
            / torch.clamp(m.sum() * 3.0, min=1.0)
            + lam * (1 - ssim_batched(torch.clamp(out.color, 0.0, 1.0),
                                      gt_c).mean())
            + (torch.abs(out.depth - gt_d) * m).sum()
            / torch.clamp(m.sum(), min=1.0)
            + isotropic_loss(leaves["log_scales"], st.alive))
    gs = torch.autograd.grad(loss, [leaves[k] for k in OPT_KEYS])
    alive = st.alive.to(torch.float32)
    g_ref = {k: g * alive.reshape((-1,) + (1,) * (g.dim() - 1))
             for k, g in zip(OPT_KEYS, gs)}
    map_check = {"loss": float(loss_sp), "loss_ref": float(loss.detach()),
                 "grad_err": _grad_err(g_sp, g_ref)}

    # Tracking: the refinement's loss and pose gradient at the init pose,
    # then the whole refinement, against the tracker's own full-grid
    # refinement (its tile-subset path over every tile, K1 + K2).
    tcfg = gslam.tcfg._replace(pose_grad_kernel=False)
    last_w2c = torch.as_tensor(np.linalg.inv(last_c2w), dtype=torch.float32,
                               device=dev)
    init_rel = torch.as_tensor(np.linalg.inv(c2w) @ last_c2w,
                               dtype=torch.float32, device=dev)
    init_rel[:3, 3] += 0.01
    refine, aux = P.sp_track_refine(mesh, cam, rcfg, tcfg)
    p = st.params
    ref_fn = T._make_loss_fn(
        p, st.alive, sh_to_rgb(p.f_dc), init_rel, last_w2c, color, depth,
        cam, rcfg, tcfg, subset=(ids, gt_c, gt_d, valid))
    sp_fn = aux["make_loss"](p, st.alive, init_rel, last_w2c, color, depth)
    pose0 = {"quat": T.rotmat_to_quat(init_rel[:3, :3]),
             "trans": init_rel[:3, 3].clone(),
             "exposure": torch.tensor([0.02, -0.01], device=dev)}
    res = []
    for fn in (sp_fn, ref_fn):
        leaf = {k: v.clone().requires_grad_(True) for k, v in pose0.items()}
        total, _ = fn(leaf)
        g = torch.autograd.grad(total, [leaf["quat"], leaf["trans"],
                                        leaf["exposure"]])
        res.append((float(total.detach()),
                    dict(zip(("quat", "trans", "exposure"), g))))
    iters = tcfg.iterations
    rel_sp, exp_sp, stats_sp = refine(p, st.alive, init_rel, last_w2c, color,
                                      depth, torch.zeros(2, device=dev),
                                      iters)
    rel_ref, exp_ref, stats_ref, _ = T._refine(
        ref_fn, init_rel, iters, torch.zeros(2, device=dev), tcfg)
    track_check = {
        "loss": res[0][0], "loss_ref": res[1][0],
        "grad_err": _grad_err(res[0][1], res[1][1]),
        "refine_iters": [float(stats_sp[3]), float(stats_ref[3])],
        "refine_rel_max_dev": float((rel_sp - rel_ref).abs().max()),
        "refine_exposure_max_dev": float((exp_sp - exp_ref).abs().max()),
        "refine_best_loss": [float(stats_sp[0]), float(stats_ref[0])]}
    ok = all(abs(c["loss"] - c["loss_ref"]) < 1e-4
             and max(c["grad_err"].values()) <= 1.0
             for c in (map_check, track_check))
    return {"ok": ok, "sp_map_step": map_check,
            "sp_track_refine": track_check}


def phase_mesh(n_frames: int, out_dir: str, c2f_line):
    """The mesh path on one card: a one-rank NCCL process group, then
    bench.py's quick protocol (the c2f phase's configuration) with
    EAGS_BENCH_MESH=1 (force_mesh: the mapping's mesh path, the plain loop)
    and EAGS_SP_TRACK=1 (the tracking refinement tile-split over the mesh,
    K1 + K2 on the full grid, no K4 whatever pose_grad_kernel says). Gate:
    the group is NCCL at world size 1, the mesh was built with the split
    refinement, K1 and K2 launched and no twin, no K4 launch, every frame
    ran, ATE < 5 cm, PSNR > 19 dB and SSIM > 0.55 (tests/test_e2e_hard.py's
    bounds), and the world-size-1 sp_map_step / sp_track_refine held
    against the single-device functions (`_check_mesh_steps`). Prints FPS,
    track / map ms, peak memory and the collectives a frame beside c2f's
    numbers from the same call."""
    import torch
    import torch.distributed as dist

    from eags_slam_torch.bench import make_config
    from eags_slam_torch.parallel import mesh as P

    P.init_process_group(torch.device("cuda"))
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise SystemExit("mesh: no one-rank NCCL group")
        os.environ["EAGS_BENCH_MESH"] = "1"
        try:
            config = make_config(n_frames, out_dir, lc=False)
        finally:
            del os.environ["EAGS_BENCH_MESH"]
        config.pop("bench_deadline_ts")
        config["tracking"]["pose_grad_kernel"] = True   # as in c2f
        kept = {}

        def keep_last_frames(gslam):
            run = gslam.run

            def run_and_keep():
                report = run()
                n = report["frames"]
                kept["frame"] = gslam.dataset.frame(n - 1)
                kept["c2ws"] = gslam.estimated_c2ws[n - 2: n].copy()
                return report
            gslam.run = run_and_keep

        os.environ["EAGS_SP_TRACK"] = "1"
        try:
            ok, line, report, gslam = _run_slam(config, n_frames, out_dir,
                                                "mesh",
                                                prepare=keep_last_frames)
        finally:
            del os.environ["EAGS_SP_TRACK"]
        checks = _check_mesh_steps(gslam, kept["frame"], kept["c2ws"][0],
                                   kept["c2ws"][1])
    finally:
        dist.destroy_process_group()
    la = line["launches"]
    mesh = report["mesh"]
    frames = max(report["frames"], 1)
    ok &= (mesh["size"] == 1 and mesh["sp_track"] and mesh["replicated"]
           and la["fwd_launches"] > 0 and la["bwd_launches"] > 0
           and la["pose_launches"] == 0 and line["ate_cm"] < 5.0
           and line["psnr_db"] > 19.0 and line["ssim"] > 0.55
           and checks["ok"])
    emit({**line, "ok": ok, "backend": "nccl", "world_size": 1,
          "collectives": mesh["collectives"],
          "collectives_per_frame": {k: v / frames for k, v in
                                    mesh["collectives"].items()},
          "checks": checks,
          "c2f_same_call": None if c2f_line is None else {
              k: c2f_line[k] for k in ("fps", "track_ms", "map_ms",
                                       "peak_mem_gb", "ate_cm", "psnr_db",
                                       "ssim")}})
    if not ok:
        raise SystemExit("mesh check failed")
    return line


def _closer_overlap(out_dir: str, latencies) -> dict:
    """The SLAM loop's tracking and mapping ms a frame (log.jsonl), split by
    whether a loop-closer pass was in flight (its wall-clock span from
    `t_start` and `total_ms`) while the stage ran. Tracking is the `track`
    stage less the VO's step or wait inside it."""
    import numpy as np

    spans = [(e["t_start"], e["t_start"] + e["total_ms"] / 1e3)
             for e in latencies]
    split = {(k, b): [] for k in ("track", "map") for b in (True, False)}
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            key = {"tracking": ("track", "track_frame_ms"),
                   "mapping": ("map", "map_ms")}.get(r.get("kind"))
            if key is None or key[1] not in r:
                continue
            t1 = r["t"]
            t0 = t1 - r[key[1]] / 1e3
            busy = any(t0 < e and t1 > s for s, e in spans)
            split[(key[0], busy)].append(r[key[1]]
                                         - r.get("vo_wait_ms", 0.0))
    return {f"{k}_ms_closer_{'busy' if b else 'idle'}":
            {"mean": float(np.mean(v)) if v else None, "frames": len(v)}
            for (k, b), v in split.items()}


def phase_lc(n_frames: int, out_dir: str, c2f_line):
    """bench.py's full protocol with loop closure on its own thread and
    stream (`eags_slam_torch.bench.make_config`, no deadline). Gate: the
    main path launched K1 and K2 and the closer launched K1 and K2 apart,
    no twin; every frame ran; ATE < 5 cm, PSNR > 19 dB and SSIM > 0.55; at
    least one
    closure; its corrections drained into the live pose array; the files
    of the submaps it corrected rewritten (T_prev_m no longer the one saved
    at the boundary). An exception on the closer's thread fails the run.
    c2f's track / map ms from the same call print beside."""
    import numpy as np

    from eags_slam_torch.bench import make_config
    from eags_slam_torch.slam.submap import Submap

    config = make_config(n_frames, out_dir)
    config.pop("bench_deadline_ts")
    saved = {}

    def snapshot_at_submit(gslam):
        closer = gslam.loop_closer
        submit = closer.submit

        def submit_and_snapshot(submap_id, frame_id, c2ws):
            path = os.path.join(out_dir, "submaps", f"{submap_id:06d}.npz")
            saved[submap_id] = Submap.load(path).T_prev_m
            return submit(submap_id, frame_id, c2ws)

        closer.submit = submit_and_snapshot

    ok, line, report, gslam = _run_slam(config, n_frames, out_dir, "lc",
                                        prepare=snapshot_at_submit)
    lc = report["lc"]
    rewritten = sorted(
        sid for sid, T in saved.items() if not np.allclose(
            Submap.load(os.path.join(out_dir, "submaps",
                                     f"{sid:06d}.npz")).T_prev_m, T,
            atol=1e-9))
    la, ll = line["launches"], line["launches_lc"]
    ok &= (la["fwd_launches"] > 0 and la["bwd_launches"] > 0
           and ll["fwd_launches"] > 0 and ll["bwd_launches"] > 0
           and lc["n_closures"] >= 1 and lc["corrections_applied"] > 0
           and len(rewritten) > 0
           and line["ate_cm"] < 5.0 and line["psnr_db"] > 19.0
           and line["ssim"] > 0.55)
    lat = [{k: v for k, v in entry.items()
            if k in ("submap_id", "n_matches", "detect_ms", "register_ms",
                     "register_phases", "pgo_solve_ms", "pgo_ms",
                     "total_ms")} for entry in lc["latencies"]]
    emit({**line, "ok": ok, "vo_ms": report["vo"]["mean_track_ms"],
          "n_submits": lc["n_submits"], "n_closures": lc["n_closures"],
          "submit_ms_mean": lc["submit_ms_mean"],
          "submit_ms_max": lc["submit_ms_max"],
          "register_ms_mean": lc["register_ms_mean"],
          "pgo_solve_ms": [e["pgo_solve_ms"] for e in lc["latencies"]
                           if "pgo_solve_ms" in e],
          "lc_drain_s": report["stage_totals_s"]["lc_drain"],
          "corrections_applied": lc["corrections_applied"],
          "submaps_rewritten": rewritten, "latencies": lat,
          "main_loop_vs_closer": _closer_overlap(out_dir, lc["latencies"]),
          "c2f_same_call": None if c2f_line is None else {
              k: c2f_line[k] for k in ("fps", "track_ms", "map_ms")}})
    if not ok:
        raise SystemExit("lc check failed")
    return line


# The global refine's renders: the evaluator's raster settings (tile 16,
# dup_side 4, seg_cap 1024, bands 3) on the full bench camera, and
# bench.py's refine length.
GLOBAL_ITERS = 2000


def _finite(obj) -> bool:
    """Every number in a (nested) JSON-like object is finite."""
    import math

    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_finite(v) for v in obj)
    if isinstance(obj, float):
        return math.isfinite(obj)
    return True


def _check_global_shape(ev, reps: int):
    """K1 and K2 against their twins at the global refine's shape: the
    merged map of the run's submaps as the refine starts (degree-0
    colours, all alive), rendered at the middle keyframe on the full
    image at the evaluator's raster settings. The tolerances of the
    kernels phase; median times of both and of the twins; bounds; the
    tiles whose bands seg_cap clips. Returns (ok, report, {kid: entry})."""
    import numpy as np
    import torch

    from eags_slam_torch.core.sh import sh_to_rgb
    from eags_slam_torch.evaluation.merged_map import merge_submaps
    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.ops import rasterizer as R

    dicts, kf_ids = [], []
    for sm, _, world in ev._world_submaps():
        dicts.append(world)
        kf_ids.extend(int(f) for f in sm.kf_frame_ids)
    merged = merge_submaps(dicts)
    kf_ids = sorted(set(kf_ids))
    fid = kf_ids[len(kf_ids) // 2]
    cam, cfg = ev.cam, ev.rcfg
    g = {k: torch.as_tensor(v, device="cuda") for k, v in merged.items()}
    w2c = torch.as_tensor(np.linalg.inv(ev.estimated_c2ws[fid]),
                          dtype=torch.float32, device="cuda")
    with torch.no_grad():
        proj = R.project_gaussians(g["xyz"], g["quats"], g["log_scales"],
                                   g["opacity_logits"], w2c, cam, cfg,
                                   radius_cap=R._v2_radius_cap(cfg))
        attrs, seg_start, seg_cnt = R._sorted_attrs(
            proj, sh_to_rgb(g["f_dc"]), cam, cfg)
        attrs = attrs.contiguous()
        # The same segments without the seg_cap clip.
        _, _, cnt_all = R._center_sort(proj, cam, cfg._replace(
            seg_cap=1 << 30))
    tiles_x, tiles_y = R._tiles(cam, cfg)
    T = tiles_x * tiles_y
    tile_ids = torch.arange(T, dtype=torch.int32, device="cuda")
    args = (attrs, seg_start, seg_cnt, tile_ids, cfg.tile, tiles_x,
            cfg.bands, cfg.seg_cap)
    out_k, cols_k = cs.composite_sorted_fwd(*args)
    out_t, cols_t = cs.composite_sorted_fwd_plain(*args)
    torch.cuda.synchronize()
    ok_f, rep_f = _compare_fwd(out_k, cols_k, out_t, cols_t)
    gen = torch.Generator(device="cuda").manual_seed(2)
    dout = torch.randn(out_t.shape, generator=gen, device="cuda")
    dout[:, 5:] = 0.0
    g_k = cs.composite_sorted_bwd(attrs, tile_ids, out_k, cols_k, dout,
                                  cfg.tile, tiles_x, cfg.bands)
    g_t = cs.composite_sorted_bwd_plain(attrs, tile_ids, out_t, cols_t,
                                        dout, cfg.tile, tiles_x, cfg.bands)
    torch.cuda.synchronize()
    ok_b, rep_b, worst = _compare_bwd(g_k, g_t)
    work = _work(attrs, tile_ids, out_k, cols_k, cfg.tile, tiles_x)
    k1_bound = _bound(_nbytes(attrs, seg_start, seg_cnt, tile_ids, out_k,
                              cols_k), _ops("K1", work))
    k2_bound = _bound(_nbytes(attrs, tile_ids, out_k, cols_k, dout, g_k),
                      _ops("K2", work))
    k1_ms = _median_ms(lambda: cs.composite_sorted_fwd(*args), reps)
    k2_ms = _median_ms(lambda: cs.composite_sorted_bwd(
        attrs, tile_ids, out_k, cols_k, dout, cfg.tile, tiles_x, cfg.bands),
        reps)
    k1_plain = _median_ms(lambda: cs.composite_sorted_fwd_plain(*args),
                          max(3, reps // 4))
    k2_plain = _median_ms(lambda: cs.composite_sorted_bwd_plain(
        attrs, tile_ids, out_t, cols_t, dout, cfg.tile, tiles_x, cfg.bands),
        max(3, reps // 4))
    clipped = int((cnt_all > seg_cnt).any(1).sum())
    entries = {
        "K1": {"tiles": T, "ms": k1_ms, "plain_ms": k1_plain,
               "bound_ms": k1_bound["bound_ms"],
               "bound_by": k1_bound["bound_by"],
               "bound_share": k1_bound["bound_ms"] / k1_ms,
               "max_abs_err": max(rep_f[c]["max_abs"] for c in
                                  ("r", "g", "b", "depth", "alpha"))},
        "K2": {"tiles": T, "ms": k2_ms, "plain_ms": k2_plain,
               "bound_ms": k2_bound["bound_ms"],
               "bound_by": k2_bound["bound_by"],
               "bound_share": k2_bound["bound_ms"] / k2_ms,
               "max_rel_to_rowmax": worst,
               "max_abs_err": max(rep_b[c]["max_abs"] for c in rep_b
                                  if isinstance(rep_b[c], dict))}}
    rep = {"shape": {"H": cam.height, "W": cam.width, "tile": cfg.tile,
                     "bands": cfg.bands, "seg_cap": cfg.seg_cap, "tiles": T,
                     "npad": int(attrs.shape[1]), "keyframe": fid},
           "merged_gaussians": int(merged["xyz"].shape[0]),
           "visible_gaussians": int((proj.radius > 0).sum()),
           "mean_survivors": rep_f["mean_survivors"],
           "max_survivors": rep_f["max_survivors"],
           "clipped_tiles": clipped,
           "pairs": work["pairs"], "boxed_pairs": work["boxed"],
           "contributing_pairs": work["contrib"],
           "fwd_ok": ok_f, "fwd": rep_f, "bwd_ok": ok_b, "bwd": rep_b,
           "bounds": {"K1": k1_bound, "K2": k2_bound}, **{
               kid: {k: e[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_share")}
               for kid, e in entries.items()}}
    return ok_f and ok_b, rep, entries


def phase_heavy(n_frames: int, lc_dir: str, lc_line, reps: int):
    """bench.py's heavy evaluation on the lc phase's output directory at
    the evaluator's defaults (module docstring, phase 10), after K1 / K2
    are held against their twins at the global shape. The launch counts
    are set to 0 just before the reconstruction and read just after the
    refine, whose K1 / K2 launches count under the tag "global" (every
    launch on the card's current stream while it runs). Gate: faces > 0,
    F1 > 0.4, global PSNR > 19 dB (the lc phase's own gate), every
    number finite, no twin, the refine's K1 / K2 launched at least once
    an iteration, and mesh/global_splats.ply read back with the alive
    count. Returns (line, {kid: global-shape entry})."""
    import numpy as np
    import torch

    from eags_slam_torch.bench import make_config
    from eags_slam_torch.datasets import get_dataset
    from eags_slam_torch.evaluation.evaluator import Evaluator
    from eags_slam_torch.lc.loop_closure import LC_TAG
    from eags_slam_torch.ops import composite_entries as ce
    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.utils.ply import load_gaussian_ply

    config = make_config(n_frames, lc_dir)
    config.pop("bench_deadline_ts")
    config["evaluation"].update({"eval_mesh": True, "eval_global": True,
                                 "global_refine_iters": GLOBAL_ITERS})
    t0 = time.perf_counter()
    dataset = get_dataset(config["data"]["dataset_name"])(config,
                                                          device="cuda")
    dataset_s = time.perf_counter() - t0
    try:
        ev = Evaluator(lc_dir, dataset, config)
        ok_k, rep_k, k12 = _check_global_shape(ev, reps)
        emit({"phase": "heavy_kernels", "ok": ok_k, "tolerances": TOL,
              **rep_k})
        if not ok_k:
            raise SystemExit("heavy: kernel vs twin check at the global "
                             "shape failed")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cs.reset_counts()
        ce.reset_counts()
        t0 = time.perf_counter()
        rec = ev.run_reconstruction_eval()
        recon_s = time.perf_counter() - t0
        peak_recon = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        stream = torch.cuda.current_stream()
        t0 = time.perf_counter()
        with cs.counting_as("global", stream):
            glob = ev.run_global_map_eval()
        torch.cuda.synchronize()
        global_s = time.perf_counter() - t0
        peak_global = torch.cuda.max_memory_allocated()
        launches = {**cs.counts(), **ce.counts()}
        launches_lc = {**cs.counts(LC_TAG), **ce.counts(LC_TAG)}
        launches_global = {**cs.counts("global"), **ce.counts("global")}
        by_layout = ce.layout_counts()
        by_variant = cs.variant_counts()
    finally:
        dataset.close()
    splats = load_gaussian_ply(os.path.join(lc_dir, "mesh",
                                            "global_splats.ply"))
    refine_s = glob["stage_s"]["refine"]
    line = {
        "phase": "heavy", "launches": launches, "launches_lc": launches_lc,
        "launches_global": launches_global, "launches_by_layout": by_layout,
        "launches_by_variant": by_variant, "dataset_s": dataset_s,
        "recon": {k: rec[k] for k in (
            "grid_dims", "n_keyframes", "integrate_ms", "stage_s",
            "n_vertices", "n_faces", "gt_source", "accuracy", "completion",
            "precision", "recall", "f1", "depth_l1_sample_view")},
        "recon_s": recon_s, "peak_mem_gb_recon": peak_recon / 2**30,
        "global": {
            "iterations": glob["iterations"], "seconds": global_s,
            "refine_s": refine_s,
            "ms_per_iter": 1e3 * refine_s / glob["iterations"],
            "stage_s": glob["stage_s"], "psnr_db": glob["mean_psnr"],
            "ssim": glob["mean_ssim"], "ms_ssim": glob["mean_ms_ssim"],
            "views": glob["num_views"],
            "alive_before": glob["n_gaussians"],
            "alive_after": glob["n_alive"],
            "splats_rows": int(splats["xyz"].shape[0])},
        "submap_psnr_db": None if lc_line is None else lc_line["psnr_db"],
        "peak_mem_gb_global": peak_global / 2**30,
        "global_shape": {kid: {k: e[k] for k in ("ms", "bound_ms",
                                                 "bound_share")}
                         for kid, e in k12.items()},
    }
    la = launches_global
    ok = (all(launches[k] == 0 and launches_global[k] == 0
              and launches_lc[k] == 0 for k in TWIN_KEYS)
          and rec["n_faces"] > 0 and rec["f1"] > 0.4
          and glob["mean_psnr"] > 19.0 and _finite(line)
          and la["fwd_launches"] >= GLOBAL_ITERS
          and la["bwd_launches"] >= GLOBAL_ITERS
          and launches["fwd_launches"] >= rec["n_keyframes"]
          and splats["xyz"].shape[0] == glob["n_alive"]
          and bool(np.isfinite(splats["xyz"]).all()))
    emit({**line, "ok": ok})
    if not ok:
        raise SystemExit("heavy check failed")
    return line, k12


# The real-data phases: 24 frames a sequence, written in a reader's layout
# and read back through it by the config's own dataset.
TUM_FRAMES = 24
REPLICA_FRAMES = 24


def _inverse_distortion_maps(cam, dist, keep: int, iters: int = 25):
    """Where the pre-distorted capture samples the clean image: for each
    pixel x_d, undistort(x_d) by fixed-point iteration of the forward model
    (tests/test_reader_roundtrip.py). Also the largest residual |distort(x)
    - x_d| in pixels over the pixels the crop of `keep` keeps and over the
    whole image."""
    import numpy as np

    from eags_slam_torch.datasets import distort_points

    u, v = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                       np.arange(cam.height, dtype=np.float64))
    xyd = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy], -1)
    xy = xyd.copy()
    for _ in range(iters):
        xy = xy + (xyd - distort_points(xy, np.asarray(dist)))
    res = np.abs(distort_points(xy, np.asarray(dist)) - xyd) * np.array(
        [cam.fx, cam.fy])
    res = res.max(-1)
    return ((cam.fx * xy[..., 0] + cam.cx).astype(np.float32),
            (cam.fy * xy[..., 1] + cam.cy).astype(np.float32),
            float(res[keep:-keep, keep:-keep].max()), float(res.max()))


def _render_sequence(scene_config, n_frames: int):
    """n_frames of synthetic_hard rendered on the card at the config's
    camera, as host arrays: colour uint8, depth float32, GT c2w."""
    import numpy as np

    from eags_slam_torch.synthetic_hard import SyntheticHard

    cfg = {**scene_config, "frame_limit": n_frames}
    ds = SyntheticHard(cfg, device="cuda")
    frames = [ds.frame_u8(i) for i in range(n_frames)]
    colors = np.stack([c.cpu().numpy() for c, _ in frames])
    depths = np.stack([d.cpu().numpy() for _, d in frames])
    poses = np.stack(ds.poses[:n_frames])
    ds.close()
    return colors, depths, poses


def _run_reader(phase: str, config, n_frames: int, out_dir: str,
                clean0, card: str):
    """Drive a reader config through _run_slam; the gates and the line
    common to the tum and replica phases. `clean0`: frame 0's clean colour
    (uint8, the uncropped render) for the read-back check over the map
    camera's pixels."""
    import numpy as np

    seen = {"vo_shapes": set()}

    def prepare(gslam):
        ds = gslam.dataset
        seen["len"] = len(ds)
        e = ds.crop_edge
        clean = clean0[e:-e, e:-e] if e else clean0
        seen["frame0_mean_abs"] = float(np.abs(
            ds[0][1] - clean.astype(np.float32) / 255.0).mean())
        step = gslam.odometer.step

        def step_and_record(rgb, depth, timestamp):
            seen["vo_shapes"].add(tuple(rgb.shape))
            return step(rgb, depth, timestamp)

        gslam.odometer.step = step_and_record

    ok, line, report, gslam = _run_slam(config, n_frames, out_dir, phase,
                                        prepare=prepare)
    la = line["launches"]
    full = gslam.dataset.full_camera
    seeds = report["seed_edges"]
    extra = {
        "card": card, "dataset": config["data"]["dataset_name"],
        "sequence_frames": seen["len"],
        "frame0_mean_abs": seen["frame0_mean_abs"],
        "map_camera": [gslam.cam.width, gslam.cam.height],
        "full_camera": [full.width, full.height],
        "vo_frame_shapes": sorted(seen["vo_shapes"]),
        "vo_ms": report["vo"]["mean_track_ms"],
        "vo_keyframes": report["vo"]["n_keyframes"],
        "seed_edges": seeds,
        "data_wait_ms": report["data_wait_ms_avg"],
        "reader": report["data"]["reader"],
        "decode_ms": report["data"]["decode_ms_avg"],
        "frames_decoded": report["data"]["decoded"],
        "k1_launches_per_frame": la["fwd_launches"] / report["frames"],
        "k2_launches_per_frame": la["bwd_launches"] / report["frames"],
        "stage_totals_s": report["stage_totals_s"],
    }
    ok &= (seen["len"] == n_frames and seen["frame0_mean_abs"] < 0.02
           and seeds["canny"] == 0 and seeds["vo"] == line["map_frames"]
           and seen["vo_shapes"] == {(full.height, full.width, 3)}
           and la["fwd_launches"] > 0 and la["bwd_launches"] > 0
           and line["ate_cm"] < 5.0 and line["psnr_db"] > 19.0)
    return ok, {**line, **extra}, gslam


def _paeth_decode_ms(root: str, rgb):
    """The port's PNG decode of one 640 x 480 RGB frame written with Paeth
    rows, alone on the host (median of 5, host clock), beside Pillow's
    decode of the same file; the two arrays must be equal."""
    import numpy as np

    from eags_slam_torch.utils.image_io import read_png, write_png

    path = os.path.join(root, "paeth.png")
    write_png(path, rgb, 4)

    def median_ms(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[2], out

    port_ms, img = median_ms(lambda: read_png(path))
    res = {"port_ms": port_ms, "pillow_ms": None,
           "equal": bool(np.array_equal(img, rgb))}
    try:
        from PIL import Image
    except ImportError:
        return res
    res["pillow_ms"], ref = median_ms(lambda: np.asarray(Image.open(path)))
    res["equal"] &= bool(np.array_equal(img, ref))
    return res


def phase_tum(out_dir: str, card: str):
    """The TUM RGB-D reader at the configuration's full size (module
    docstring, phase tum). Gate: the 24 frames read (the orphan pair
    rejected), frame 0's undistorted colour within mean abs 0.02 of the
    clean render over the cropped interior, the pre-distortion converged
    there, the map camera 540 x 380 and the VO stepped on 640 x 480
    frames, every mapped frame seeded from the VO's edges (no Canny
    fallback), K1 / K2 launched and no twin, ATE < 5 cm and PSNR > 19 dB
    (the synthetic_hard gates)."""
    import numpy as np

    from eags_slam_torch.config import load_config
    from eags_slam_torch.core.camera import Camera
    from eags_slam_torch.datasets import remap_bilinear
    from eags_slam_torch.utils.layouts import write_tum

    config = load_config("configs/TUM_RGBD/fr1_desk.yaml")
    if (config["cam"]["crop_edge"] != TUM_CROP
            or config["cam"]["distortion"] != TUM_DIST):
        raise SystemExit("tum: configs/TUM_RGBD/fr1_desk.yaml no longer has "
                         "the crop and distortion this phase writes")
    scene = load_config("configs/TUM_RGBD/fr1_desk.yaml")
    scene["data"].update({"dataset_name": "synthetic_hard",
                          "n_frames": TUM_FRAMES})
    scene["cam"]["crop_edge"] = 0
    t0 = time.perf_counter()
    colors, depths, poses = _render_sequence(scene, TUM_FRAMES)
    cam = Camera(*TUM_CAM)
    map_u, map_v, res_kept, res_all = _inverse_distortion_maps(
        cam, TUM_DIST, TUM_CROP)
    root = out_dir + "_data"
    write_tum(root, [remap_bilinear(c, map_u, map_v) for c in colors],
              depths, poses, depth_dt=0.012, gt_dt=0.004,
              filters=np.arange(cam.height) % 5, orphan_after=5.0)
    write_s = time.perf_counter() - t0
    decode = _paeth_decode_ms(root, colors[0])
    config["device"] = "cuda"
    config["data"].update({"input_path": root, "output_path": out_dir})
    ok, line, _ = _run_reader("tum", config, TUM_FRAMES, out_dir, colors[0],
                              card)
    ok &= (line["map_camera"] == [540, 380]
           and line["full_camera"] == [640, 480] and res_kept < 1e-3)
    ok &= decode["equal"]
    emit({**line, "ok": ok, "predistort_residual_px_kept": res_kept,
          "predistort_residual_px_all": res_all, "render_write_s": write_s,
          "png_paeth_decode": decode})
    if not ok:
        raise SystemExit("tum check failed")
    return line, config


def phase_tum_cost(config, out_dir: str, card: str):
    """What the reader costs the SLAM loop (module docstring, phase
    tum_cost): the tum phase's config and files, run through three frame
    sources in the order reader / cached / decoded / decoded / cached /
    reader. `reader`: the TUM reader as it is. `cached`: the same reader
    whose preloader hands over frames decoded beforehand (its thread, its
    pinned uploads, no decode). `decoded`: an ArrayDataset of the same
    frames already on the card. Gate: each run's frames, ATE < 5 cm, PSNR
    > 19 dB, no twin."""
    import numpy as np

    from eags_slam_torch.datasets import TUM_RGBD, ArrayDataset, FileDataset
    from eags_slam_torch.utils import native_loader

    class Python(TUM_RGBD):
        """The reader on its Python preloader (its own _load_raw keeps
        the native pool out)."""

        def _load_raw(self, idx):
            return FileDataset._load_raw(self, idx)

    host = Python(config, device="cpu")
    frames = [host.get_origin_image(i) for i in range(len(host))]
    host.close()
    # The native pool's frames (decoded by the pool, undistorted after):
    # exactly the Python reader's.
    native_ok = native_loader.status()["native"] is not None
    native_equal = None
    if native_ok:
        nat = TUM_RGBD(config, device="cpu")
        nat.start_prefetch()
        try:
            native_equal = nat.report()["reader"] == "native" and all(
                np.array_equal(a, b) for i, (c, d) in enumerate(frames)
                for a, b in zip(nat.get_origin_image(i), (c, d)))
        finally:
            nat.close()

    class Cached(TUM_RGBD):
        def _load_raw(self, idx):
            return frames[idx]

    def source_dataset(source):
        if source == "reader":
            return Python(config)
        if source == "native":
            return TUM_RGBD(config)
        if source == "cached":
            return Cached(config)
        ds = ArrayDataset(config, np.stack([c for c, _ in frames]),
                          np.stack([d for _, d in frames]), host.poses,
                          device=config["device"])
        ds.timestamps = list(host.timestamps)
        return ds

    keys = ("fps", "track_ms", "map_ms", "vo_ms", "data_wait_ms",
            "ate_cm", "psnr_db")
    order = (("reader", "native", "cached", "decoded", "decoded", "cached",
              "native", "reader") if native_ok else
             ("reader", "cached", "decoded", "decoded", "cached", "reader"))
    runs, ok = [], native_equal is not False
    for k, source in enumerate(order):
        run_dir = f"{out_dir}_{k}"
        cfg = {**config, "data": {**config["data"], "output_path": run_dir}}
        run_ok, line, report, _ = _run_slam(cfg, TUM_FRAMES, run_dir,
                                            "tum_cost",
                                            dataset=source_dataset(source))
        line.update(vo_ms=report["vo"]["mean_track_ms"],
                    data_wait_ms=report["data_wait_ms_avg"])
        want = {"reader": "python", "native": "native"}.get(source)
        ok &= (run_ok and line["ate_cm"] < 5.0 and line["psnr_db"] > 19.0
               and (want is None or report["data"]["reader"] == want))
        runs.append({"source": source, "reader": report["data"].get(
            "reader"), **{f: line[f] for f in keys}})
    fps = {s: sum(r["fps"] for r in runs if r["source"] == s)
           for s in set(order)}
    emit({"phase": "tum_cost", "ok": ok, "card": card, "runs": runs,
          "native_frames_equal_python": native_equal,
          "fps_over_reader": {s: fps[s] / fps["reader"]
                              for s in set(order) - {"reader"}}})
    if not ok:
        raise SystemExit("tum_cost check failed")


def phase_replica(out_dir: str, card: str):
    """The Replica reader: 24 frames of bench.py's synthetic_hard at
    1200 x 680 written as Replica's JPEG colour (quality 95), 16-bit depth
    at 6553.5 and traj.txt, run through configs/Replica/room0.yaml with the
    heavy evaluation off (the heavy phase covers it). Gate: as tum (the
    read-back colour is JPEG's within mean abs 0.02; the VO steps on the
    full frames and decimates them itself), ATE < 5 cm, PSNR > 19 dB."""
    from eags_slam_torch.config import load_config
    from eags_slam_torch.utils.layouts import write_replica

    scene = c2f_config(out_dir, REPLICA_FRAMES)
    t0 = time.perf_counter()
    colors, depths, poses = _render_sequence(scene, REPLICA_FRAMES)
    root = out_dir + "_data"
    write_replica(root, colors, depths, poses, depth_scale=6553.5,
                  quality=95)
    write_s = time.perf_counter() - t0
    config = load_config("configs/Replica/room0.yaml")
    config["device"] = "cuda"
    config["data"].update({"input_path": root, "output_path": out_dir})
    config["evaluation"].update({"eval_mesh": False, "eval_global": False})
    ok, line, _ = _run_reader("replica", config, REPLICA_FRAMES, out_dir,
                              colors[0], card)
    ok &= line["map_camera"] == [1200, 680]
    emit({**line, "ok": ok, "render_write_s": write_s,
          "orbit_speed": scene["data"]["orbit_speed"]})
    if not ok:
        raise SystemExit("replica check failed")
    return line


def phase_entries(per_wall: int, n_frames: int, out_dir: str, slice_line):
    """The slice's protocol on the entry-binned backend (EAGS_RCFG=
    backend=pallas for this run): candidate scoring, frozen-binning
    tracking on the full image and the plain mapping loop through K5 / K6,
    the entry gather's backward through K7. Gate: K5, K6 and K7 launched,
    no K1-K4 launch, no twin; every frame ran;
    ATE < 5 cm and PSNR > 20 dB. The slice's ATE / PSNR on the same frames
    (sorted kernels) are printed beside these."""
    ok, line, _, gslam = _run_slam(bench_config(out_dir, n_frames, per_wall),
                                   n_frames, out_dir, "entries",
                                   rcfg_env="backend=pallas")
    la = line["launches"]
    ok &= (gslam.rcfg.backend == "pallas"
           and la["entries_fwd_launches"] > 0
           and la["entries_bwd_launches"] > 0
           and la["entries_gather_launches"] > 0
           and all(la[LAUNCH_KEYS[k]] == 0 for k in ("K1", "K2", "K3", "K4"))
           and line["ate_cm"] < 5.0 and line["psnr_db"] > 20.0)
    side = {"entries": {"ate_cm": line["ate_cm"], "psnr_db": line["psnr_db"]},
            "sorted": None if slice_line is None else {
                "ate_cm": slice_line["ate_cm"],
                "psnr_db": slice_line["psnr_db"]}}
    emit({**line, "ok": ok, "scene_gaussians": gslam.dataset.n_scene,
          "same_frames": side})
    if not ok:
        raise SystemExit("entries check failed")
    return line


# The dense `jnp` backend: the slice's protocol (1200x680, tile 32, the
# synthetic room) cut to DENSE_FRAMES frames (frame 0's 360-iteration init,
# frame 2 tracked and mapped; a dense mapping iteration takes ~0.43 s
# there, so frame 0 alone takes ~2.5 min) and bench.py's tile_capacity; the
# golden check at the JAX rasterizer tests' cameras (tests/test_rasterizer
# .py, test_rasterizer_v2.py:13,169, test_rasterizer_pallas.py).
DENSE_FRAMES = 3
DENSE_TILE_CAPACITY = 1024
GOLDEN_CAMS = {"48x32": (60.0, 60.0, 23.5, 15.5, 48, 32),
               "128x64": (90.0, 90.0, 63.5, 31.5, 128, 64)}
# (camera, RasterConfig fields, tolerance): the matching JAX test's.
GOLDEN = {
    "jnp_48x32": ("48x32", dict(tile=16, dup_side=4, tile_capacity=128,
                                chunk=32, backend="jnp"), "v1"),
    "K1_48x32": ("48x32", dict(tile=16, dup_side=4, backend="sorted",
                               seg_cap=256, bands=3), "v2"),
    "K1_128x64_t32": ("128x64", dict(tile=32, dup_side=3, backend="sorted",
                                     seg_cap=256, bands=3), "bulk"),
    "K1_128x64_t64": ("128x64", dict(tile=64, dup_side=2, backend="sorted",
                                     seg_cap=384, bands=3), "bulk"),
    "K5_48x32": ("48x32", dict(tile=16, dup_side=4, backend="pallas",
                               max_per_tile=256), "v2"),
}
# Absolute (colour, depth, alpha) tolerances; "bulk": max 2e-3, mean 2e-5
# and at most 0.1% of pixels above 2e-4 on colour and alpha
# (test_rasterizer_v2.py's big-tile test).
GOLDEN_TOL = {"v1": (2e-5, 2e-4, 2e-5), "v2": (1e-4, 1e-3, 1e-4)}


def _golden_scene(cam, seed: int):
    """The JAX rasterizer tests' scene on the card: 48 gaussians on the
    48x32 camera, 96 on the 128x64 one, identity pose."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    big = cam.width > 64
    n, wx = (96, 0.8) if big else (48, 0.6)
    means = np.stack([rng.uniform(-wx, wx, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return [torch.as_tensor(a, device="cuda") for a in (
        means, q, np.log(rng.uniform(0.02, 0.07, (n, 3))).astype(np.float32),
        rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32),
        rng.uniform(0, 1, (n, 3)).astype(np.float32),
        np.eye(4, dtype=np.float32))]


def _check_golden():
    """render_dense on the card against the jnp backend, K1 and K5 at the
    JAX tests' cameras and tolerances (GOLDEN); the kernels launch, no
    twin. Returns (ok, {case: errors})."""
    import torch

    from eags_slam_torch.core.camera import Camera
    from eags_slam_torch.ops import composite_entries as ce
    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.ops.rasterizer import RasterConfig, render
    from eags_slam_torch.ops.rasterizer_ref import render_dense

    ok, res = True, {}
    launch_key = {"sorted": "fwd_launches", "pallas": "entries_fwd_launches"}
    for case, (cam_name, kw, tol) in GOLDEN.items():
        cam = Camera(*GOLDEN_CAMS[cam_name])
        args = _golden_scene(cam, 0)
        ref = render_dense(*args, cam, RasterConfig(tile=16, dup_side=4))
        cs.reset_counts()
        ce.reset_counts()
        out = render(*args, cam, RasterConfig(**kw))
        torch.cuda.synchronize()
        c = {**cs.counts(), **ce.counts()}
        err = {}
        case_ok = (not any(c[k] for k in TWIN_KEYS)
                   and all((c[k] > 0) == (k == launch_key.get(kw["backend"]))
                           for k in launch_key.values())
                   and float(out.alpha.max()) > 0.5)
        for i, name in enumerate(("color", "depth", "alpha")):
            d = (getattr(out, name) - getattr(ref, name)).abs()
            err[name] = {"max": float(d.max()), "mean": float(d.mean()),
                         "frac_above_2e-4": float((d > 2e-4).float().mean())}
            if tol == "bulk":
                if name != "depth":
                    case_ok &= (err[name]["max"] < 2e-3
                                and err[name]["mean"] < 2e-5
                                and err[name]["frac_above_2e-4"] < 1e-3)
            else:
                case_ok &= err[name]["max"] <= GOLDEN_TOL[tol][i]
        res[case] = {"ok": case_ok, "tol": tol, **err}
        ok &= case_ok
    return ok, res


def phase_dense(per_wall: int, n_frames: int, out_dir: str, slice_line):
    """The slice's protocol on the dense `jnp` backend (EAGS_RCFG=
    backend=jnp for this run, mapping.tile_capacity 1024 as bench.py's):
    candidate scoring, tracking and the plain mapping loop all render the
    whole map in plain PyTorch, tile_capacity gaussians a tile in chunks of
    64 under torch.utils.checkpoint. First the golden check (_check_golden).
    Gate: the golden cases within their tolerances; no K1-K6 launch and no
    twin in the run; every frame ran; ATE < 5 cm and PSNR > 20 dB. Prints
    FPS, track / map ms and peak memory beside the slice's."""
    ok_g, golden = _check_golden()
    config = bench_config(out_dir, n_frames, per_wall)
    config["mapping"]["tile_capacity"] = DENSE_TILE_CAPACITY
    ok, line, _, gslam = _run_slam(config, n_frames, out_dir, "dense",
                                   rcfg_env="backend=jnp")
    la = line["launches"]
    ok &= (ok_g and gslam.rcfg.backend == "jnp"
           and gslam.rcfg.tile_capacity == DENSE_TILE_CAPACITY
           and not any(la.values())
           and line["ate_cm"] < 5.0 and line["psnr_db"] > 20.0)
    emit({**line, "ok": ok, "scene_gaussians": gslam.dataset.n_scene,
          "tile_capacity": gslam.rcfg.tile_capacity,
          "chunk": gslam.rcfg.chunk, "golden": golden,
          "slice_same_call": None if slice_line is None else {
              k: slice_line[k] for k in ("fps", "track_ms", "map_ms",
                                         "peak_mem_gb", "ate_cm",
                                         "psnr_db")}})
    if not ok:
        raise SystemExit("dense check failed")
    return line


def _mean_log(out_dir: str, kind: str, key: str):
    """The mean of `key` over the log.jsonl records of `kind` that have
    it, or None."""
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        vals = [r[key] for r in map(json.loads, f)
                if r["kind"] == kind and key in r]
    return sum(vals) / len(vals) if vals else None


def phase_vo_cpu(n_frames: int, out_dir: str, c2f_line):
    """c2f's 24 frames with `vo.device: cpu`: the edge VO on the host CPU,
    pipelined one frame ahead on its worker thread (decoupled: frame f+1's
    step runs beside frame f's tracking and mapping on the card). Gate:
    c2f's (K1 / K2 / K4 launched, no twin, the odometer won a frame, ATE <
    5 cm, PSNR > 19 dB, SSIM > 0.55), every VO step on CPU tensors, frames
    1-23 stepped on the worker (23 pipelined). Prints FPS, track / map / VO
    ms and the loop's wait for the VO a frame beside c2f's."""
    import threading

    config = c2f_config(out_dir, n_frames)
    config["vo"] = {**config.get("vo", {}), "device": "cpu"}
    steps = []

    def record(gslam):
        step = gslam.odometer.step

        def recording(rgb, depth, timestamp):
            steps.append((threading.current_thread().name, rgb.device.type))
            return step(rgb, depth, timestamp)

        gslam.odometer.step = recording

    ok, line, report, gslam = _run_slam(config, n_frames, out_dir, "vo_cpu",
                                        prepare=record)
    vo = report["vo"]
    wins = report["tracker"]["init_pose_cnt"].get("odometer", 0)
    kf_dev = gslam.odometer.keyframes[-1].pyramid.levels[0].pts.device.type
    la = line["launches"]
    ok &= (gslam.odometer.on_cpu and vo["pipelined"] == n_frames - 1
           and {d for _, d in steps} == {"cpu"} and kf_dev == "cpu"
           and sum(name.startswith("eags-vo") for name, _ in steps)
           == n_frames - 1
           and la["fwd_launches"] > 0 and la["bwd_launches"] > 0
           and la["pose_launches"] > 0 and wins >= 1
           and line["ate_cm"] < 5.0 and line["psnr_db"] > 19.0
           and line["ssim"] > 0.55)
    import torch

    emit({**line, "ok": ok, "odometer_wins": wins,
          "cpu_threads": torch.get_num_threads(), "cpus": os.cpu_count(),
          "vo_device": vo["device"], "vo_pipelined": vo["pipelined"],
          "vo_steps_on_worker": sum(n.startswith("eags-vo")
                                    for n, _ in steps),
          "vo_keyframes": vo["n_keyframes"], "vo_ms": vo["mean_track_ms"],
          "vo_dt_host_ms": vo["mean_dt_ms"],
          "vo_wait_ms": _mean_log(out_dir, "tracking", "vo_wait_ms"),
          "c2f_same_call": None if c2f_line is None else {
              k: c2f_line[k] for k in ("fps", "track_ms", "map_ms", "vo_ms",
                                       "vo_wait_ms", "ate_cm", "psnr_db")}})
    if not ok:
        raise SystemExit("vo_cpu check failed")
    return line


# The mesh F1 ceiling (python -m eags_slam_torch.mesh_bound) at bench
# scale: 72 frames, every 5th fused, the evaluator's voxel 5/512, both grid
# bounds. The reference read F1 0.797 with depth bounds
# (MESH_BOUND_r05.jsonl line 6, a TPU v5e run).
MESH_BOUND_REFERENCE_F1 = 0.797


def phase_mesh_bound(heavy_line):
    """The port's mesh_bound entry on the card. Gate: every line has faces
    and a finite F1, and the depth-bounds F1 at voxel 5/512 lies above the
    heavy phase's F1 of the same call (a ceiling sits above the reading).
    Prints F1, precision, recall and wall seconds beside the reference's
    0.797."""
    import math

    import torch

    from eags_slam_torch import mesh_bound as mb

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    lines = mb.main(["--frames", str(LC_FRAMES), "--kf_every", "5",
                     "--voxels", str(5.0 / 512.0)])
    wall = time.perf_counter() - t0
    depth = [r for r in lines if r["bounds"] == "depths"]
    heavy_f1 = None if heavy_line is None else heavy_line["recon"]["f1"]
    ok = (len(lines) == 2 and len(depth) == 1
          and all(r["n_faces"] > 0 and math.isfinite(r.get("f1", math.nan))
                  for r in lines)
          and (heavy_f1 is None or depth[0]["f1"] > heavy_f1))
    emit({"phase": "mesh_bound", "ok": ok, "lines": lines,
          "wall_s": wall, "peak_mem_gb": torch.cuda.max_memory_allocated()
          / 2**30, "heavy_f1_same_call": heavy_f1,
          "reference_f1": MESH_BOUND_REFERENCE_F1})
    if not ok:
        raise SystemExit("mesh_bound check failed")


# AlexNet's trunk as LPIPS reads it: (out, in, kernel) of conv1..conv5.
ALEX = ((64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3),
        (256, 256, 3))
LPIPS_REL_TOL = 1e-4


def _lpips_weights(path: str, seed: int = 0):
    """A seeded npz with the LPIPS(alex) checkpoint's keys and shapes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    z = {}
    for i, (o, c, k) in enumerate(ALEX, start=1):
        z[f"conv{i}_w"] = (rng.normal(size=(o, c, k, k))
                           * np.sqrt(2.0 / (c * k * k))).astype(np.float32)
        z[f"conv{i}_b"] = rng.normal(0, 0.05, o).astype(np.float32)
        z[f"lin{i}_w"] = rng.uniform(0, 0.2, (1, o, 1, 1)).astype(np.float32)
    np.savez(path, **z)


def phase_lpips(per_wall: int, n_frames: int, slice_dir: str):
    """LPIPS(alex) on the card: seeded weights with AlexNet's shapes in a
    temporary file (the module's path pointed at it; nothing is written
    into the repo); two 1200x680 images on the card and on the CPU within
    1e-4 relative (float32 convolutions, TF32 off); ms a call on the card
    (median of 5); then the evaluator's rendering stage on the slice
    phase's output directory, whose mean_lpips must be finite."""
    import math
    import tempfile

    import numpy as np
    import torch

    from eags_slam_torch.datasets import get_dataset
    from eags_slam_torch.evaluation import lpips as L
    from eags_slam_torch.evaluation.evaluator import Evaluator

    saved = L.WEIGHTS_PATH, L._NETS
    with tempfile.TemporaryDirectory() as tmp:
        L.WEIGHTS_PATH = os.path.join(tmp, "lpips_alex.npz")
        L._NETS = {}
        try:
            _lpips_weights(L.WEIGHTS_PATH)
            rng = np.random.default_rng(1)
            a = rng.uniform(0, 1, (680, 1200, 3)).astype(np.float32)
            b = np.clip(a + rng.normal(0, 0.1, a.shape), 0,
                        1).astype(np.float32)
            cpu = L.lpips(torch.as_tensor(a), torch.as_tensor(b))
            ta, tb = (torch.as_tensor(x, device="cuda") for x in (a, b))
            card = L.lpips(ta, tb)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                L.lpips(ta, tb)
                times.append(1e3 * (time.perf_counter() - t0))
            config = bench_config(slice_dir, n_frames, per_wall)
            ds = get_dataset("synthetic")(config, device="cuda")
            try:
                rend = Evaluator(slice_dir, ds, config).run_rendering_eval()
            finally:
                ds.close()
        finally:
            L.WEIGHTS_PATH, L._NETS = saved
    rel = abs(card - cpu) / cpu
    ok = (cpu > 0 and rel <= LPIPS_REL_TOL and rend["mean_lpips"] is not None
          and math.isfinite(rend["mean_lpips"]) and rend["num_views"] > 0)
    emit({"phase": "lpips", "ok": ok, "card": card, "cpu": cpu,
          "rel_err": rel, "tol": LPIPS_REL_TOL, "ms": sorted(times)[2],
          "image": [1200, 680], "slice_mean_lpips": rend["mean_lpips"],
          "slice_psnr_db": rend["mean_psnr"], "views": rend["num_views"]})
    if not ok:
        raise SystemExit("lpips check failed")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases",
                   default="device,build,kernels,slice,lpips,dense,window,"
                   "c2f,repeat,vo_cpu,mesh,lc,heavy,mesh_bound,entries,"
                   "slice_k4,slice_opts,slice_mapopts,tum,replica")
    p.add_argument("--out", default="output/chip_smoke")
    p.add_argument("--ptxas", action="store_true",
                   help="print nvcc -Xptxas -v (registers, spills)")
    args = p.parse_args()
    phases = set(args.phases.split(","))

    card = phase_device()
    import torch

    from eags_slam_torch.ops import composite_entries as ce
    from eags_slam_torch.ops import composite_sorted as cs

    phase_build(args.ptxas)
    summary = phase_kernels(PER_WALL, REPS) if "kernels" in phases else {}
    # Launches summed over the main-path phases that ran (each counted from
    # 0 just before its run); null when none ran.
    runs = []
    slice_line = None
    if "slice" in phases:
        slice_line = phase_slice(PER_WALL, N_FRAMES, args.out + "_slice")
        runs.append(slice_line)
    if "lpips" in phases:
        if slice_line is None:
            raise SystemExit("lpips scores the slice phase's run: run both")
        phase_lpips(PER_WALL, N_FRAMES, args.out + "_slice")
    if "dense" in phases:
        runs.append(phase_dense(PER_WALL, DENSE_FRAMES, args.out + "_dense",
                                slice_line))
    if "window" in phases:
        runs.append(phase_slice(PER_WALL, N_FRAMES, args.out + "_window",
                                window=True, slice_line=slice_line))
    c2f_line = None
    if "c2f" in phases:
        c2f_line = phase_c2f(C2F_FRAMES, args.out + "_c2f")
        runs.append(c2f_line)
    if "repeat" in phases:
        runs.append(phase_repeat(C2F_FRAMES, args.out + "_repeat",
                                 args.out + "_c2f", c2f_line))
    if "vo_cpu" in phases:
        runs.append(phase_vo_cpu(C2F_FRAMES, args.out + "_vo_cpu", c2f_line))
    if "mesh" in phases:
        runs.append(phase_mesh(C2F_FRAMES, args.out + "_mesh", c2f_line))
    lc_line = None
    if "lc" in phases:
        lc_line = phase_lc(LC_FRAMES, args.out + "_lc", c2f_line)
        runs.append(lc_line)
    launches_global = None
    heavy_line = None
    if "heavy" in phases:
        heavy_line, k12_global = phase_heavy(LC_FRAMES, args.out + "_lc",
                                             lc_line, REPS)
        runs.append(heavy_line)
        launches_global = heavy_line["launches_global"]
        for kid, extra in k12_global.items():
            summary.setdefault(kid, {})["global"] = extra
    if "mesh_bound" in phases:
        phase_mesh_bound(heavy_line)
    if "entries" in phases:
        runs.append(phase_entries(PER_WALL, N_FRAMES, args.out + "_entries",
                                  slice_line))
    if "slice_k4" in phases:
        runs.append(phase_slice(PER_WALL, N_FRAMES, args.out + "_slice_k4",
                                slice_line=slice_line, pose_kernel=True))
    if "slice_opts" in phases:
        runs.append(phase_slice_opts(PER_WALL, N_FRAMES,
                                     args.out + "_slice_opts", slice_line))
    if "slice_mapopts" in phases:
        runs.append(phase_slice_mapopts(PER_WALL, N_FRAMES,
                                        args.out + "_slice_mapopts",
                                        slice_line))
    if "tum" in phases:
        tum_line, tum_config = phase_tum(args.out + "_tum", card)
        runs.append(tum_line)
        if "tum_cost" in phases:
            phase_tum_cost(tum_config, args.out + "_tum_cost", card)
    elif "tum_cost" in phases:
        raise SystemExit("tum_cost reads the tum phase's files: run both")
    if "replica" in phases:
        runs.append(phase_replica(args.out + "_replica", card))
    kernels = []
    for kid, lkey in LAUNCH_KEYS.items():
        s = summary.get(kid, {})
        k = {"name": kid, "route": "cuda", "source": SOURCES[kid],
             "replaces": REPLACES[kid],
             "launches": sum(r["launches"][lkey] for r in runs)
             if runs else None,
             # The loop closer's launches, counted apart (lc phase).
             "launches_lc": sum(r["launches_lc"][lkey] for r in runs)
             if runs else None,
             # The global refine's, counted apart (heavy phase).
             "launches_global": None if launches_global is None
             else launches_global[lkey],
             "max_abs_err": s.get("max_abs_err"),
             "ms": s.get("ms"), "plain_ms": s.get("plain_ms"),
             "bound_ms": s.get("bound_ms"),
             "bound_by": s.get("bound_by"),
             "library_ms": s.get("library_ms"),
             **{f: s[f] for f in ("run", "subset", "polish", "full",
                                  "frozen", "lc_full", "lc_subset",
                                  "tum_full", "tum_subset", "global",
                                  "variants")
                if f in s}}
        if kid in ("K5", "K6") and runs:
            # K5 / K6 run on two layouts: the render binning and the
            # tracker's frozen binning.
            k["launches_by_layout"] = {
                lay: sum(r["launches_by_layout"][kid][lay] for r in runs)
                for lay in ce.LAYOUTS}
        elif runs and kid in ("K1", "K2", "K3", "K4"):
            # K1-K4 by variant: default, quadform, bf16, quadform_bf16.
            k["launches_by_variant"] = {
                v: sum(r["launches_by_variant"][kid][v] for r in runs)
                for v in cs.VARIANTS}
        kernels.append(k)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
