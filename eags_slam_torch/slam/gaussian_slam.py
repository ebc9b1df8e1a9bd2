"""GaussianSLAM orchestrator: the per-frame host loop (port of
eags_slam_tpu.slam.gaussian_slam, the main path).

Per frame: frames 0/1 take the GT pose, later frames are tracked from the
const-speed and previous-pose candidates, plus the edge VO's candidate when
the VO runs (`tracking.odometry_type: odometer` or
`help_camera_initialization`); a submap boundary (every `new_submap_every`
frames or past the motion thresholds) saves the submap and starts a new one
(warm-started from the outgoing submap's visible gaussians when
`init_warm_start`); every `map_every`-th frame, the last frame and every
boundary frame is mapped (seed rows, insert, optimise), seeded from the
VO's edge map when there is one, else from Canny edges.

The VO steps every frame on the SLAM device, in this thread. Decoupled mode
(`vo.decoupled`, the default) composes the VO's own relative motion onto
the SLAM chain, slam(f-1) @ inv(vo(f-1)) @ vo(f), from frame 3 on; coupled
mode injects each tracked pose into the VO (`set_pose`). Frames wider than
800 px run the VO at half resolution unless `vo.downscale_levels` is set.

Frames come from the config's dataset (`datasets.py`): a file-backed
reader decodes ahead on its preloader thread, started here and stopped by
`cleanup`; the loop's wait for each frame is the `data_wait` stage. The map
camera is the dataset's cropped camera (`cam.crop_edge`); the VO reads the
uncropped frame on the full camera, and its edge map is cropped the same
way before it seeds.

The rasterizer runs the sorted backend unless `EAGS_RCFG` (comma-separated
RasterConfig overrides, e.g. `backend=pallas`) says otherwise; the
`pallas` backend tracks on a frozen entry binning and maps with the plain
(non-resident) loop. `mapping.rmw_window` or `EAGS_RMW_WINDOW=1` routes the
sorted backward through K3.

With `lc.enabled`, each saved submap (and, with `lc.final`, the last one)
is submitted to the loop closer, which runs beside the loop on its own
thread and CUDA stream (`lc/loop_closure.py`); after every frame the loop
re-raises the closer's errors and applies its drained corrections to the
live pose array (timed as the `lc_drain` stage). The loop syncs only its
own stream. `bench_deadline_ts` (a wall-clock time) stops the loop
cleanly between frames.

The run's evaluation, the heavy stages (`evaluation.eval_mesh`,
`eval_global`) included, runs after the loop (`evaluation/evaluator.py`,
driven by `run_slam`, `run_evaluation` and `bench`).

Options of the map and track path: `mapping.kernel_quadform` /
`kernel_bf16` (the variants of K1-K4), `mapping.tile_subset` (a random
tile subset each mapping iteration), `mapping.init_halfres_frac` (the first
part of a fresh submap's init on the boundary frame at half resolution,
then the rest at full resolution with the full frame's descriptor) and
`tracking.debug_per_iter` (each tracked frame's per-iteration record,
`tracker.DEBUG_ITER_NAMES`, written to log.jsonl as "track_iters").

Not ported yet, each raising NotImplementedError when a config selects it:
the device mesh (`use_mesh`, `force_mesh`, `sp_track`), the dense `jnp`
backend and a VO pinned to another device (`vo.device`).
"""
from __future__ import annotations

import math
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import save_config
from ..core import gaussians as G
from ..core.camera import Camera
from ..datasets import get_dataset
from ..ops.rasterizer import RasterConfig, apply_rcfg_env, check_config
from ..vo.system import EdgeVO, VOConfig
from ..vo.system import check_config as vo_check_config
from . import mapper as M
from . import tracker as TT
from .logger import Logger
from .submap import Submap, pack_state
from .tracker import Tracker, TrackerConfig


def _rotation_angle_deg(R1: np.ndarray, R2: np.ndarray) -> float:
    cosang = (np.trace(R1.T @ R2) - 1.0) / 2.0
    return math.degrees(math.acos(min(max(cosang, -1.0), 1.0)))


def exceeds_motion_thresholds(c2w: np.ndarray, anchor_c2w: np.ndarray,
                              rot_thre: float, trans_thre: float) -> bool:
    rot = _rotation_angle_deg(anchor_c2w[:3, :3], c2w[:3, :3])
    trans = float(np.linalg.norm(c2w[:3, 3] - anchor_c2w[:3, 3]))
    return rot > rot_thre or trans > trans_thre


def _check_slice(config: Dict) -> None:
    tc = config["tracking"]
    if (config.get("use_mesh", False) or config.get("force_mesh", False)
            or tc.get("sp_track", False)):
        raise NotImplementedError(
            "use_mesh / force_mesh / sp_track: multi-device mapping and "
            "tracking are not ported (ROADMAP Queue 1 item 12)")


def raster_config(config: Dict, device: torch.device) -> RasterConfig:
    """The run's RasterConfig (EAGS_RCFG and EAGS_RMW_WINDOW applied)."""
    mc = config["mapping"]
    on_gpu = device.type == "cuda"
    # `tile_capacity` configures the dense backend, which is not ported.
    return apply_rcfg_env(RasterConfig(
        tile=int(mc.get("raster_tile", 32 if on_gpu else 16)),
        dup_side=int(mc.get("dup_side", 3 if on_gpu else 4)),
        group=int(mc.get("raster_group", 8)),
        entry_cap_factor=int(mc.get("entry_cap_factor", 4)),
        seg_cap=int(mc.get("seg_cap", 1024)),
        kernel_bf16=bool(mc.get("kernel_bf16", False)),
        kernel_quadform=bool(mc.get("kernel_quadform", False)),
        rmw_window=bool(int(os.environ.get(
            "EAGS_RMW_WINDOW", int(bool(mc.get("rmw_window", False)))))),
    ))


def mapper_config(config: Dict, cam: Camera) -> M.MapperConfig:
    mc = config["mapping"]
    return M.MapperConfig(
        iterations=int(mc["iterations"]),
        new_submap_iterations=int(mc["new_submap_iterations"]),
        new_submap_points_num=int(mc["new_submap_points_num"]),
        new_submap_gradient_points_num=int(
            mc["new_submap_gradient_points_num"]),
        new_frame_sample_size=(
            int(mc["new_frame_sample_size"])
            if int(mc["new_frame_sample_size"]) > 0
            else cam.height * cam.width),
        new_points_radius=float(mc["new_points_radius"]),
        current_view_opt_iterations=float(
            mc["current_view_opt_iterations"]),
        alpha_thre=float(mc["alpha_thre"]),
        pruning_thre=float(mc["pruning_thre"]),
        edge_dilate=int(mc.get("edge_dilate_kernel", 2)),
        outlier_removal=bool(mc.get("outlier_removal", False)),
        max_keyframes=int(mc.get("max_keyframes", 32)),
        tile_subset=int(mc.get("tile_subset", 0)),
        kf_block=int(mc.get("kf_block", 10)),
        freeze_frac=float(mc.get("freeze_frac", 0.0)),
        freeze_after=float(mc.get("freeze_after", 0.65)),
        init_halfres_frac=float(mc.get("init_halfres_frac", 0.0)),
        init_warm_start=bool(mc.get("init_warm_start", False)),
        warm_min_visible=int(mc.get("warm_min_visible", 20000)),
        stale_best_cnt=int(mc.get("stale_best_cnt", 0)),
    )


def tracker_config(config: Dict) -> TrackerConfig:
    tc = config["tracking"]
    return TrackerConfig(
        iterations=int(tc["iterations"]),
        cam_rot_lr=float(tc["cam_rot_lr"]),
        cam_trans_lr=float(tc["cam_trans_lr"]),
        w_color_loss=float(tc["w_color_loss"]),
        alpha_thre=float(tc["alpha_thre"]),
        filter_alpha=bool(tc["filter_alpha"]),
        filter_outlier_depth=bool(tc["filter_outlier_depth"]),
        soft_alpha=bool(tc["soft_alpha"]),
        mask_invalid_depth=bool(tc.get("mask_invalid_depth", False)),
        early_stop_thre=float(tc.get("early_stop_thre", 5.0e-5)),
        early_stop_cnt=int(tc["early_stop_cnt"]),
        stale_best_cnt=int(tc.get("stale_best_cnt", 0)),
        plateau_patience=int(tc.get("scheduler_patience", 5)),
        plateau_factor=float(tc.get("scheduler_factor", 0.95)),
        init_err_ratio=float(tc["init_err_ratio"]),
        enable_exposure=bool(tc.get("enable_exposure", False)),
        debug_per_iter=bool(tc.get("debug_per_iter", False)),
        tile_subset_frac=float(tc.get("tile_subset_frac", 0.25)),
        polish_iters=int(tc.get("polish_iters", 0)),
        polish_frac=float(tc.get("polish_frac", 1.0)),
        pose_grad_kernel=bool(tc.get("pose_grad_kernel", False)),
    )


def check_run_config(config: Dict) -> None:
    """Every guard of a run's config, before anything is built: the
    branches that are not ported raise NotImplementedError, an unknown
    dataset name raises KeyError."""
    _check_slice(config)
    get_dataset(config["data"]["dataset_name"])
    check_config(raster_config(config, torch.device(
        config.get("device", "cuda"))))
    vo_check_config(VOConfig.from_dict(config.get("vo", {})))


class GaussianSLAM:
    """`dataset`: a frame source to use instead of the config's dataset.
    `draws`: an object replacing the generator-based random draws, with
    `seed_gumbels(key, is_new, n_pixels) -> list of (n_pixels,) noise`,
    `kf_sampler(key) -> callable(p_kf, it0)` and, optionally,
    `tile_sampler(key) -> callable(it)` (the mapper's tile subset); `key`
    is the pair of uint32 drawn from the run's numpy stream for that step
    (parity tests hand both packages the same draws through it)."""

    def __init__(self, config: Dict, dataset=None, draws=None):
        self.config = config
        self.draws = draws
        self.device = torch.device(config.get("device", "cuda"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("config device is 'cuda' but no CUDA device "
                               "is available")
        check_run_config(config)
        self.verbose = bool(config.get("verbose", False))
        self.output_path = config["data"]["output_path"]
        self._setup_output_path()

        if dataset is None:
            dataset = get_dataset(config["data"]["dataset_name"])(
                config, device=self.device)
        self.dataset = dataset
        self.cam: Camera = self.dataset.camera

        mc = config["mapping"]
        tc = config["tracking"]
        self.map_every = int(mc["map_every"])
        self.new_submap_every = int(mc["new_submap_every"])
        self.motion_heuristic = bool(mc["submap_using_motion_heuristic"])
        self.rot_thre = float(mc.get("new_submap_rot_thre", 50.0))
        self.trans_thre = float(mc.get("new_submap_trans_thre", 0.5))
        self.capacity = int(mc.get("max_gaussians", 1 << 18))
        self.rcfg = raster_config(config, self.device)
        self.mcfg = mapper_config(config, self.cam)
        self.tcfg = tracker_config(config)
        self.gt_camera = bool(tc.get("gt_camera", False))
        self.logger = Logger(self.output_path, self.verbose,
                             config.get("use_wandb", False))
        self.tracker = Tracker(self.tcfg, self.rcfg, self.cam)

        self.odometer: Optional[EdgeVO] = None
        self._vo_decoupled = bool(config.get("vo", {}).get("decoupled", True))
        self._vo_last = None        # vo(f-1) in the VO's own world frame
        if str(tc.get("odometry_type", "const_speed")) == "odometer" or \
                tc.get("help_camera_initialization", False):
            vo_cfg = dict(config.get("vo", {}))
            if ("downscale_levels" not in vo_cfg
                    and self.dataset.full_camera.width > 800):
                vo_cfg["downscale_levels"] = 1
            self.odometer = EdgeVO(VOConfig.from_dict(vo_cfg),
                                   self.dataset.full_camera)

        self.loop_closer = None
        self._lc_ranges_applied = 0
        self.lc_final = bool(config.get("lc", {}).get("final", True))
        if config.get("lc", {}).get("enabled", False):
            from ..lc.loop_closure import LoopClosure

            self.loop_closer = LoopClosure(config, self.output_path,
                                           self.cam, self.dataset,
                                           device=self.device)

        n = len(self.dataset)
        self.estimated_c2ws = np.tile(np.eye(4), (n, 1, 1))
        self.exposures_ab = np.zeros((n, 2))
        self.mapping_frame_ids = list(range(0, n, self.map_every)) + [n - 1]
        # One numpy stream drives the keyframe reservoir and seeds every
        # torch generator (the same stream, consumed in the same order, as
        # the JAX package's keys).
        self._rng = np.random.default_rng(int(config.get("seed", 0)))
        self._kf_descs: Dict[int, np.ndarray] = {}
        self._new_submap()
        self.submap_id = 0
        self.submap_anchor_frame = 0
        self._prev_saved_anchor: Optional[int] = None
        self.submap_kf_frame_ids: List[int] = []
        self.submap_paths: List[str] = []
        self.track_times: List[float] = []
        self.map_times: List[float] = []
        self.stage_s: Dict[str, float] = {"data_wait": 0.0, "boundary": 0.0,
                                          "lc_drain": 0.0}
        # The seeding edges of each mapped frame: the VO's, or Canny's.
        self.seed_edges = {"vo": 0, "canny": 0}
        # Last, so that an error above leaves no thread behind.
        self.dataset.start_prefetch()

    # ------------------------------------------------------------------
    def _setup_output_path(self):
        if os.path.exists(self.output_path):
            shutil.rmtree(self.output_path)
        os.makedirs(os.path.join(self.output_path, "submaps"), exist_ok=True)
        save_config(self.config, os.path.join(self.output_path,
                                              "config.yaml"))

    def _new_submap(self):
        self.state = G.empty_state(G.bucket_for(1, self.capacity),
                                   self.device)
        self.kfs = M.empty_keyframes(self.mcfg.max_keyframes, self.cam,
                                     self.device)
        self.n_kf = 0
        self._n_alive = 0
        self._warm_inited = False
        self._kf_seen = 0
        self._warned_reservoir = False

    def _next_kf_slot(self) -> Optional[int]:
        """Permanent-keyframe slot: the next free slot, then reservoir
        sampling over all keyframes of the submap."""
        r = self.mcfg.max_keyframes - 1
        self._kf_seen += 1
        if self.n_kf < r:
            self.n_kf += 1
            return self.n_kf
        j = int(self._rng.integers(0, self._kf_seen))
        return 1 + j if j < r else None

    def _key(self) -> np.ndarray:
        return np.asarray(self._rng.integers(0, 2**31 - 1, size=2,
                                             dtype=np.uint32))

    def _generator(self, key: np.ndarray) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(key[0]) * (2**32) + int(key[1]))
        return gen

    def _samplers(self, key: np.ndarray) -> Dict:
        """An optimisation's random draws for the step keyed `key`: the
        generator, and the injected keyframe / tile samplers of `draws`."""
        d = {"generator": self._generator(key)}
        if self.draws is not None:
            d["kf_sampler"] = self.draws.kf_sampler(key)
            if hasattr(self.draws, "tile_sampler"):
                d["tile_sampler"] = self.draws.tile_sampler(key)
        return d

    def _sync(self):
        """Wait for this thread's stream (not the loop closer's)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _w2c32(self, c2w):
        return torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32,
                               device=self.device)

    # ------------------------------------------------------------------
    def should_start_new_submap(self, frame_id: int) -> bool:
        if self.motion_heuristic and exceeds_motion_thresholds(
                self.estimated_c2ws[frame_id],
                self.estimated_c2ws[self.submap_anchor_frame],
                self.rot_thre, self.trans_thre):
            return True
        return (frame_id - self.submap_anchor_frame) >= self.new_submap_every

    def save_current_submap(self) -> Optional[str]:
        if not self.submap_kf_frame_ids:
            return None
        anchor = self.submap_anchor_frame
        Twm = self.estimated_c2ws[anchor]
        if self._prev_saved_anchor is None:
            T_prev_m = Twm
        else:
            T_prev_m = np.linalg.inv(
                self.estimated_c2ws[self._prev_saved_anchor]) @ Twm
        self._prev_saved_anchor = anchor
        Tmc = np.stack([np.linalg.inv(Twm) @ self.estimated_c2ws[f]
                        for f in self.submap_kf_frame_ids])
        descs = None
        if all(f in self._kf_descs for f in self.submap_kf_frame_ids):
            descs = np.stack([self._kf_descs[f]
                              for f in self.submap_kf_frame_ids])
        sm = Submap.from_world_arrays(
            self.submap_id, anchor, Twm, T_prev_m, Tmc,
            self.submap_kf_frame_ids, pack_state(self.state), descs)
        path = sm.save(self.output_path)
        self.submap_paths.append(path)
        return path

    def _warm_pack(self, frame_id: int):
        """Visible rows of the outgoing submap for the warm-start init, or
        None when too few are visible."""
        if not self.mcfg.init_warm_start or \
                self._n_alive < self.mcfg.warm_min_visible:
            return None
        vis, n_vis = M.warm_visible(self.state.params, self.state.alive,
                                    self._w2c32(self.estimated_c2ws[frame_id]),
                                    self.cam)
        if n_vis < self.mcfg.warm_min_visible:
            return None
        return self.state.params, vis, n_vis

    def start_new_submap(self, frame_id: int):
        warm = self._warm_pack(frame_id)
        self.submap_id += 1
        self.submap_anchor_frame = frame_id
        self.submap_kf_frame_ids = []
        self._new_submap()
        if warm is not None:
            rows, vis, n_vis = warm
            cap = G.bucket_for(n_vis, self.capacity)
            if cap > self.state.capacity:
                self.state = G.expand_state(self.state, cap)
            self.state, n_ins = G.insert(self.state, rows, vis)
            self._n_alive = n_ins
            self._warm_inited = True

    # ------------------------------------------------------------------
    def _vo_edges(self, frame_id: int):
        """The VO's edge map of the frame as the seeding edges, (H, W) bool
        on the map camera (the full-resolution map cropped by `crop_edge`),
        or None for the Canny fallback (always for ScanNet++, as in the
        reference)."""
        if self.odometer is None or \
                self.config["data"]["dataset_name"] == "scannetpp":
            return None
        e = self.odometer.get_edge_image(frame_id)
        if e is None:
            return None
        full = self.dataset.full_camera
        sy = max(int(round(full.height / e.shape[0])), 1)
        if sy > 1:      # the VO ran decimated: upsample back
            e = e.repeat_interleave(sy, 0).repeat_interleave(sy, 1)
            e = e[: full.height, : full.width]
        c = self.dataset.crop_edge
        if c:
            e = e[c:-c, c:-c]
        if tuple(e.shape) != (self.cam.height, self.cam.width):
            return None
        return e

    def _vo_step(self, frame_id: int) -> np.ndarray:
        rgb8, depth = self.dataset.frame_u8(frame_id)
        return self.odometer.step(rgb8, depth,
                                  self.dataset.timestamps[frame_id])

    def map_frame(self, frame_id: int, gt_color, gt_depth,
                  is_new_submap: bool):
        c2w = self.estimated_c2ws[frame_id]
        w2c32 = self._w2c32(c2w)
        c2w32 = torch.as_tensor(c2w, dtype=torch.float32, device=self.device)
        warm = is_new_submap and self._warm_inited
        seed_as_new = is_new_submap and not warm
        key = self._key()
        gumbels = (self.draws.seed_gumbels(key, seed_as_new, gt_depth.numel())
                   if self.draws is not None else None)
        edges = self._vo_edges(frame_id)
        self.seed_edges["canny" if edges is None else "vo"] += 1
        rows, row_valid, n_valid, seeding_mask = M.seed_rows(
            self.state.params, self.state.alive, gt_color, gt_depth, c2w32,
            w2c32, edges, self.cam, self.rcfg, self.mcfg, seed_as_new,
            edges is None, True,
            self.mcfg.outlier_removal and not seed_as_new,
            generator=self._generator(key), gumbels=gumbels)
        if self._n_alive + n_valid > self.state.capacity:
            self.state = G.expand_state(
                self.state, G.bucket_for(self._n_alive + n_valid,
                                         self.capacity))
        exposure = torch.as_tensor(self.exposures_ab[frame_id],
                                   dtype=torch.float32, device=self.device)
        M.push_keyframe(self.kfs, 0, gt_color, gt_depth, w2c32, exposure)
        iters = (self.mcfg.new_submap_iterations if is_new_submap
                 else self.mcfg.iterations)
        # The half-resolution init (mapping.init_halfres_frac) applies to a
        # submap seeded as new only (a warm start is already cheap): phase
        # 1 optimises against the boundary frame's 2x-downsampled copy, its
        # only keyframe, on Camera.scaled(1); phase 2 runs the rest at full
        # resolution, and its descriptor is the full frame's, so loop
        # closure's detection does not depend on the resolution.
        iters_half = (int(round(self.mcfg.init_halfres_frac * iters))
                      if seed_as_new else 0)
        self.state, n_added = G.insert(self.state, rows, row_valid)
        run_half = 0
        if iters_half > 0:
            kfs_half = M.halfres_single_kf(gt_color, gt_depth, w2c32,
                                           exposure)
            self.state, _, _, _, run_half = M.optimize_and_describe(
                self.state, kfs_half, 1, iters_half, self.cam.scaled(1),
                self.rcfg, self.mcfg, **self._samplers(self._key()))
        self.state, losses, n_alive, kf_desc, run_full = \
            M.optimize_and_describe(
                self.state, self.kfs, self.n_kf + 1, iters - iters_half,
                self.cam, self.rcfg, self.mcfg,
                **self._samplers(self._key()))
        slot = self._next_kf_slot()
        if slot is not None:
            M.push_keyframe(self.kfs, slot, gt_color, gt_depth, w2c32,
                            exposure)
        elif not self._warned_reservoir:
            self._warned_reservoir = True
            self.logger.log("info", {"msg": "keyframe window full; reservoir "
                                            "replacement active",
                                     "frame_id": frame_id,
                                     "max_keyframes": self.mcfg.max_keyframes})
        self.submap_kf_frame_ids.append(frame_id)
        self._n_alive = int(n_alive)
        self._kf_descs[frame_id] = kf_desc.cpu().numpy().astype(np.float32)
        if self.verbose:
            p = self.state.params
            from ..core.sh import sh_to_rgb
            from ..ops.rasterizer import render

            with torch.no_grad():
                out = render(p.xyz, p.quats, p.log_scales, p.opacity_logits,
                             sh_to_rgb(p.f_dc), w2c32, self.cam, self.rcfg,
                             alive=self.state.alive)
            self.logger.vis_mapping(frame_id, out.color, out.depth, gt_color,
                                    gt_depth, seeding_mask)
        return {"n_added": int(n_added), "n_alive": self._n_alive,
                "final_loss": float(losses[-1, 0]),
                "iterations": run_half + run_full,
                "halfres_iters": run_half}

    def _apply_lc_corrections(self):
        """Left-multiply the drained correction ranges into the live pose
        array (an open end covers the frames tracked since the submit)."""
        corrs = self.loop_closer.drain_corrections()
        if not corrs:
            return
        for start, end, corr in corrs:
            e = len(self.estimated_c2ws) if end is None else end
            self.estimated_c2ws[start:e] = corr @ self.estimated_c2ws[start:e]
        self._lc_ranges_applied += len(corrs)

    # ------------------------------------------------------------------
    def run(self) -> Dict:
        n = len(self.dataset)
        t0 = time.perf_counter()
        deadline_ts = float(self.config.get("bench_deadline_ts", 0) or 0)
        frames_run = n
        for frame_id in range(n):
            if deadline_ts and time.time() > deadline_ts:
                print(f"deadline: stopping cleanly after {frame_id}/{n} "
                      "frames", flush=True)
                frames_run = frame_id
                break
            t_wait = time.perf_counter()
            gt_color, gt_depth = self.dataset.frame(frame_id)
            data_wait = time.perf_counter() - t_wait
            self.stage_s["data_wait"] += data_wait
            gt_pose = np.asarray(self.dataset.poses[frame_id], np.float64)
            t_track = time.perf_counter()
            if frame_id in (0, 1) or self.gt_camera:
                self.estimated_c2ws[frame_id] = gt_pose
                if self.odometer is not None:
                    if frame_id == 0:
                        self.odometer.set_pose(0, gt_pose)
                    self._vo_step(frame_id)
                    self.odometer.set_pose(frame_id, gt_pose)
                    self._vo_last = gt_pose
            else:
                p1 = self.estimated_c2ws[frame_id - 1]
                p2 = self.estimated_c2ws[frame_id - 2]
                candidates = {"const_speed": p1 @ np.linalg.inv(p2) @ p1,
                              "previous": p1}
                vo_ms = None
                if self.odometer is not None:
                    t_vo = time.perf_counter()
                    vo_c2w = self._vo_step(frame_id)
                    vo_ms = 1e3 * (time.perf_counter() - t_vo)
                    if self._vo_decoupled:
                        if frame_id >= 3 and self._vo_last is not None:
                            candidates["odometer"] = (
                                p1 @ np.linalg.inv(self._vo_last) @ vo_c2w)
                        self._vo_last = vo_c2w
                    elif frame_id >= 3:
                        candidates["odometer"] = vo_c2w
                c2w, exposure, stats = self.tracker.track(
                    self.state.params, self.state.alive,
                    self.estimated_c2ws[frame_id - 1], candidates,
                    gt_color, gt_depth)
                self.estimated_c2ws[frame_id] = c2w
                self.exposures_ab[frame_id] = np.asarray(exposure)
                if self.odometer is not None and not self._vo_decoupled:
                    self.odometer.set_pose(frame_id, c2w)
                if vo_ms is not None:
                    stats["vo_ms"] = vo_ms
                stats["data_wait_ms"] = 1e3 * data_wait
                self.logger.log_tracking(
                    frame_id, {k: float(v) for k, v in stats.items()})
                if self.tcfg.debug_per_iter:
                    self.logger.log("track_iters", {
                        "frame_id": frame_id,
                        "names": list(TT.DEBUG_ITER_NAMES),
                        "iters": np.round(self.tracker.last_per_iter,
                                          6).tolist()})
            self._sync()
            self.track_times.append(time.perf_counter() - t_track)

            is_new_submap = False
            if frame_id != 0 and self.should_start_new_submap(frame_id):
                t_b = time.perf_counter()
                path = self.save_current_submap()
                if self.loop_closer is not None and path is not None:
                    self.loop_closer.submit(self.submap_id, frame_id,
                                            self.estimated_c2ws)
                self.start_new_submap(frame_id)
                is_new_submap = True
                self.stage_s["boundary"] += time.perf_counter() - t_b

            if frame_id in self.mapping_frame_ids or is_new_submap:
                t_map = time.perf_counter()
                stats = self.map_frame(frame_id, gt_color, gt_depth,
                                       is_new_submap or frame_id == 0)
                self._sync()
                self.map_times.append(time.perf_counter() - t_map)
                stats["map_ms"] = 1e3 * self.map_times[-1]
                stats["is_new"] = bool(is_new_submap or frame_id == 0)
                self.logger.log_mapping(frame_id, stats)

            if self.loop_closer is not None:
                t_d = time.perf_counter()
                self.loop_closer.check_futures()
                self._apply_lc_corrections()
                self.stage_s["lc_drain"] += time.perf_counter() - t_d

        path = self.save_current_submap()
        if self.loop_closer is not None:
            if path is not None and self.lc_final:
                self.loop_closer.submit(self.submap_id, frames_run - 1,
                                        self.estimated_c2ws)
            self.loop_closer.finalize()
            self._apply_lc_corrections()
        total = time.perf_counter() - t0
        np.savez(os.path.join(self.output_path, "estimated_c2w.npz"),
                 c2ws=self.estimated_c2ws, exposures=self.exposures_ab)
        report = {
            "frames": frames_run,
            "fps": frames_run / total,
            "total_s": total,
            "track_ms_avg": 1e3 * float(np.mean(self.track_times)),
            "map_ms_avg": 1e3 * float(np.mean(self.map_times))
            if self.map_times else 0,
            "map_frames": len(self.map_times),
            "data_wait_ms_avg": 1e3 * self.stage_s["data_wait"]
            / max(frames_run, 1),
            "data": self.dataset.report(),
            "seed_edges": dict(self.seed_edges),
            "stage_totals_s": {
                "track": round(float(np.sum(self.track_times)), 2),
                "map": round(float(np.sum(self.map_times)), 2),
                **{k: round(v, 2) for k, v in self.stage_s.items()},
            },
            "tracker": self.tracker.report(),
        }
        if self.odometer is not None:
            report["vo"] = self.odometer.report()
            self.odometer.dump_tum(
                os.path.join(self.output_path, "vo_traj_tum.txt"),
                self.dataset.timestamps)
        if self.loop_closer is not None:
            report["lc"] = {**self.loop_closer.report(),
                            "corrections_applied": self._lc_ranges_applied}
        self.logger.log("report", report)
        return report

    def cleanup(self):
        if self.loop_closer is not None:
            self.loop_closer.shutdown()
        self.dataset.close()
        self.logger.close()
