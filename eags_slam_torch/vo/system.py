"""Edge-VO system: frame lifecycle, keyframe policy, pose graph (port of
eags_slam_tpu.vo.system).

  - per frame: pyramid build, then coarse-to-fine LM over the levels against
    the current keyframe, from the constant-velocity guess; at the coarsest
    level the identity is tried too and the cheaper solve wins;
  - keyframe rule A: good / bad edge-point ratio below `good_bad_ratio`;
  - keyframe rule B: histogram voting over the last
    `n_frames_histogram_voting` edge clouds reprojected into the current
    frame, weights (0, 1, 1.25, 1.5): a new keyframe when
    sum(w_i * overlap_i) < overlap_0;
  - on a new keyframe the PREVIOUS frame is promoted and the current frame
    re-tracked against it; only the newest keyframe keeps its pyramid and
    distance transforms (older ones keep their pose for the graph), so the
    VO's device memory does not grow with the frames;
  - pose graph (keyframe, T_kf_frame) with world pose T_w_kf @ T_kf_frame,
    external pose injection `set_pose`, `report()`, `dump_tum`.

The VO runs where `device` says: "cpu" pins it to the host CPU (its
inputs are moved there, and its pyramids, distance transforms and LM run on
CPU tensors, so a worker thread can run it beside the SLAM loop's device
work: `GaussianSLAM` pipelines it one frame ahead); any other value
inherits the device of the tensors it is given (the SLAM device), and the
VO runs on the caller's current stream. `step` may run on a worker thread
while the caller reads `get_edge_image`: the edge cache is locked.

Its times (`stages`, host clock): the step (`vo.step`) and the keyframe's
build (`vo.keyframe`, what its launches take the host: nothing waits for
the card), and, while the tracer records (`utils/tracing.py`), the spans
`vo.pyramid` and `vo.align` inside the step.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..utils import tracing
from .lm import LMResult, LMSettings, lm_align
from .pyramid import FramePyramid, build_pyramid, make_keyframe


class VOConfig(NamedTuple):
    levels: int = 3
    min_level: int = 0
    canny_low: float = 100.0
    canny_high: float = 200.0
    depth_min: float = 0.1
    depth_max: float = 10.0
    max_edge_points: int = 8192
    huber_edge: float = 0.3
    dist_filter: tuple = (30.0, 20.0, 10.0, 5.0, 5.0, 5.0)
    lm_max_iters: int = 100
    lm_eps: float = 0.999
    n_frames_histogram_voting: int = 3
    hist_weights: tuple = (0.0, 1.0, 1.25, 1.5)
    histogram_level: int = 1
    good_bad_ratio: float = 4.0
    dt_window: int = 32
    # The VO runs at full_res / 2^downscale_levels (GaussianSLAM sets 1 for
    # frames wider than 800 px unless the config pins it).
    downscale_levels: int = 0
    device: str = "default"

    @staticmethod
    def from_dict(d: Dict) -> "VOConfig":
        return VOConfig(
            levels=int(d.get("pyramid_levels", 3)),
            min_level=int(d.get("min_level", 0)),
            canny_low=float(d.get("canny_low", 100.0)),
            canny_high=float(d.get("canny_high", 200.0)),
            depth_min=float(d.get("depth_min", 0.1)),
            depth_max=float(d.get("depth_max", 10.0)),
            max_edge_points=int(d.get("max_edge_points", 8192)),
            huber_edge=float(d.get("huber_edge", 0.3)),
            dist_filter=tuple(d.get("edge_distance_filter",
                                    (30.0, 20.0, 10.0, 5.0, 5.0, 5.0))),
            lm_max_iters=int(d.get("lm_max_iters", 100)),
            lm_eps=float(d.get("lm_eps", 0.999)),
            good_bad_ratio=float(d.get("good_bad_ratio", 4.0)),
            dt_window=int(d.get("dt_window", 32)),
            downscale_levels=int(d.get("downscale_levels", 0)),
            device=str(d.get("device", "default")),
        )


def _settings(cfg: VOConfig, lvl: int) -> LMSettings:
    df = cfg.dist_filter
    return LMSettings(huber_edge=cfg.huber_edge, max_iters=cfg.lm_max_iters,
                      eps=cfg.lm_eps,
                      dist_filter=float(df[min(lvl, len(df) - 1)]))


def _fused_track(levels, kf_levels, R0, t0, cam: Camera,
                 cfg: VOConfig) -> LMResult:
    """Coarse-to-fine LM over the levels; at the coarsest level the solve
    from the identity replaces the one from the guess when it is cheaper."""
    R, t = R0, t0
    res = None
    for lvl in range(cfg.levels - 1, cfg.min_level - 1, -1):
        pts, valid = levels[lvl]
        gx, gy, dt = kf_levels[lvl]
        cam_l = cam.scaled(lvl)
        res = lm_align(pts, valid, gx, gy, dt, R, t, cam_l,
                       _settings(cfg, lvl))
        if lvl == cfg.levels - 1:
            res_eye = lm_align(pts, valid, gx, gy, dt,
                               torch.eye(3, device=R.device),
                               torch.zeros(3, device=R.device), cam_l,
                               _settings(cfg, lvl))
            if res_eye.cost < res.cost:
                res = res_eye
        R, t = res.R, res.t
    return res


def _voting_counts(clouds, curr_edges, curr_depth, depth_min: float,
                   depth_max: float, cam: Camera, n_bins: int):
    """Weighted-overlap histogram (tracker.cpp:120-226 of the reference):
    counts[i] = current edge pixels (with valid depth) hit by exactly i of
    the reprojected clouds; `clouds` is a list of (pts, valid, T (4, 4))
    with T mapping the cloud's frame into the current one."""
    h, w = curr_edges.shape
    hits = torch.zeros(h * w + 1, dtype=torch.int32, device=curr_edges.device)
    for pts, valid, T in clouds:
        p = pts @ T[:3, :3].T + T[:3, 3]
        z = torch.clamp(p[:, 2], min=1e-6)
        # Clamp before the integer cast (an out-of-range float cast is
        # undefined in PyTorch; XLA saturates): the bounds test below gives
        # the same answer on the clamped values.
        u = torch.clamp(torch.floor(p[:, 0] / z * cam.fx + cam.cx),
                        -1, w).to(torch.int64)
        v = torch.clamp(torch.floor(p[:, 1] / z * cam.fy + cam.cy),
                        -1, h).to(torch.int64)
        ok = valid & (p[:, 2] > 1e-6) & (u >= 0) & (u < w) & (v >= 0) \
            & (v < h)
        # Dropped writes land in the sentinel slot h * w.
        m = torch.zeros(h * w + 1, dtype=torch.int32, device=hits.device)
        m[torch.where(ok, v * w + u, torch.full_like(u, h * w))] = 1
        hits += m
    hits = hits[: h * w].reshape(h, w)
    edge_px = curr_edges & (curr_depth > depth_min) & (curr_depth < depth_max)
    return torch.stack([(edge_px & (hits == i)).sum()
                        for i in range(n_bins)]).cpu().numpy()


@dataclass
class _Keyframe:
    frame_id: int
    pyramid: Optional[FramePyramid]   # None once a newer keyframe exists
    dt_levels: Optional[tuple]
    T_w_kf: np.ndarray  # (4, 4) f64


def _T(res: LMResult) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = res.R.cpu().numpy().astype(np.float64)
    T[:3, 3] = res.t.cpu().numpy().astype(np.float64)
    return T


class EdgeVO:
    """`step(rgb, depth, ts) -> Twc`, `set_pose` / `get_pose`,
    `get_edge_image`, `report`, `dump_tum` (the reference's pybind
    surface). rgb is (H, W, 3) uint8 and depth (H, W) float metres, torch
    tensors on the VO's device (or anywhere, when it is pinned to the
    CPU)."""

    def __init__(self, cfg: VOConfig, cam: Camera):
        self.cfg = cfg
        self._ds = max(int(cfg.downscale_levels), 0)
        self.cam = cam.scaled(self._ds) if self._ds else cam
        # "cpu" pins the VO to the host; anything else inherits.
        self._device = torch.device("cpu") if cfg.device == "cpu" else None
        self.keyframes: List[_Keyframe] = []
        self.graph: List[tuple] = []     # per frame (kf_index, T_kf_frame)
        self._edge_lock = threading.Lock()
        self.edge_cache: Dict[int, torch.Tensor] = {}
        self.prev_pyramid: Optional[FramePyramid] = None
        self.past_clouds = deque(maxlen=cfg.n_frames_histogram_voting)
        self.stages = tracing.Stages()
        self._start_pose = np.eye(4)

    @property
    def on_cpu(self) -> bool:
        """Pinned to the host CPU (`device: cpu`)."""
        return self._device is not None

    # -- pose graph ---------------------------------------------------------
    def _world_pose(self, frame_id: int) -> np.ndarray:
        kf_idx, T_kf_frame = self.graph[frame_id]
        return self.keyframes[kf_idx].T_w_kf @ T_kf_frame

    def get_pose(self, frame_id: int) -> np.ndarray:
        return self._world_pose(frame_id)

    def set_pose(self, frame_id: int, c2w: np.ndarray):
        """External pose injection (REVO::setPose)."""
        c2w = np.asarray(c2w, np.float64)
        if frame_id >= len(self.graph):
            self._start_pose = c2w
            return
        kf_idx, _ = self.graph[frame_id]
        kf = self.keyframes[kf_idx]
        if kf.frame_id == frame_id:
            kf.T_w_kf = c2w
            self.graph[frame_id] = (kf_idx, np.eye(4))
        else:
            self.graph[frame_id] = (kf_idx, np.linalg.inv(kf.T_w_kf) @ c2w)

    def get_edge_image(self, frame_id: int) -> Optional[torch.Tensor]:
        """The finest-level edge mask of a recent frame (H, W) bool, at the
        VO's resolution, on the VO's device, or None."""
        with self._edge_lock:
            return self.edge_cache.get(frame_id)

    # -- tracking -----------------------------------------------------------
    def _lm_inputs(self, kf: _Keyframe, pyr: FramePyramid,
                   T_kf_cur_init: np.ndarray):
        dev = pyr.levels[0].pts.device
        return (tuple((lv.pts, lv.pts_valid) for lv in pyr.levels),
                tuple((d.gx, d.gy, d.dt) for d in kf.dt_levels),
                torch.as_tensor(T_kf_cur_init[:3, :3], dtype=torch.float32,
                                device=dev),
                torch.as_tensor(T_kf_cur_init[:3, 3], dtype=torch.float32,
                                device=dev))

    def _track_against(self, kf: _Keyframe, pyr: FramePyramid,
                       T_kf_cur_init: np.ndarray):
        res = _fused_track(*self._lm_inputs(kf, pyr, T_kf_cur_init),
                           self.cam, self.cfg)
        return _T(res), res

    def _track_vote(self, kf: _Keyframe, pyr: FramePyramid,
                    T_kf_cur_init: np.ndarray):
        """LM track, then the voting counts at the final pose."""
        res = _fused_track(*self._lm_inputs(kf, pyr, T_kf_cur_init),
                           self.cam, self.cfg)
        hl = min(self.cfg.histogram_level, self.cfg.levels - 1)
        lv = pyr.levels[hl]
        dev = lv.pts.device
        Rt = res.R.T
        Tinv = torch.eye(4, device=dev)
        Tinv[:3, :3] = Rt
        Tinv[:3, 3] = -Rt @ res.t
        kf_inv = np.linalg.inv(kf.T_w_kf)
        clouds = [(pts, valid, Tinv @ torch.as_tensor(
                      (kf_inv @ T_w).astype(np.float32), device=dev))
                  for pts, valid, T_w in self.past_clouds]
        counts = _voting_counts(clouds, lv.edges, lv.depth,
                                self.cfg.depth_min, self.cfg.depth_max,
                                self.cam.scaled(hl),
                                self.cfg.n_frames_histogram_voting + 1)
        return _T(res), res, counts

    def _needs_new_kf(self, res: LMResult, counts: np.ndarray) -> bool:
        good, bad = res.good, res.bad
        if bad > 0 and good / max(bad, 1) < self.cfg.good_bad_ratio:
            return True
        if len(self.past_clouds) < self.cfg.n_frames_histogram_voting:
            return False
        w = self.cfg.hist_weights
        overlap = sum(float(counts[i]) * w[min(i, len(w) - 1)]
                      for i in range(1, len(counts)))
        return overlap < float(counts[0])

    def _promote_keyframe(self, frame_id: int, pyr: FramePyramid,
                          T_w_frame: np.ndarray):
        with self.stages.span("vo.keyframe"):
            dt_levels = make_keyframe(pyr, self.cfg.dt_window)
        if self.keyframes:
            # Frames track against the newest keyframe only: the older one
            # keeps its pose for the graph, its pyramid and distance
            # transforms (8.3 MiB at 640x480) go.
            old = self.keyframes[-1]
            old.pyramid = old.dt_levels = None
        self.keyframes.append(_Keyframe(frame_id, pyr, dt_levels,
                                        np.asarray(T_w_frame, np.float64)))

    @torch.no_grad()
    def step(self, rgb: torch.Tensor, depth: torch.Tensor,
             timestamp: float) -> np.ndarray:
        """Process one frame; returns Twc (4, 4) float64. A VO pinned to
        the CPU takes its inputs there (tensors or arrays)."""
        with self.stages.span("vo.step"):
            return self._step(rgb, depth, timestamp)

    def _step(self, rgb, depth, timestamp: float) -> np.ndarray:
        if self._device is not None:
            rgb = torch.as_tensor(rgb).to(self._device)
            depth = torch.as_tensor(depth).to(self._device)
        if self._ds:
            f = 1 << self._ds
            h, w = self.cam.height * f, self.cam.width * f
            rgb = rgb[:h:f, :w:f]
            depth = depth[:h:f, :w:f]
        frame_id = len(self.graph)
        with tracing.span("vo.pyramid"):
            pyr = build_pyramid(rgb, depth, self.cam, self.cfg.levels,
                                self.cfg.max_edge_points, self.cfg.canny_low,
                                self.cfg.canny_high, self.cfg.depth_min,
                                self.cfg.depth_max, timestamp)
        with self._edge_lock:
            self.edge_cache[frame_id] = pyr.levels[0].edges
            for k in [k for k in self.edge_cache if k < frame_id - 4]:
                del self.edge_cache[k]

        if frame_id == 0:
            self._promote_keyframe(0, pyr, self._start_pose)
            self.graph.append((0, np.eye(4)))
            self.prev_pyramid = pyr
            return self._world_pose(0)

        # Constant-velocity guess.
        T_w_prev = self._world_pose(frame_id - 1)
        if frame_id >= 2:
            T_w_prev2 = self._world_pose(frame_id - 2)
            T_w_init = T_w_prev @ (np.linalg.inv(T_w_prev2) @ T_w_prev)
        else:
            T_w_init = T_w_prev

        kf_idx = len(self.keyframes) - 1
        kf = self.keyframes[kf_idx]
        with tracing.span("vo.align"):
            T_kf_cur, res, counts = self._track_vote(
                kf, pyr, np.linalg.inv(kf.T_w_kf) @ T_w_init)
        T_w_cur = kf.T_w_kf @ T_kf_cur
        if self._needs_new_kf(res, counts) and self.prev_pyramid is not None:
            # Promote the previous frame and re-track against it.
            self._promote_keyframe(frame_id - 1, self.prev_pyramid,
                                   self._world_pose(frame_id - 1))
            kf_idx = len(self.keyframes) - 1
            kf = self.keyframes[kf_idx]
            with tracing.span("vo.align"):
                T_kf_cur, res = self._track_against(
                    kf, pyr, np.linalg.inv(kf.T_w_kf) @ T_w_init)
            T_w_cur = kf.T_w_kf @ T_kf_cur

        self.graph.append((kf_idx, T_kf_cur))
        hl = min(self.cfg.histogram_level, self.cfg.levels - 1)
        self.past_clouds.append((pyr.levels[hl].pts,
                                 pyr.levels[hl].pts_valid, T_w_cur))
        self.prev_pyramid = pyr
        return T_w_cur

    def report(self) -> Dict:
        """Keyframes, and the host's mean ms a step and a keyframe's build
        (`mean_dt_ms`: the launches of the distance transform, which the
        step does not wait for)."""
        return {
            "n_keyframes": len(self.keyframes),
            "mean_track_ms": self.stages.mean_ms("vo.step"),
            "mean_dt_ms": self.stages.mean_ms("vo.keyframe"),
        }

    def dump_tum(self, path: str, timestamps=None):
        """The pose-graph trajectory in TUM format
        `timestamp tx ty tz qx qy qz qw`."""
        from ..slam.submap import _rotmat_to_quat_np

        with open(path, "w") as f:
            f.write("# timestamp tx ty tz qx qy qz qw\n")
            for fid in range(len(self.graph)):
                T = self._world_pose(fid)
                t = T[:3, 3]
                q = _rotmat_to_quat_np(T[:3, :3])  # wxyz
                ts = (timestamps[fid] if timestamps is not None
                      else fid / 30.0)
                f.write(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                        f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")
