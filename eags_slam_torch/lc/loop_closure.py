"""Parallel loop closure: detection, registration, PGO, correction (port of
eags_slam_tpu.lc.loop_closure).

At each submap boundary the SLAM loop saves the submap and `submit`s it.
A one-worker executor then loads the submap file, describes its keyframes
(or reads the descriptors saved with it) and sets per-keyframe
self-similarity thresholds, detects earlier submaps whose keyframes look
alike, registers the pair (`gs_reg` by default), and when a loop edge is
found solves the pose graph of all submaps (odometry + loop edges) and
publishes per-range correction transforms. The SLAM loop drains them after
every frame (`drain_corrections`) and left-multiplies its live pose array;
the closer also rewrites each submap's `T_prev_m` on disk.

The reference runs this on a second GPU (`lc.device: 1`). Here it shares
the SLAM loop's card: the worker issues all of its device work on a CUDA
stream of its own, after an event recorded on the submitting thread's
stream, and its kernel launches count apart from the main path's
(`composite_sorted.counts("lc")`). Frames and submaps cross threads as
numpy pose arrays and submap files. An exception in the worker fails the
run through `check_futures` / `finalize`. With `parallel: false` the same
pass runs inline on the calling thread (still on the closer's stream).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..ops.rasterizer import RasterConfig
from ..slam.submap import Submap
from ..utils.tracing import counting_as
from .descriptor import GlobalDesc
from .pgo import PoseGraph, optimize_pose_graph, scalar_info
from .solver import (RegistrationResult, gaussian_registration,
                     icp_registration, information_matrix)

LC_TAG = "lc"   # the launch-count tag of the closer's work


@dataclass
class _SubmapInfo:
    submap: Submap
    descriptors: np.ndarray          # (K, D)
    self_sim_thre: np.ndarray        # (K,) per-keyframe threshold
    start_frame: int
    end_frame: int                   # exclusive


class LoopClosure:
    def __init__(self, config: Dict, output_path: str, cam: Camera,
                 dataset=None, device="cpu"):
        lc = config.get("lc", {})
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("loop closure on 'cuda' but no CUDA device is "
                               "available")
        self.enabled = bool(lc.get("enabled", True))
        self.parallel = bool(lc.get("parallel", True))
        self.min_interval = int(lc.get("min_interval", 3))
        self.min_similarity = float(lc.get("min_similarity", 0.7))
        self.self_sim_topk = int(lc.get("self_sim_topk", 3))
        self.overlap_thre = float(lc.get("overlap_thre", 0.2))
        # `registration`: the reference's nested form {method, base_lr,
        # min_overlap_ratio, use_render} or a method string with sibling
        # keys reg_base_lr / use_render / overlap_thre.
        reg = lc.get("registration", "gs_reg")
        if isinstance(reg, dict):
            self.registration = str(reg.get("method", "gs_reg"))
            self.reg_base_lr = float(reg.get("base_lr", 1e-3))
            self.overlap_thre = float(
                reg.get("min_overlap_ratio", self.overlap_thre))
            self.use_render = bool(reg.get("use_render", False))
        else:
            self.registration = str(reg)
            self.reg_base_lr = float(lc.get("reg_base_lr", 1e-3))
            self.use_render = bool(lc.get("use_render", False))
        self.pose_opt_iters = int(lc.get("pose_opt_iters", 100))
        self.top_views = int(lc.get("top_views", 2))
        # Pyramid level of the gs_reg localisations (0 = full resolution).
        self.localize_level = int(lc.get("localize_level", 1))
        # Frozen-sorted segments per localisation (1 = re-bin every step).
        self.localize_restarts = int(lc.get("localize_restarts", 4))
        # Loop edges whose final line-process weight falls below this are
        # dropped (o3d edge_prune_threshold); 0 disables.
        self.pgo_edge_prune_thres = float(lc.get("pgo_edge_prune_thres",
                                                 0.25))
        self.info_max_corr = float(lc.get("info_max_corr", 0.1))
        self.capacity = int(lc.get(
            "capacity", config["mapping"].get("max_gaussians", 1 << 18)))
        # Registration renders a seeded subsample of each submap.
        self.reg_capacity = int(lc.get("reg_capacity",
                                       min(self.capacity, 1 << 16)))
        self.output_path = output_path
        self.cam = cam
        self.dataset = dataset
        self.verbose = bool(config.get("verbose", False))
        self._pgo_count = 0
        self.rcfg = RasterConfig(tile=16, dup_side=4)
        self.desc = GlobalDesc(device=self.device)
        self.infos: List[_SubmapInfo] = []
        self.loop_edges: List[tuple] = []   # (i, j, Z, info)
        # Pending (start, end | None, corr 4x4) left-multiplications for
        # the SLAM loop's live pose array; end None: to the array's end.
        self._pending: List[tuple] = []
        self._twc: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        self._futures: List[concurrent.futures.Future] = []
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.n_closures = 0
        # Per-submit latencies (ms): detection, each registration, PGO.
        self.latencies: List[dict] = []
        self._odo_infos: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------
    def submit(self, submap_id: int, frame_id: int,
               estimated_c2ws: np.ndarray):
        """Run loop closure for the just-saved submap: on the worker
        thread, or inline with `parallel: false`."""
        if not self.enabled:
            return None
        twc = np.array(estimated_c2ws, np.float64)
        ready = None
        if self._stream is not None:
            # The worker's stream starts after what this thread issued.
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        if not self.parallel:
            self._run(submap_id, frame_id, twc, ready)
            return None
        fut = self._executor.submit(self._run, submap_id, frame_id, twc,
                                    ready)
        self._futures.append(fut)
        return fut

    def report(self) -> dict:
        tot = [lat["total_ms"] for lat in self.latencies]
        reg = [r for lat in self.latencies for r in lat["register_ms"]]
        return {
            "n_submits": len(self.latencies),
            "n_closures": self.n_closures,
            "submit_ms_mean": float(np.mean(tot)) if tot else 0.0,
            "submit_ms_max": float(np.max(tot)) if tot else 0.0,
            "register_ms_mean": float(np.mean(reg)) if reg else 0.0,
            "latencies": self.latencies,
        }

    def check_futures(self):
        """Re-raise an exception of a finished background pass."""
        done = [f for f in self._futures if f.done()]
        for f in done:
            self._futures.remove(f)
            exc = f.exception()
            if exc is not None:
                raise exc

    def drain_corrections(self) -> Optional[List[tuple]]:
        """Pending (start, end | None, corr) left-multiplications, to apply
        in order to the CURRENT pose array: frames tracked between submit
        and drain keep their values and take the last range's correction."""
        with self._lock:
            if not self._pending:
                return None
            out = self._pending
            self._pending = []
        return out

    def finalize(self):
        self._executor.shutdown(wait=True)
        self.check_futures()

    def shutdown(self):
        self._executor.shutdown(wait=False, cancel_futures=True)

    def save_twc(self, path: Optional[str] = None):
        if self._twc is None:
            return
        path = path or os.path.join(self.output_path, "estimated_c2w.npz")
        np.savez(path, c2ws=self._twc)

    # ------------------------------------------------------------------
    def _keyframe_views(self, info: _SubmapInfo, Twm: np.ndarray) -> List:
        """One zero-argument loader per keyframe: a frame is read only when
        the registration selects its view."""
        def loader(k, fid):
            def load():
                _, color, depth, _ = self.dataset[int(fid)]
                return {"c2w": Twm @ info.submap.Tmc[k],
                        "color": torch.as_tensor(color, device=self.device),
                        "depth": torch.as_tensor(depth, device=self.device)}
            return load

        return [loader(k, fid)
                for k, fid in enumerate(info.submap.kf_frame_ids)]

    def _load_submap_info(self, submap_id: int, end_frame: int):
        """Load the submitted submap's file, its keyframe descriptors and
        self-similarity thresholds (the mean of each keyframe's top-k
        similarities to the submap's other keyframes)."""
        path = os.path.join(self.output_path, "submaps",
                            f"{submap_id:06d}.npz")
        if not os.path.exists(path):
            import warnings

            warnings.warn(f"loop closure: submap file missing: {path}")
            return
        sm = Submap.load(path)
        if (sm.descs is not None and sm.descs.ndim == 2
                and sm.descs.shape == (len(sm.kf_frame_ids), self.desc.dim)):
            descs = np.asarray(sm.descs, np.float32)
        else:
            descs = [self.desc(self.dataset[int(fid)][1]).cpu().numpy()
                     for fid in sm.kf_frame_ids]
            descs = (np.stack(descs) if descs
                     else np.zeros((0, self.desc.dim)))
        if len(descs) > 1:
            sim = descs @ descs.T
            np.fill_diagonal(sim, -1.0)
            k = min(self.self_sim_topk, len(descs) - 1)
            thre = np.sort(sim, axis=1)[:, -k:].mean(axis=1)
            thre = np.maximum(thre, self.min_similarity)
        else:
            thre = np.full((len(descs),), self.min_similarity)
        self.infos.append(_SubmapInfo(sm, descs, thre, sm.kf_id, end_frame))

    def _detect_closures(self, cur: int) -> List[int]:
        """Earlier submaps (at least `min_interval` back) one of whose
        keyframes some keyframe of submap `cur` resembles above its
        self-similarity threshold."""
        out = []
        cur_desc = self.infos[cur].descriptors
        if cur_desc.size == 0:
            return out
        for j in range(len(self.infos)):
            if cur - j < self.min_interval:
                continue
            dj = self.infos[j].descriptors
            if dj.size == 0:
                continue
            hit = (cur_desc @ dj.T).max(axis=0) > self.infos[j].self_sim_thre
            if hit.any():
                out.append(j)
        return out

    def _anchor_world_poses(self) -> np.ndarray:
        """Chain T_prev_m into world anchor poses."""
        poses = []
        T = np.eye(4)
        for info in self.infos:
            T = T @ info.submap.T_prev_m
            poses.append(T.copy())
        return np.stack(poses)

    def _register(self, i: int, j: int, anchors: np.ndarray,
                  timings=None) -> RegistrationResult:
        """Register current submap i against matched submap j."""
        t0 = time.perf_counter()
        info_i, info_j = self.infos[i], self.infos[j]
        g_i = info_i.submap.restore_world(anchors[i])
        g_j = info_j.submap.restore_world(anchors[j])
        if timings is not None:
            timings["restore_ms"] = 1e3 * (time.perf_counter() - t0)
        if self.registration == "identity":
            return RegistrationResult(True, np.eye(4), 1.0, 1.0)
        if self.registration == "gt" and self.dataset is not None:
            # The ground-truth correction, for analysis runs.
            gt_rel = np.asarray(self.dataset.poses[info_j.submap.kf_id]) \
                @ np.linalg.inv(np.asarray(
                    self.dataset.poses[info_i.submap.kf_id]))
            est_rel = anchors[j] @ np.linalg.inv(anchors[i])
            return RegistrationResult(True, np.linalg.inv(est_rel) @ gt_rel,
                                      1.0, 1.0)
        if self.registration in ("icp", "robust_icp"):
            res = icp_registration(g_j, g_i,
                                   robust=self.registration == "robust_icp",
                                   device=self.device)
        else:
            res = gaussian_registration(
                g_j, g_i, self._keyframe_views(info_j, anchors[j]),
                self._keyframe_views(info_i, anchors[i]), info_j.descriptors,
                info_i.descriptors, self.cam, self.rcfg, self.reg_capacity,
                self.overlap_thre, self.top_views, self.pose_opt_iters,
                base_lr=self.reg_base_lr, use_render=self.use_render,
                localize_level=self.localize_level,
                localize_restarts=self.localize_restarts,
                timings=timings, device=self.device)
        if res.successful and res.information is None:
            t0 = time.perf_counter()
            res = res._replace(information=self._edge_information(
                g_i, g_j, res.transformation))
            if timings is not None:
                timings["info_ms"] = 1e3 * (time.perf_counter() - t0)
        return res

    def _edge_information(self, g_i, g_j, C: np.ndarray) -> np.ndarray:
        """Correspondence-count-normalised 6x6 information of an edge, on
        seeded 4096-point subsamples."""
        src = np.asarray(g_i["xyz"], np.float64)
        tgt = np.asarray(g_j["xyz"], np.float64)
        rng = np.random.default_rng(0)
        if src.shape[0] > 4096:
            src = src[rng.choice(src.shape[0], 4096, replace=False)]
        if tgt.shape[0] > 4096:
            tgt = tgt[rng.choice(tgt.shape[0], 4096, replace=False)]
        src_c = src @ C[:3, :3].T + C[:3, 3]
        info = information_matrix(src_c.astype(np.float32),
                                  tgt.astype(np.float32), self.info_max_corr,
                                  device=self.device)
        return info / max(float(info[0, 0]), 1.0)

    def _odo_information(self, s: int, anchors: np.ndarray) -> np.ndarray:
        """Information of the odometry edge (s-1, s), cached per pair."""
        if s in self._odo_infos:
            return self._odo_infos[s]
        g_prev = self.infos[s - 1].submap.restore_world(anchors[s - 1])
        g_cur = self.infos[s].submap.restore_world(anchors[s])
        info = self._edge_information(g_cur, g_prev, np.eye(4))
        self._odo_infos[s] = info
        return info

    def _run(self, submap_id: int, frame_id: int, twc: np.ndarray,
             ready=None):
        """One pass on the closer's stream, its launches counted apart."""
        if self._stream is None:
            with counting_as(LC_TAG):
                return self._run_inner(submap_id, frame_id, twc)
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self._stream))
            stack.enter_context(counting_as(LC_TAG, self._stream))
            self._stream.wait_event(ready)
            try:
                return self._run_inner(submap_id, frame_id, twc)
            finally:
                self._stream.synchronize()

    def _run_inner(self, submap_id: int, frame_id: int, twc: np.ndarray):
        t_start = time.perf_counter()
        # t_start: wall clock, to line the pass up with the SLAM loop's log.
        lat = {"submap_id": submap_id, "n_matches": 0, "register_ms": [],
               "pgo_ms": 0.0, "t_start": time.time()}
        self.latencies.append(lat)
        self._load_submap_info(submap_id, frame_id)
        if not self.infos:
            lat["total_ms"] = 1e3 * (time.perf_counter() - t_start)
            return
        cur = len(self.infos) - 1
        self._twc = twc

        t0 = time.perf_counter()
        matches = self._detect_closures(cur)
        anchors = self._anchor_world_poses()
        lat["detect_ms"] = 1e3 * (time.perf_counter() - t0)
        lat["n_matches"] = len(matches)
        new_edges = []
        for j in matches:
            t0 = time.perf_counter()
            phases = {}
            res = self._register(cur, j, anchors, timings=phases)
            lat["register_ms"].append(1e3 * (time.perf_counter() - t0))
            lat.setdefault("register_phases", []).append(phases)
            if not res.successful or not np.all(
                    np.isfinite(res.transformation)):
                continue
            # Loop edge measurement: Z_j_cur = inv(X_j) @ C @ X_cur.
            Z = np.linalg.inv(anchors[j]) @ res.transformation @ anchors[cur]
            info6 = res.information if res.information is not None else (
                scalar_info(max(res.fitness, 1e-2)).numpy())
            new_edges.append((j, cur, Z, info6))
        self.loop_edges.extend(new_edges)
        if not new_edges:
            lat["total_ms"] = 1e3 * (time.perf_counter() - t_start)
            return

        self.n_closures += len(new_edges)
        t_pgo = time.perf_counter()
        n = len(self.infos)
        edges_ij, edges_T, edges_info, edges_is_loop = [], [], [], []
        for s in range(1, n):
            edges_ij.append((s - 1, s))
            edges_T.append(np.linalg.inv(anchors[s - 1]) @ anchors[s])
            edges_info.append(self._odo_information(s, anchors))
            edges_is_loop.append(False)
        lat["odo_info_ms"] = 1e3 * (time.perf_counter() - t_pgo)
        for (i, j, Z, info6) in self.loop_edges:
            edges_ij.append((i, j))
            edges_T.append(Z)
            edges_info.append(np.asarray(info6, np.float64))
            edges_is_loop.append(True)

        f32 = torch.float32
        graph = PoseGraph(
            poses=torch.as_tensor(anchors, dtype=f32),
            edges_ij=torch.as_tensor(np.asarray(edges_ij, np.int64)),
            edges_T=torch.as_tensor(np.stack(edges_T), dtype=f32),
            edges_info=torch.as_tensor(np.stack(edges_info), dtype=f32),
            edges_valid=torch.ones(len(edges_ij), dtype=torch.bool),
            edges_is_loop=torch.as_tensor(edges_is_loop))
        t_solve = time.perf_counter()
        corrected = optimize_pose_graph(
            graph, edge_prune_thres=(self.pgo_edge_prune_thres or None)
        ).numpy().astype(np.float64)
        lat["pgo_solve_ms"] = 1e3 * (time.perf_counter() - t_solve)
        self._pgo_count += 1
        if self.verbose:
            self._analyse_pgo(anchors, corrected, edges_ij, edges_T,
                              edges_is_loop)
        t_apply = time.perf_counter()
        self._apply_corrections(anchors, corrected, twc)
        lat["pgo_apply_ms"] = 1e3 * (time.perf_counter() - t_apply)
        lat["pgo_ms"] = 1e3 * (time.perf_counter() - t_pgo)
        lat["total_ms"] = 1e3 * (time.perf_counter() - t_start)

    # ------------------------------------------------------------------
    def _analyse_pgo(self, anchors, corrected, edges_ij, edges_T,
                     edges_is_loop):
        """Verbose runs: per-edge rotation / translation errors against the
        ground truth and the anchor ATE before / after the correction, in
        pgo/<n>/pgo_analysis.json."""
        import json

        out_dir = os.path.join(self.output_path, "pgo", str(self._pgo_count))
        os.makedirs(out_dir, exist_ok=True)
        gt = None
        if self.dataset is not None and getattr(self.dataset, "poses",
                                                None) is not None:
            gt = [np.asarray(self.dataset.poses[int(info.submap.kf_id)],
                             np.float64) for info in self.infos]

        def rot_deg(R):
            c = (np.trace(R) - 1.0) / 2.0
            return float(np.degrees(np.arccos(min(max(c, -1.0), 1.0))))

        edges = []
        for (i, j), Z, is_loop in zip(edges_ij, edges_T, edges_is_loop):
            e = {"i": int(i), "j": int(j),
                 "type": "loop" if is_loop else "odometry"}
            if gt is not None:
                E = np.linalg.inv(np.asarray(Z, np.float64)) \
                    @ np.linalg.inv(gt[i]) @ gt[j]
                e["rot_err_deg"] = rot_deg(E[:3, :3])
                e["trans_err_cm"] = float(100.0 * np.linalg.norm(E[:3, 3]))
            edges.append(e)
        report = {"edges": edges}
        if gt is not None:
            gt_t = np.stack([g[:3, 3] for g in gt])

            def ate(poses):
                est = np.stack([p[:3, 3] for p in poses])
                return float(np.sqrt(np.mean(np.sum((est - gt_t) ** 2, 1))))

            report["anchor_ate_before_m"] = ate(list(anchors))
            report["anchor_ate_after_m"] = ate(list(corrected))
        with open(os.path.join(out_dir, "pgo_analysis.json"), "w") as f:
            json.dump(report, f, indent=2)

    def _apply_corrections(self, anchors: np.ndarray, corrected: np.ndarray,
                           twc: np.ndarray):
        """Publish one correction transform per submap range (the last
        range open-ended) and rewrite each submap's T_prev_m, in memory and
        on disk."""
        n_frames = twc.shape[0]
        pending = []
        for s, info in enumerate(self.infos):
            corr = corrected[s] @ np.linalg.inv(anchors[s])
            start = info.start_frame
            last = s == len(self.infos) - 1
            end = n_frames if last else min(self.infos[s + 1].start_frame,
                                            n_frames)
            twc[start:end] = corr @ twc[start:end]
            pending.append((start, None if last else end, corr))
            prev = corrected[s - 1] if s > 0 else np.eye(4)
            info.submap.T_prev_m = np.linalg.inv(prev) @ corrected[s]
            info.submap.save(self.output_path)
        with self._lock:
            self._pending.extend(pending)
            self._twc = twc
