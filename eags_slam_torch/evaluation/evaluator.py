"""Evaluation of a finished run (port of
`eags_slam_tpu.evaluation.evaluator`).

Loads `estimated_c2w.npz` and `submaps/*.npz` and restores each submap into
the world frame along the `T_prev_m` chain. Stages:
  - trajectory: ATE / RPE into `ate.json`;
  - rendering: each submap's keyframes rendered at their estimated poses,
    exposure-compensated: PSNR / SSIM / MS-SSIM / depth-L1, and LPIPS(alex)
    when `weights/lpips_alex.npz` exists (`evaluation/lpips.py`), into
    `rendering_metrics.json`; with `evaluation.save_render` also each
    keyframe's clipped render as `eval_render/<frame>.png`;
  - reconstruction (`evaluation.eval_mesh`): the keyframe renders fused into
    a TSDF grid (voxel 5/512, truncation 4 voxels), the surface-nets mesh
    cleaned and written to `mesh/cleaned_mesh.ply`, accuracy / completion /
    F-score at 1 cm against the GT surface (`evaluation.gt_mesh` when
    present, else 20k sensor-depth points a keyframe) and the unseen-view
    depth-L1, into `reconstruction_metrics.json`;
  - global (`evaluation.eval_global`): the submaps merged, refined with full
    SH (`global_refine_iters`) and rendered at every keyframe into
    `rendering_metrics_global.json`; the refined map's alive rows into
    `mesh/global_splats.ply`;
  - novel views (a dataset with `test_ids`, ScanNet++): each held-out view
    rendered from the submap whose keyframes lie nearest to it, PSNR into
    `nvs_eval/results.json`.
Both heavy stages also report their stage times (`stage_s`, host clock
around work that ends in a device sync). Every stage runs on the dataset's
device. LPIPS needs pretrained weights the repo does not ship, as in the
JAX package: without them `mean_lpips` is null.
"""
from __future__ import annotations

import json
import os
import time
from glob import glob
from typing import Dict

import numpy as np
import torch

from ..core.camera import backproject
from ..core.sh import sh_colors, sh_to_rgb
from ..ops.losses import ms_ssim, psnr, ssim
from ..ops.rasterizer import RasterConfig, render
from ..ops.tsdf import grid_bounds_from_depths, integrate, make_grid
from ..slam.submap import Submap
from ..utils.image_io import write_png
from ..utils.ply import save_gaussian_ply
from .lpips import lpips
from .merged_map import merge_submaps, refine_global_map
from .mesh import (clean_mesh, load_ply, mesh_metrics, sample_surface,
                   save_ply, surface_nets, unseen_depth_l1)
from .trajectory import evaluate_trajectory


class Evaluator:
    def __init__(self, output_path: str, dataset, config: Dict):
        self.output_path = output_path
        self.dataset = dataset
        self.config = config
        self.cam = dataset.camera
        # The JAX evaluator's raster settings (tile 16 whatever the device).
        self.rcfg = RasterConfig(tile=16, dup_side=4)
        z = np.load(os.path.join(output_path, "estimated_c2w.npz"))
        self.estimated_c2ws = z["c2ws"]
        self.exposures = z["exposures"] if "exposures" in z.files else None

    def run_trajectory_eval(self) -> Dict:
        n = len(self.dataset)
        gt = np.stack([self.dataset.poses[i] for i in range(n)])
        return evaluate_trajectory(self.estimated_c2ws[:n], gt,
                                   self.output_path)

    def _world_submaps(self):
        """(submap, its anchor's world pose, its gaussians in the world
        frame) for each saved submap, in order."""
        Twm_chain = np.eye(4)
        for path in sorted(glob(os.path.join(self.output_path, "submaps",
                                             "*.npz"))):
            sm = Submap.load(path)
            Twm_chain = Twm_chain @ sm.T_prev_m
            yield sm, Twm_chain, sm.restore_world(Twm_chain)

    def _sync(self) -> None:
        if self.dataset.device.type == "cuda":
            torch.cuda.synchronize(self.dataset.device)

    @torch.no_grad()
    def run_rendering_eval(self) -> Dict:
        dev = self.dataset.device
        psnrs, ssims, ms_ssims, depth_l1s, lpipss = [], [], [], [], []
        save_render = bool(self.config.get("evaluation", {}).get(
            "save_render", False))
        render_dir = os.path.join(self.output_path, "eval_render")
        if save_render:
            os.makedirs(render_dir, exist_ok=True)
        for sm, Twm_chain, world in self._world_submaps():
            g = {k: torch.as_tensor(v, device=dev) for k, v in world.items()}
            colors = sh_to_rgb(g["f_dc"])
            for k, fid in enumerate(sm.kf_frame_ids):
                w2c = torch.as_tensor(np.linalg.inv(Twm_chain @ sm.Tmc[k]),
                                      dtype=torch.float32, device=dev)
                out = render(g["xyz"], g["quats"], g["log_scales"],
                             g["opacity_logits"], colors, w2c, self.cam,
                             self.rcfg)
                img = out.color
                if self.exposures is not None:
                    a, b = self.exposures[int(fid)]
                    img = img * float(np.exp(a)) + float(b)
                img = torch.clamp(img, 0.0, 1.0)
                gt_color, gt_depth = self.dataset.frame(int(fid))
                psnrs.append(float(psnr(img, gt_color)))
                ssims.append(float(ssim(img, gt_color)))
                if min(img.shape[0], img.shape[1]) > 160:
                    ms_ssims.append(float(ms_ssim(img, gt_color)))
                lp = lpips(img, gt_color)
                if lp is not None:
                    lpipss.append(lp)
                mask = gt_depth > 0
                dl1 = torch.abs(out.depth - gt_depth)[mask]
                depth_l1s.append(float(dl1.mean()) if dl1.numel() else 0.0)
                if save_render:
                    write_png(os.path.join(render_dir, f"{int(fid):05d}.png"),
                              (img.cpu().numpy() * 255).astype(np.uint8))
        res = {
            "mean_psnr": float(np.mean(psnrs)) if psnrs else 0.0,
            "mean_ssim": float(np.mean(ssims)) if ssims else 0.0,
            "mean_ms_ssim": float(np.mean(ms_ssims)) if ms_ssims else None,
            "mean_depth_l1": float(np.mean(depth_l1s)) if depth_l1s else 0.0,
            "mean_lpips": float(np.mean(lpipss)) if lpipss else None,
            "num_views": len(psnrs),
        }
        with open(os.path.join(self.output_path, "rendering_metrics.json"),
                  "w") as f:
            json.dump(res, f, indent=2)
        return res

    @torch.no_grad()
    def run_reconstruction_eval(self) -> Dict:
        """TSDF-fuse the rendered keyframes, extract and clean the mesh,
        and score it against the GT surface (reference evaluator.py:188-243
        and evaluate_reconstruction.py). `stage_s`: the seconds of each
        stage, `integrate_ms`: the mean per keyframe."""
        dev = self.dataset.device
        ev = self.config.get("evaluation", {})
        voxel = float(ev.get("mesh_voxel", 5.0 / 512.0))
        trunc = 4 * voxel
        n = len(self.dataset)
        # Tight bounds from a few sensor depth frames at their estimated
        # poses (the trajectory box would make max_dim clip the scene).
        sel = np.unique(np.linspace(0, n - 1, 8).astype(int))
        origin, dims = grid_bounds_from_depths(
            [self.dataset[int(i)][2] for i in sel],
            [self.estimated_c2ws[int(i)] for i in sel],
            self.cam, voxel=voxel, max_dim=int(ev.get("mesh_max_dim", 512)))
        grid = make_grid(origin, dims, voxel, trunc, device=dev)
        n_gt = int(ev.get("gt_samples_per_frame", 20000))

        stage = {"integrate": 0.0}
        gt_pts = []
        n_kf = 0
        for sm, Twm_chain, world in self._world_submaps():
            g = {k: torch.as_tensor(v, device=dev) for k, v in world.items()}
            colors = sh_to_rgb(g["f_dc"])
            for k, fid in enumerate(sm.kf_frame_ids):
                c2w = Twm_chain @ sm.Tmc[k]
                w2c = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32,
                                      device=dev)
                out = render(g["xyz"], g["quats"], g["log_scales"],
                             g["opacity_logits"], colors, w2c, self.cam,
                             self.rcfg)
                depth_n = torch.where(
                    out.alpha > 0.5,
                    out.depth / torch.clamp(out.alpha, min=1e-6),
                    torch.zeros_like(out.depth))
                self._sync()
                t0 = time.perf_counter()
                integrate(grid, torch.clamp(out.color, 0, 1), depth_n, w2c,
                          self.cam)
                self._sync()
                stage["integrate"] += time.perf_counter() - t0
                n_kf += 1
                # GT surface samples from the sensor depth, 20k a keyframe
                # by default: sparser, their spacing bounds precision at
                # tau = 1 cm.
                gt_depth = self.dataset.frame(int(fid))[1]
                pts_cam = backproject(self.cam, gt_depth)[gt_depth > 0] \
                    .cpu().numpy()
                pick = np.random.default_rng(0).choice(
                    len(pts_cam), min(n_gt, len(pts_cam)), replace=False)
                gt_pts.append(pts_cam[pick] @ np.asarray(c2w)[:3, :3].T
                              + np.asarray(c2w)[:3, 3])

        t0 = time.perf_counter()
        verts, faces = surface_nets(grid.sdf, grid.weight, grid.origin,
                                    grid.voxel)
        stage["surface_nets"] = time.perf_counter() - t0
        del grid
        t0 = time.perf_counter()
        verts, faces = clean_mesh(verts, faces)
        stage["clean"] = time.perf_counter() - t0
        mesh_dir = os.path.join(self.output_path, "mesh")
        os.makedirs(mesh_dir, exist_ok=True)
        t0 = time.perf_counter()
        save_ply(os.path.join(mesh_dir, "cleaned_mesh.ply"), verts, faces)
        stage["save_ply"] = time.perf_counter() - t0

        gt_mesh_path = ev.get("gt_mesh")
        if gt_mesh_path and os.path.exists(gt_mesh_path):
            gv, gf = load_ply(gt_mesh_path)
            gt_surface = sample_surface(gv, gf, 200000)
            gt_source = "gt_mesh"
        else:
            gt_surface = np.concatenate(gt_pts) if gt_pts \
                else np.zeros((0, 3))
            gt_source = "sensor_depth"

        res: Dict = {"n_vertices": int(len(verts)), "n_faces": int(len(faces)),
                     "gt_source": gt_source}
        if len(faces) and len(gt_surface):
            t0 = time.perf_counter()
            pred_pts = sample_surface(verts, faces,
                                      int(ev.get("mesh_samples", 200000)))
            stage["sample"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res.update(mesh_metrics(pred_pts, gt_surface, tau=0.01,
                                    device=dev))
            stage["metrics"] = time.perf_counter() - t0
            n_views = int(ev.get("unseen_views", 1000))
            if n_views > 0:
                t0 = time.perf_counter()
                res["depth_l1_sample_view"] = unseen_depth_l1(
                    sample_surface(verts, faces, 200000), gt_surface,
                    n_views=n_views, res=int(ev.get("unseen_res", 128)),
                    device=dev)
                stage["unseen"] = time.perf_counter() - t0
        res["grid_dims"] = list(dims)
        res["n_keyframes"] = n_kf
        res["integrate_ms"] = 1e3 * stage["integrate"] / max(n_kf, 1)
        res["stage_s"] = stage
        with open(os.path.join(self.output_path,
                               "reconstruction_metrics.json"), "w") as f:
            json.dump(res, f, indent=2)
        return res

    def run_global_map_eval(self) -> Dict:
        """Merge the submaps, refine the merged map with full SH and render
        every keyframe with degree-3 colours (reference evaluator.py:245-360).
        Also reports the merged count (`n_gaussians`), the refine's alive
        count (`n_alive`) and stage seconds (`stage_s`)."""
        dev = self.dataset.device
        t0 = time.perf_counter()
        dicts, kf_ids = [], []
        for sm, _, world in self._world_submaps():
            dicts.append(world)
            kf_ids.extend(int(f) for f in sm.kf_frame_ids)
        if not dicts:
            return {}
        merged = merge_submaps(dicts)
        stage = {"merge": time.perf_counter() - t0}
        exposures = self.exposures if self.exposures is not None \
            else np.zeros((len(self.dataset), 2))

        def frame_fn(fid):
            color, depth = self.dataset.frame(fid)
            return color, depth, self.estimated_c2ws[fid], exposures[fid]

        iters = int(self.config.get("evaluation", {}).get(
            "global_refine_iters", 30000))
        frame_ids = sorted(set(kf_ids))
        self._sync()
        t0 = time.perf_counter()
        params, alive = refine_global_map(
            merged, frame_fn, frame_ids, self.cam, self.rcfg,
            iterations=iters, device=dev)
        self._sync()
        stage["refine"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        psnrs, ssims, ms_ssims = [], [], []
        with torch.no_grad():
            for fid in frame_ids:
                gt_color = self.dataset.frame(fid)[0]
                c2w = self.estimated_c2ws[fid]
                rgb = sh_colors(3, params.f_dc, params.f_rest, params.xyz,
                                torch.as_tensor(c2w[:3, 3],
                                                dtype=torch.float32,
                                                device=dev))
                out = render(params.xyz, params.quats, params.log_scales,
                             params.opacity_logits, rgb,
                             torch.as_tensor(np.linalg.inv(c2w),
                                             dtype=torch.float32, device=dev),
                             self.cam, self.rcfg, alive=alive)
                img = torch.clamp(out.color, 0, 1)
                psnrs.append(float(psnr(img, gt_color)))
                ssims.append(float(ssim(img, gt_color)))
                if min(img.shape[0], img.shape[1]) > 160:
                    ms_ssims.append(float(ms_ssim(img, gt_color)))
        stage["render"] = time.perf_counter() - t0
        res = {
            "mean_psnr": float(np.mean(psnrs)) if psnrs else 0.0,
            "mean_ssim": float(np.mean(ssims)) if ssims else 0.0,
            "mean_ms_ssim": float(np.mean(ms_ssims)) if ms_ssims else None,
            "num_views": len(psnrs),
            "iterations": iters,
            "n_gaussians": int(merged["xyz"].shape[0]),
            "n_alive": int(alive.sum()),
            "stage_s": stage,
        }
        with open(os.path.join(self.output_path,
                               "rendering_metrics_global.json"), "w") as f:
            json.dump(res, f, indent=2)
        # The refined global map (reference mesh/global_splats.ply).
        mesh_dir = os.path.join(self.output_path, "mesh")
        os.makedirs(mesh_dir, exist_ok=True)
        save_gaussian_ply(
            os.path.join(mesh_dir, "global_splats.ply"),
            {k: v.detach()[alive].cpu().numpy()
             for k, v in params.as_dict().items()})
        return res

    @torch.no_grad()
    def run_nvs_eval(self) -> Dict:
        """ScanNet++ novel-view PSNR on the held-out test views (reference
        evaluator.py:270-298): each view rendered at its estimated pose from
        the submap whose nearest keyframe index is closest to it, in the
        world frame along the `T_prev_m` chain, at the evaluator's raster
        settings. {} when the dataset holds out no view."""
        test_ids = sorted(getattr(self.dataset, "test_ids", []) or [])
        if not test_ids:
            return {}
        dev = self.dataset.device
        submaps = list(self._world_submaps())
        psnrs = []
        for fid in test_ids:
            if fid >= len(self.dataset):
                continue
            best = min(range(len(submaps)), key=lambda s: min(
                abs(int(k) - fid) for k in submaps[s][0].kf_frame_ids))
            g = {k: torch.as_tensor(v, device=dev)
                 for k, v in submaps[best][2].items()}
            out = render(g["xyz"], g["quats"], g["log_scales"],
                         g["opacity_logits"], sh_to_rgb(g["f_dc"]),
                         torch.as_tensor(np.linalg.inv(
                             self.estimated_c2ws[fid]), dtype=torch.float32,
                             device=dev), self.cam, self.rcfg)
            gt_color = self.dataset.frame(int(fid))[0]
            psnrs.append(float(psnr(torch.clamp(out.color, 0, 1), gt_color)))
        res = {"nvs_psnr": float(np.mean(psnrs)) if psnrs else 0.0,
               "num_views": len(psnrs)}
        nvs_dir = os.path.join(self.output_path, "nvs_eval")
        os.makedirs(nvs_dir, exist_ok=True)
        with open(os.path.join(nvs_dir, "results.json"), "w") as f:
            json.dump(res, f, indent=2)
        return res

    def run(self) -> Dict:
        results = {"trajectory": self.run_trajectory_eval(),
                   "rendering": self.run_rendering_eval()}
        if getattr(self.dataset, "test_ids", None):
            results["nvs"] = self.run_nvs_eval()
        ev = self.config.get("evaluation", {})
        if ev.get("eval_mesh", False):
            results["reconstruction"] = self.run_reconstruction_eval()
        if ev.get("eval_global", False):
            results["global"] = self.run_global_map_eval()
        with open(os.path.join(self.output_path, "evaluation.json"),
                  "w") as f:
            json.dump(results, f, indent=2)
        return results
