"""Evaluation of a finished run (port of
`eags_slam_tpu.evaluation.evaluator`, its trajectory and rendering parts).

Loads `estimated_c2w.npz` and `submaps/*.npz`, restores each submap into the
world frame along the `T_prev_m` chain, renders its keyframes at their
estimated poses, exposure-compensated, and reports PSNR / SSIM / MS-SSIM /
depth-L1 into `rendering_metrics.json`, beside the trajectory's `ate.json`.
The mesh and global-map stages (`evaluation.eval_mesh`, `eval_global`) and
`evaluation.save_render` are not ported and raise; LPIPS needs pretrained
weights the repo does not ship, as in the JAX package.
"""
from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict

import numpy as np
import torch

from ..core.sh import sh_to_rgb
from ..ops.losses import ms_ssim, psnr, ssim
from ..ops.rasterizer import RasterConfig, render
from ..slam.submap import Submap
from .trajectory import evaluate_trajectory


def check_config(config: Dict) -> None:
    """Raise for the evaluation stages that are not ported yet."""
    ev = config.get("evaluation", {})
    for key in ("eval_mesh", "eval_global"):
        if ev.get(key, False):
            raise NotImplementedError(
                f"evaluation.{key}: the mesh / global-map evaluation is not "
                "ported (ROADMAP Queue 1 item 11); run with --no_eval or "
                "turn it off")
    if ev.get("save_render", False):
        raise NotImplementedError(
            "evaluation.save_render: writing the evaluation renders is not "
            "ported (ROADMAP Queue 1 item 8)")


class Evaluator:
    def __init__(self, output_path: str, dataset, config: Dict):
        check_config(config)
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

    @torch.no_grad()
    def run_rendering_eval(self) -> Dict:
        dev = self.dataset.device
        psnrs, ssims, ms_ssims, depth_l1s = [], [], [], []
        Twm_chain = np.eye(4)
        paths = sorted(glob(os.path.join(self.output_path, "submaps",
                                         "*.npz")))
        for path in paths:
            sm = Submap.load(path)
            Twm_chain = Twm_chain @ sm.T_prev_m
            g = {k: torch.as_tensor(v, device=dev)
                 for k, v in sm.restore_world(Twm_chain).items()}
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
                mask = gt_depth > 0
                dl1 = torch.abs(out.depth - gt_depth)[mask]
                depth_l1s.append(float(dl1.mean()) if dl1.numel() else 0.0)
        res = {
            "mean_psnr": float(np.mean(psnrs)) if psnrs else 0.0,
            "mean_ssim": float(np.mean(ssims)) if ssims else 0.0,
            "mean_ms_ssim": float(np.mean(ms_ssims)) if ms_ssims else None,
            "mean_depth_l1": float(np.mean(depth_l1s)) if depth_l1s else 0.0,
            "mean_lpips": None,
            "num_views": len(psnrs),
        }
        with open(os.path.join(self.output_path, "rendering_metrics.json"),
                  "w") as f:
            json.dump(res, f, indent=2)
        return res

    def run(self) -> Dict:
        results = {"trajectory": self.run_trajectory_eval(),
                   "rendering": self.run_rendering_eval()}
        with open(os.path.join(self.output_path, "evaluation.json"),
                  "w") as f:
            json.dump(results, f, indent=2)
        return results
