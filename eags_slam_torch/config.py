"""Config system: YAML with `inherit_from` chaining + CLI overrides.

Same schema and semantics as `eags_slam_tpu.config` (the same YAML files
drive both packages). The one port-specific key is `device` (a torch device
string, default "cuda"); the CPU tests pass "cpu".
"""
from __future__ import annotations

import copy
import os
from typing import Any, Dict

import yaml

# Defaults mirror configs/Replica/replica.yaml of the reference, with `vo`
# absorbing configs/VO/vo_settings.yaml + per-scene VO yaml keys.
DEFAULTS: Dict[str, Any] = {
    "project_name": "eags_slam_torch",
    "checkpoint_path": None,
    "use_wandb": False,
    "frame_limit": -1,
    "seed": 0,
    "device": "cuda",
    "tracking": {
        "gt_camera": False,
        "w_color_loss": 0.95,
        "iterations": 60,
        "cam_rot_lr": 0.002,
        "cam_trans_lr": 0.01,
        "odometry_type": "odometer",  # gt | const_speed | odometer
        "help_camera_initialization": False,
        "init_err_ratio": 5.0,
        "odometer_method": "edge_vo",
        "filter_alpha": True,
        "filter_outlier_depth": True,
        "alpha_thre": 0.98,
        "soft_alpha": True,
        "mask_invalid_depth": False,
        # Reference Replica protocol (configs/Replica/replica.yaml:32-33):
        # stop refinement after `cnt` consecutive iterations whose absolute
        # loss delta is below `thre`.
        "early_stop_thre": 5.0e-5,
        "early_stop_cnt": 5,
        # ReduceLROnPlateau (reference configs/Replica/replica.yaml:34-35).
        "scheduler_factor": 0.95,
        "scheduler_patience": 5,
    },
    "mapping": {
        "new_submap_every": 50,
        "map_every": 2,
        "iterations": 100,
        "new_submap_iterations": 100,
        "new_submap_points_num": 100000,
        "new_submap_gradient_points_num": 50000,
        "new_frame_sample_size": 30000,
        "new_points_radius": 0.0000001,
        "current_view_opt_iterations": 0.4,
        "alpha_thre": 0.6,
        "pruning_thre": 0.1,
        "submap_using_motion_heuristic": True,
        "new_submap_rot_thre": 50.0,
        "new_submap_trans_thre": 0.5,
        "edge_dilate_kernel": 2,
        "max_gaussians": 1 << 18,  # submap capacity budget
        "outlier_removal": False,
    },
    "vo": {
        "enabled": True,
        "pyramid_levels": 3,
        "min_level": 0,
        "canny_low": 100.0,
        "canny_high": 200.0,
        "depth_min": 0.1,
        "depth_max": 10.0,
        "depth_scale": 1.0,
        "edge_fill_percentage": 0.3,
        "max_edge_points": 8192,
        "huber_edge": 0.3,
        "edge_distance_filter": [30.0, 20.0, 10.0, 5.0, 5.0, 5.0],
        "lm_max_iters": 100,
        "lm_eps": 0.999,
        "kf_overlap_frames": 3,
        "kf_overlap_weights": [0.0, 1.0, 1.25, 1.5],
        "good_bad_ratio": 4.0,
        "dt_window": 32,
    },
    "cam": {
        "H": 480,
        "W": 640,
        "fx": 600.0,
        "fy": 600.0,
        "cx": 319.5,
        "cy": 239.5,
        "depth_scale": 6553.5,
        "crop_edge": 0,
    },
    "lc": {
        "enabled": True,
        "device": 0,
        "parallel": True,
        "min_interval": 3,
        "min_similarity": 0.7,
        "self_sim_topk": 3,
        "overlap_thre": 0.2,
        "registration": "gs_reg",  # gs_reg | icp | robust_icp | gt | identity
        "pgo_edge_prune_thres": 0.25,
        # reference uses 100 (solver.py:16-98); our Adam-based localizer needs
        # ~2x the steps for the same convergence (validated in
        # tests/test_gs_registration.py)
        "pose_opt_iters": 200,
        "top_views": 2,
        # gs_reg localization pyramid level: 1 = half-res (~4x cheaper per
        # iteration; the correction solves dm-scale drift). 0 = reference
        # full-res protocol.
        "localize_level": 1,
        # >1: split pose_opt_iters into this many frozen-sorted segments
        # with a binning re-freeze between them (~5x cheaper per iteration
        # than rebin-per-step; 1 restores the rebin-per-step path).
        "localize_restarts": 4,
        # Fixed-size submap subsample rendered during registration (one
        # compiled program for the whole run; see LoopClosure.reg_capacity).
        "reg_capacity": 65536,
        "final": True,
        "voxel_size": 0.05,
    },
    "data": {
        "dataset_name": "synthetic",
        "input_path": "",
        "output_path": "output/default",
        "scene_name": "",
        "frame_rate": 32,
        "prefetch": 8,
    },
    "evaluation": {
        "save_render": False,
        "eval_mesh": False,
        "eval_global": False,
        "global_refine_iters": 30000,
    },
}


def recursive_update(base: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """In-place recursive dict merge (reference io_utils.py:100-112)."""
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            recursive_update(base[k], v)
        else:
            base[k] = v
    return base


def load_config(path: str, defaults: bool = True) -> Dict[str, Any]:
    """Load a YAML config resolving the `inherit_from` chain.

    Child values override parent values at leaf granularity
    (reference io_utils.py:75-126). `inherit_from` paths are resolved relative
    to the repo root first, then to the including file's directory.
    """
    with open(path, "r") as f:
        cfg = yaml.safe_load(f) or {}
    parent_path = cfg.pop("inherit_from", None)
    if parent_path is not None:
        if not os.path.exists(parent_path):
            parent_path = os.path.join(os.path.dirname(path), parent_path)
        base = load_config(parent_path, defaults=defaults)
    else:
        base = copy.deepcopy(DEFAULTS) if defaults else {}
    return recursive_update(base, cfg)


# CLI override flags mirroring run_slam.py:16-43 → config key paths.
CLI_OVERRIDES = {
    "input_path": ("data", "input_path"),
    "output_path": ("data", "output_path"),
    "frame_limit": ("frame_limit",),
    "seed": ("seed",),
    "map_every": ("mapping", "map_every"),
    "new_submap_every": ("mapping", "new_submap_every"),
    "mapping_iterations": ("mapping", "iterations"),
    "tracking_iterations": ("tracking", "iterations"),
    "odometry_type": ("tracking", "odometry_type"),
    "help_camera_initialization": ("tracking", "help_camera_initialization"),
    "soft_alpha": ("tracking", "soft_alpha"),
    "submap_using_motion_heuristic": ("mapping", "submap_using_motion_heuristic"),
    "lc_parallel": ("lc", "parallel"),
    "lc_registration": ("lc", "registration"),
    "lc_min_interval": ("lc", "min_interval"),
    "lc_final": ("lc", "final"),
    "gt_camera": ("tracking", "gt_camera"),
    "group_name": ("project_name",),
}


def update_config_with_args(config: Dict[str, Any], args) -> Dict[str, Any]:
    """Apply argparse overrides (reference run_slam.py:46-87)."""
    for flag, path in CLI_OVERRIDES.items():
        val = getattr(args, flag, None)
        if val is None:
            continue
        node = config
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return config


def save_config(config: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
