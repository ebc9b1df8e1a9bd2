"""SLAM entry point of the port:

    python -m eags_slam_torch.run_slam configs/<dataset>/<scene>.yaml [...]

Same YAML configs and flags as the JAX package's `run_slam.py`, plus
`--device` (default: the config's `device`, "cuda"). Prints the same
`FPS:`, `Track avg:` and `ATE-RMSE:` lines and writes `estimated_c2w.npz`,
`submaps/*.npz`, `config.yaml`, `log.jsonl` and the evaluation's
`ate.json`, `rendering_metrics.json` and `evaluation.json` into the output
path. The mesh / global-map evaluation is not ported yet.
"""
import argparse
import random

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser(description="EAGS-SLAM (PyTorch port)")
    p.add_argument("config_path", type=str, help="scene yaml")
    p.add_argument("--input_path", type=str, default=None)
    p.add_argument("--output_path", type=str, default=None)
    p.add_argument("--frame_limit", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--map_every", type=int, default=None)
    p.add_argument("--new_submap_every", type=int, default=None)
    p.add_argument("--mapping_iterations", type=int, default=None)
    p.add_argument("--tracking_iterations", type=int, default=None)
    p.add_argument("--odometry_type", type=str, default=None,
                   choices=["gt", "const_speed", "odometer"])
    p.add_argument("--gt_camera", action="store_true", default=None)
    p.add_argument("--help_camera_initialization", action="store_true",
                   default=None)
    p.add_argument("--soft_alpha", type=lambda s: s == "True", default=None)
    p.add_argument("--submap_using_motion_heuristic",
                   type=lambda s: s == "True", default=None)
    p.add_argument("--lc_parallel", type=lambda s: s == "True", default=None)
    p.add_argument("--lc_registration", type=str, default=None)
    p.add_argument("--lc_min_interval", type=int, default=None)
    p.add_argument("--lc_final", type=lambda s: s == "True", default=None)
    p.add_argument("--group_name", type=str, default=None)
    p.add_argument("--device", type=str, default=None)
    p.add_argument("--no_eval", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from .config import load_config, update_config_with_args

    config = load_config(args.config_path)
    config = update_config_with_args(config, args)
    if args.device is not None:
        config["device"] = args.device
    if not args.no_eval:
        from .evaluation.evaluator import check_config

        check_config(config)
    seed = int(config.get("seed", 0))
    random.seed(seed)
    np.random.seed(seed)
    import torch

    torch.manual_seed(seed)
    from .slam.gaussian_slam import GaussianSLAM

    gslam = GaussianSLAM(config)
    try:
        report = gslam.run()
        print(f"FPS: {report['fps']:.3f}  ({report['total_s']:.1f}s for "
              f"{report['frames']} frames)")
        print(f"Track avg: {report['track_ms_avg']:.1f} ms, "
              f"Map avg: {report['map_ms_avg']:.1f} ms")
        if not args.no_eval:
            from .evaluation.evaluator import Evaluator

            results = Evaluator(config["data"]["output_path"], gslam.dataset,
                                config).run()
            ate = results["trajectory"]["ate"]["rmse"] * 100
            print(f"ATE-RMSE: {ate:.3f} cm, "
                  f"PSNR: {results['rendering']['mean_psnr']:.2f} dB, "
                  f"SSIM: {results['rendering']['mean_ssim']:.4f}")
    finally:
        gslam.cleanup()


if __name__ == "__main__":
    main()
