"""Re-run the evaluation of a finished run from its saved outputs (the
port's counterpart of the root `run_evaluation.py`):

    python -m eags_slam_torch.run_evaluation --checkpoint_path DIR [--device cpu]

Loads `DIR/config.yaml`, rebuilds the run's dataset and runs the port's
`Evaluator.run()` on `DIR`, the heavy stages included where the config
turns them on (`evaluation.eval_mesh`, `eval_global`). `--device` defaults
to the config's `device` ("cuda"); there is no silent fallback to the CPU.
"""
import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint_path", type=str, required=True)
    p.add_argument("--device", type=str, default=None)
    args = p.parse_args(argv)

    import torch

    from .config import load_config
    from .datasets import get_dataset
    from .evaluation.evaluator import Evaluator

    config = load_config(os.path.join(args.checkpoint_path, "config.yaml"))
    if args.device is not None:
        config["device"] = args.device
    device = torch.device(config.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("config device is 'cuda' but no CUDA device is "
                           "available (pass --device cpu to evaluate on the "
                           "CPU)")
    dataset = get_dataset(config["data"]["dataset_name"])(config,
                                                          device=device)
    try:
        print(Evaluator(args.checkpoint_path, dataset, config).run())
    finally:
        dataset.close()


if __name__ == "__main__":
    main()
