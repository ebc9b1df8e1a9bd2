"""Evaluation options of the port run on a tiny GaussianSLAM run's files:
`save_render`, and the heavy stages `eval_mesh` / `eval_global` through
`python -m eags_slam_torch.run_evaluation`."""
import json
import os

import numpy as np
import pytest

from eags_slam_torch.slam.gaussian_slam import GaussianSLAM
from test_torch_guards import _CHEAP, _tiny


# The heavy stages at small settings (the tiny config's grid, GT cloud,
# samples, views and refine).
_SMALL_HEAVY = {"mesh_max_dim": 48, "gt_samples_per_frame": 1000,
                "mesh_samples": 2000, "unseen_views": 10, "unseen_res": 32,
                "global_refine_iters": 2}


@pytest.mark.parametrize("key", ["save_render", "eval_mesh", "eval_global"])
def test_ported_evaluation_runs(tmp_path, key, capsys):
    """Evaluation options that are ported run. `save_render`: the
    evaluator writes each keyframe's clipped render as
    eval_render/<frame>.png. `eval_mesh` / `eval_global` (the heavy
    stages, which raised before they were ported): `python -m
    eags_slam_torch.run_evaluation --checkpoint_path DIR --device cpu` on
    the run's saved files writes the stage's metrics and mesh files and
    prints the results."""
    from eags_slam_torch import run_evaluation
    from eags_slam_torch.evaluation.evaluator import Evaluator

    cfg = _tiny(tmp_path, frames=2, **_CHEAP)
    cfg["evaluation"] = {key: True, **_SMALL_HEAVY}
    gslam = GaussianSLAM(cfg)
    try:
        gslam.run()
        if key == "save_render":
            rend = Evaluator(str(tmp_path / "out"), gslam.dataset,
                             cfg).run_rendering_eval()
    finally:
        gslam.cleanup()
    out = tmp_path / "out"
    if key == "save_render":
        pngs = sorted(os.listdir(out / "eval_render"))
        assert len(pngs) == rend["num_views"] > 0
        with open(out / "eval_render" / pngs[0], "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        return
    run_evaluation.main(["--checkpoint_path", str(out), "--device", "cpu"])
    printed = capsys.readouterr().out
    with open(out / "evaluation.json") as f:
        results = json.load(f)
    stage, files = {
        "eval_mesh": ("reconstruction", ("reconstruction_metrics.json",
                                         "mesh/cleaned_mesh.ply")),
        "eval_global": ("global", ("rendering_metrics_global.json",
                                   "mesh/global_splats.ply"))}[key]
    assert set(results) == {"trajectory", "rendering", stage}
    assert repr(results[stage]["stage_s"]) in printed
    for name in files:
        assert (out / name).stat().st_size > 0, name
    if key == "eval_mesh":
        assert results[stage]["n_faces"] > 0
        assert 0.0 <= results[stage]["f1"] <= 1.0
    else:
        assert results[stage]["n_alive"] == results[stage]["n_gaussians"]
        assert np.isfinite(results[stage]["mean_psnr"])
