"""The ScanNet++ novel-view evaluation (`Evaluator.run_nvs_eval`) of the
port against the JAX package's, on one small saved run: the port's
GaussianSLAM on configs/synthetic/tiny.yaml for 5 frames with a submap
boundary every 2 frames (three submaps, so the nearest-submap choice
matters), frames 1 and 3 held out as `test_ids`. Both evaluators read the
same run directory and the same frames (the JAX evaluator through a thin
dataset over the port's frames, rendering on the sorted backend in Pallas
interpret mode).

Tolerance: nvs_psnr within 0.02 dB and the same number of views (the
renders agree to ~1e-4, as in tests/test_torch_slice.py's evaluator
check).
"""
import json

import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.evaluation.evaluator import Evaluator as JEvaluator
from eags_slam_torch.config import load_config
from eags_slam_torch.evaluation.evaluator import Evaluator
from eags_slam_torch.slam.gaussian_slam import GaussianSLAM

N_FRAMES = 5
TEST_IDS = {1, 3}


class _JaxView:
    """The port dataset's frames as the JAX evaluator reads them."""

    def __init__(self, tds):
        self._tds = tds
        self.camera = JCamera(*tds.camera)
        self.poses = tds.poses
        self.test_ids = tds.test_ids

    def __len__(self):
        return len(self._tds)

    def __getitem__(self, idx):
        return self._tds[idx]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("nvs") / "run"
    cfg = load_config("configs/synthetic/tiny.yaml")
    cfg["device"] = "cpu"
    cfg["frame_limit"] = N_FRAMES
    cfg["data"]["output_path"] = str(out)
    cfg["mapping"].update({"new_submap_every": 2, "iterations": 6,
                           "new_submap_iterations": 12})
    cfg["tracking"]["iterations"] = 6
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    gslam = GaussianSLAM(cfg)
    try:
        gslam.run()
        tds = gslam.dataset
        tds.test_ids = set(TEST_IDS)
        t_res = Evaluator(str(out), tds, cfg).run()
        with open(out / "nvs_eval" / "results.json") as f:
            t_json = json.load(f)
        jev = JEvaluator(str(out), _JaxView(tds), cfg)
        jev.rcfg = jev.rcfg._replace(backend="sorted")
        j_nvs = jev.run_nvs_eval()
        tds.test_ids = set()
        t_plain = Evaluator(str(out), tds, cfg).run()
    finally:
        gslam.cleanup()
        torch.set_num_threads(threads)
    return dict(out=out, t=t_res, t_json=t_json, j_nvs=j_nvs,
                t_plain=t_plain,
                submaps=gslam.submap_id + 1)


def test_nvs_matches_jax(run):
    t, j = run["t"]["nvs"], run["j_nvs"]
    assert run["submaps"] == 3
    assert t["num_views"] == j["num_views"] == len(TEST_IDS)
    assert abs(t["nvs_psnr"] - j["nvs_psnr"]) < 0.02, (t, j)
    assert np.isfinite(t["nvs_psnr"]) and t["nvs_psnr"] > 10.0
    assert run["t_json"] == t


def test_nvs_only_with_test_ids(run):
    """run() adds the novel-view stage only for a dataset that holds out
    views."""
    assert "nvs" in run["t"] and "nvs" not in run["t_plain"]
    with open(run["out"] / "evaluation.json") as f:
        assert "nvs" not in json.load(f)      # the second run() wrote it
