"""Both evaluators' heavy stages on one tiny port run's output directory:
the port's `run_reconstruction_eval` / `run_global_map_eval` against the
JAX package's on the same files, at small settings (one keyframe of the
tiny config, mesh_max_dim 64, 2000 GT points, 5000 mesh samples, 40
unseen views at 32 x 32, 4 refine iterations). The JAX evaluator renders
on its sorted backend (Pallas in interpret mode), set on its instance.

Tolerances, and why:
  - the merged map's count and the alive counts: exact (numpy merge of the
    same files; no prune).
  - the mesh: the fused TSDF differs only at voxels that float32 rounding
    decides (tests/test_torch_tsdf.py), so the vertex and face counts
    agree within 2%, accuracy and completion within 1 mm, precision,
    recall and F1 within 0.02, the unseen-view depth L1 within 5%.
  - the global stage: one keyframe, so both refines draw it every
    iteration: PSNR within 0.01 dB, SSIM within 1e-4. The written splats:
    99% of the rows within 1e-4 of the JAX parameters, every row within
    5e-3. Adam's first steps move a parameter by about its learning rate
    times the sign of its gradient, and a gaussian that barely touches a
    pixel has a gradient at the float32 rounding of the sums, whose steps
    can differ by a fraction of the rate (0.05 for the opacity; measured
    1.5e-3 on 16 of 2227 rows). tests/test_torch_merged_map.py holds the
    refine itself tighter on a map without such rows.
"""
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.evaluation.evaluator import Evaluator as JEvaluator
from eags_slam_torch.config import load_config
from eags_slam_torch.evaluation.evaluator import Evaluator
from eags_slam_torch.slam.gaussian_slam import GaussianSLAM
from eags_slam_torch.utils.ply import load_gaussian_ply

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"eval_mesh": True, "eval_global": True, "mesh_max_dim": 64,
         "gt_samples_per_frame": 2000, "mesh_samples": 5000,
         "unseen_views": 40, "unseen_res": 32, "global_refine_iters": 4}


class _JaxView:
    """The port's dataset as the JAX evaluator reads it (its Camera type;
    frames as numpy through __getitem__)."""

    def __init__(self, ds):
        self._ds = ds
        self.camera = JCamera(*ds.camera)
        self.poses = ds.poses

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        return self._ds[i]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("heavy")
    cfg = load_config(str(REPO / "configs/synthetic/tiny.yaml"))
    cfg["device"] = "cpu"
    cfg["frame_limit"] = 1
    cfg["data"]["output_path"] = str(out / "port")
    cfg["mapping"].update({"iterations": 4, "new_submap_iterations": 8})
    cfg["evaluation"].update(SMALL)
    gslam = GaussianSLAM(cfg)
    try:
        gslam.run()
        port_dir = cfg["data"]["output_path"]
        t_ev = Evaluator(port_dir, gslam.dataset, cfg)
        t_rec = t_ev.run_reconstruction_eval()
        t_glob = t_ev.run_global_map_eval()
        t_splats = load_gaussian_ply(os.path.join(port_dir, "mesh",
                                                  "global_splats.ply"))
        # The JAX evaluator on a copy of the same run's files.
        jax_dir = out / "jax"
        jax_dir.mkdir()
        (jax_dir / "submaps").mkdir()
        for name in ("estimated_c2w.npz",):
            (jax_dir / name).write_bytes((pathlib.Path(port_dir) / name)
                                         .read_bytes())
        for f in (pathlib.Path(port_dir) / "submaps").iterdir():
            (jax_dir / "submaps" / f.name).write_bytes(f.read_bytes())
        j_ev = JEvaluator(str(jax_dir), _JaxView(gslam.dataset), cfg)
        j_ev.rcfg = j_ev.rcfg._replace(backend="sorted")
        j_rec = j_ev.run_reconstruction_eval()
        j_glob = j_ev.run_global_map_eval()
        from eags_slam_tpu.utils.ply import load_gaussian_ply as jload
        j_splats = jload(str(jax_dir / "mesh" / "global_splats.ply"))
    finally:
        gslam.cleanup()
    return port_dir, (t_rec, t_glob, t_splats), (j_rec, j_glob, j_splats)


def test_reconstruction_eval_matches_jax(run):
    port_dir, (t, _, _), (j, _, _) = run
    assert t["gt_source"] == j["gt_source"] == "sensor_depth"
    assert t["n_faces"] > 100 and t["n_keyframes"] == 1
    for k in ("n_vertices", "n_faces"):
        assert abs(t[k] - j[k]) <= 0.02 * j[k], (k, t[k], j[k])
    for k in ("accuracy", "completion"):
        assert abs(t[k] - j[k]) <= 1e-3, (k, t[k], j[k])
    for k in ("precision", "recall", "f1"):
        assert abs(t[k] - j[k]) <= 0.02, (k, t[k], j[k])
    assert abs(t["depth_l1_sample_view"] - j["depth_l1_sample_view"]) \
        <= 0.05 * j["depth_l1_sample_view"]
    assert t["grid_dims"] == [64, 64, 64]
    with open(os.path.join(port_dir, "reconstruction_metrics.json")) as f:
        assert json.load(f)["n_faces"] == t["n_faces"]
    assert os.path.getsize(os.path.join(port_dir, "mesh",
                                        "cleaned_mesh.ply")) > 0


def test_global_map_eval_matches_jax(run):
    port_dir, (_, t, ts), (_, j, js) = run
    assert t["num_views"] == j["num_views"] == 1
    assert t["iterations"] == j["iterations"] == 4
    assert t["n_alive"] == t["n_gaussians"] == js["xyz"].shape[0]
    assert abs(t["mean_psnr"] - j["mean_psnr"]) <= 0.01
    assert abs(t["mean_ssim"] - j["mean_ssim"]) <= 1e-4
    assert set(ts) == set(js)
    for k in js:
        assert ts[k].shape == js[k].shape, k
        d = np.abs(ts[k] - js[k]).reshape(len(ts[k]), -1).max(1)
        assert (d <= 1e-4).mean() >= 0.99 and d.max() <= 5e-3, \
            (k, (d > 1e-4).sum(), d.max())
    with open(os.path.join(port_dir, "rendering_metrics_global.json")) as f:
        assert json.load(f)["mean_psnr"] == t["mean_psnr"]
