"""A 4-frame SLAM run on the dense `jnp` backend in both packages.

configs/synthetic/tiny.yaml for 4 frames with EAGS_RCFG=backend=jnp on both
sides, the port on the JAX run's frames with the JAX keys' draws (as
tests/test_torch_slice.py): camera positions within 1 cm, and both
evaluators on the JAX run's directory (each rendering through its `jnp`
backend) within 0.02 dB of PSNR, the bounds of test_torch_slice.py. No
kernel and no twin of one runs on the port's side.
"""
import numpy as np
import pytest
import torch
from test_torch_slice import JaxDraws

from eags_slam_tpu.config import load_config as j_load_config
from eags_slam_tpu.evaluation.evaluator import Evaluator as JEvaluator
from eags_slam_tpu.slam.gaussian_slam import GaussianSLAM as JSLAM
from eags_slam_torch.config import load_config
from eags_slam_torch.datasets import ArrayDataset
from eags_slam_torch.evaluation.evaluator import Evaluator
from eags_slam_torch.ops import composite_entries as ce
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.slam.gaussian_slam import GaussianSLAM

N_FRAMES = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dense")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    mp = pytest.MonkeyPatch()
    mp.setenv("EAGS_RCFG", "backend=jnp")
    try:
        cfg = j_load_config("configs/synthetic/tiny.yaml")
        cfg["frame_limit"] = N_FRAMES
        cfg["data"]["output_path"] = str(out / "jax")
        jslam = JSLAM(cfg)
        try:
            jslam.run()
            ds = jslam.dataset
            colors = np.stack([ds._frame_cache[i][0] for i in range(len(ds))])
            depths = np.stack([ds._frame_cache[i][1] for i in range(len(ds))])
            poses = np.stack([ds.poses[i] for i in range(len(ds))])
            j_c2w = jslam.estimated_c2ws.copy()
            jev = JEvaluator(str(out / "jax"), ds, cfg)
            jev.rcfg = jev.rcfg._replace(backend="jnp")
            j_eval = jev.run_rendering_eval()
        finally:
            jslam.cleanup()

        tcfg = load_config("configs/synthetic/tiny.yaml")
        tcfg["device"] = "cpu"
        tcfg["frame_limit"] = N_FRAMES
        tcfg["data"]["output_path"] = str(out / "port")
        tds = ArrayDataset(tcfg, colors, depths, poses)
        cs.reset_counts()
        ce.reset_counts()
        tslam = GaussianSLAM(tcfg, dataset=tds, draws=JaxDraws())
        try:
            report = tslam.run()
            launches = {**cs.counts(), **ce.counts()}
            ev = Evaluator(str(out / "jax"), tds, tcfg)
            ev.rcfg = ev.rcfg._replace(
                backend="jnp", tile_capacity=jev.rcfg.tile_capacity,
                chunk=jev.rcfg.chunk)
            t_eval_of_j = ev.run_rendering_eval()
        finally:
            tslam.cleanup()
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return dict(poses=poses, j_c2w=j_c2w, t_c2w=tslam.estimated_c2ws,
                rcfg=tslam.rcfg, report=report, launches=launches,
                j_eval=j_eval, t_eval_of_j=t_eval_of_j)


def test_dense_slice_positions_match_jax(runs):
    assert runs["rcfg"].backend == "jnp"
    # tiny.yaml's mapping.tile_capacity reaches the port's config.
    assert runs["rcfg"].tile_capacity == 256 and runs["rcfg"].chunk == 64
    assert runs["report"]["frames"] == N_FRAMES
    assert not any(runs["launches"].values()), runs["launches"]
    d = np.linalg.norm(runs["t_c2w"][:, :3, 3] - runs["j_c2w"][:, :3, 3],
                       axis=-1)
    assert d.max() < 0.01, d
    err = np.linalg.norm(runs["t_c2w"][:, :3, 3] - runs["poses"][:, :3, 3],
                         axis=-1)
    assert err.max() < 0.04, err


def test_dense_evaluators_match(runs):
    j, t = runs["j_eval"], runs["t_eval_of_j"]
    assert t["num_views"] == j["num_views"] > 0
    assert abs(t["mean_psnr"] - j["mean_psnr"]) < 0.02, (t, j)
    assert j["mean_psnr"] > 20.0
