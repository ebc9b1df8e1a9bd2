"""The whole slice: the JAX GaussianSLAM (sorted backend in Pallas interpret
mode, EAGS_RCFG=backend=sorted) and the port's GaussianSLAM on device="cpu"
run configs/synthetic/tiny.yaml for 4 frames, with a submap boundary at
frame 3 (`new_submap_every` 3) whose new submap is warm-started from the
outgoing one's visible gaussians (`init_warm_start`), on the same frames (the JAX dataset's
quantised frames) with the same random draws (the JAX keys' draws, handed
to the port through `GaussianSLAM(draws=...)`).

Tolerance on the per-frame camera positions: 1 cm. The two runs agree to
~1e-6 per step, but the seeds of this synthetic scene lie on exact pixel
centres, so some project onto tile boundaries exactly; the last-bit
differences between XLA's fused float32 and PyTorch's unfused float32 then
move a few of them to the neighbouring centre tile, which reorders
equal-depth gaussians in the compositing and sends the two optimisations
along slightly different (equally valid) paths. Both runs must also pass
the tests/test_e2e_synthetic.py bounds: max position error < 4 cm,
ATE < 5 cm, PSNR > 20 dB.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.config import load_config as j_load_config
from eags_slam_tpu.evaluation.evaluator import Evaluator as JEvaluator
from eags_slam_tpu.slam.gaussian_slam import GaussianSLAM as JSLAM
from eags_slam_tpu.slam.submap import Submap as JSubmap
from eags_slam_torch.config import load_config
from eags_slam_torch.datasets import ArrayDataset
from eags_slam_torch.evaluation.evaluator import Evaluator
from eags_slam_torch.evaluation.trajectory import evaluate_trajectory
from eags_slam_torch.slam.gaussian_slam import GaussianSLAM

N_FRAMES = 4
MAPPING = {"new_submap_every": 3, "init_warm_start": True,
           "warm_min_visible": 200}


class JaxDraws:
    """The JAX package's random draws for the key the run hands out."""

    def seed_gumbels(self, key, is_new, n_pixels):
        k = jnp.asarray(key)
        ks = jax.random.split(k, 3) if is_new else [k]
        return [np.array(jax.random.gumbel(kk, (n_pixels,))) for kk in ks]

    def kf_sampler(self, key):
        state = {"key": jnp.asarray(key)}

        def draw(p_kf, it0):
            state["key"], k_sel = jax.random.split(state["key"])
            if it0 < 5:
                return 0
            return int(jax.random.categorical(
                k_sel, jnp.log(jnp.asarray(p_kf) + 1e-12)))
        return draw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # Two intra-op threads: the suite runs in several processes at once,
    # and more threads than cores slow all of them down.
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        return _runs(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("slice")
    mp = pytest.MonkeyPatch()
    mp.setenv("EAGS_RCFG", "backend=sorted")
    cfg = j_load_config("configs/synthetic/tiny.yaml")
    cfg["frame_limit"] = N_FRAMES
    cfg["mapping"].update(MAPPING)
    cfg["data"]["output_path"] = str(out / "jax")
    jslam = JSLAM(cfg)
    try:
        jslam.run()
        ds = jslam.dataset
        colors = np.stack([ds._frame_cache[i][0] for i in range(len(ds))])
        depths = np.stack([ds._frame_cache[i][1] for i in range(len(ds))])
        poses = np.stack([ds.poses[i] for i in range(len(ds))])
        j_c2w = jslam.estimated_c2ws.copy()
        j_warm = jslam._warm_inited
        # The JAX evaluator on its own run, rendering through the sorted
        # backend (interpret mode) instead of the CPU's dense default.
        jev = JEvaluator(str(out / "jax"), ds, cfg)
        jev.rcfg = jev.rcfg._replace(backend="sorted")
        j_eval = jev.run_rendering_eval()
    finally:
        jslam.cleanup()
        mp.undo()

    tcfg = load_config("configs/synthetic/tiny.yaml")
    tcfg["device"] = "cpu"
    tcfg["frame_limit"] = N_FRAMES
    tcfg["mapping"].update(MAPPING)
    tcfg["data"]["output_path"] = str(out / "port")
    tds = ArrayDataset(tcfg, colors, depths, poses)
    tslam = GaussianSLAM(tcfg, dataset=tds, draws=JaxDraws())
    try:
        report = tslam.run()
        t_eval = Evaluator(str(out / "port"), tds, tcfg).run_rendering_eval()
        t_eval_of_j = Evaluator(str(out / "jax"), tds,
                                tcfg).run_rendering_eval()
    finally:
        tslam.cleanup()
    return dict(out=out, poses=poses, j_c2w=j_c2w, t_c2w=tslam.estimated_c2ws,
                report=report, t_eval=t_eval, j_eval=j_eval,
                t_eval_of_j=t_eval_of_j,
                warm=(j_warm, tslam._warm_inited))


def test_slice_positions_match_jax(runs):
    d = np.linalg.norm(runs["t_c2w"][:, :3, 3] - runs["j_c2w"][:, :3, 3],
                       axis=-1)
    assert d.max() < 0.01, d
    assert runs["report"]["frames"] == N_FRAMES
    assert runs["warm"] == (True, True)   # both warm-started submap 1
    assert runs["report"]["tracker"]["init_pose_cnt"]["const_speed"] \
        + runs["report"]["tracker"]["init_pose_cnt"]["previous"] \
        == N_FRAMES - 2


@pytest.mark.parametrize("side", ["jax", "port"])
def test_slice_within_e2e_bounds(runs, side):
    c2w = runs["j_c2w"] if side == "jax" else runs["t_c2w"]
    gt = runs["poses"]
    err = np.linalg.norm(c2w[:, :3, 3] - gt[:, :3, 3], axis=-1)
    assert err.max() < 0.04, err
    traj = evaluate_trajectory(c2w, gt)
    assert traj["ate"]["rmse"] < 0.05
    rend = runs["j_eval"] if side == "jax" else runs["t_eval"]
    assert rend["num_views"] > 0 and rend["mean_psnr"] > 20.0, rend


def test_evaluator_matches_jax(runs):
    """The port's evaluator and the JAX one on the same run directory (the
    JAX run's submaps and poses). Tolerance: PSNR 0.02 dB, SSIM 1e-3,
    depth-L1 1e-4 m (renders agree to ~1e-4, see test_torch_modules)."""
    j, t = runs["j_eval"], runs["t_eval_of_j"]
    assert t["num_views"] == j["num_views"] > 0
    assert abs(t["mean_psnr"] - j["mean_psnr"]) < 0.02, (t, j)
    assert abs(t["mean_ssim"] - j["mean_ssim"]) < 1e-3, (t, j)
    assert abs(t["mean_depth_l1"] - j["mean_depth_l1"]) < 1e-4, (t, j)
    assert t["mean_ms_ssim"] is None and j["mean_ms_ssim"] is None
    for name in ("rendering_metrics.json",):
        assert (runs["out"] / "port" / name).exists()


def test_slice_artifacts_read_by_jax(runs):
    """The port writes the JAX run's artifacts, and the JAX Submap reads
    the port's submap files (same npz keys)."""
    port = runs["out"] / "port"
    for name in ("estimated_c2w.npz", "config.yaml", "log.jsonl"):
        assert (port / name).exists(), name
    files = sorted(os.listdir(port / "submaps"))
    assert len(files) == 2 and files == sorted(os.listdir(
        runs["out"] / "jax" / "submaps"))
    for f in files:
        sm_t = JSubmap.load(str(port / "submaps" / f))
        sm_j = JSubmap.load(str(runs["out"] / "jax" / "submaps" / f))
        assert sm_t.kf_frame_ids == sm_j.kf_frame_ids
        assert set(sm_t.gaussians) == set(sm_j.gaussians)
        assert sm_t.descs.shape == sm_j.descs.shape
        np.testing.assert_allclose(sm_t.T_prev_m, sm_j.T_prev_m, atol=0.02)
        n_t, n_j = sm_t.gaussians["xyz"].shape[0], sm_j.gaussians["xyz"].shape[0]
        assert abs(n_t - n_j) <= 0.05 * n_j
