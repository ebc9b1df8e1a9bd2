"""The slice with loop closure: the JAX GaussianSLAM (sorted backend in
Pallas interpret mode, its closer's raster config set to the sorted
backend too) and the port's, on device="cpu", run configs/synthetic/tiny.yaml
for 5 frames with a submap boundary every 2 frames (three submaps) and
`lc.enabled` with the worker thread on, on the same frames (the JAX
dataset's) and the same random draws. The camera barely moves (the
dataset's 1/300 orbit), so the third submap revisits the first: both
closers detect it, register it with gs_reg and solve the pose graph.

Tolerance: the same number of closures (at least one) in both, and the
corrected camera positions within 1 cm of each other (the slice's own
tolerance, tests/test_torch_slice.py); the closer's renders count apart
from the main path's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.config import load_config as j_load_config
from eags_slam_tpu.slam.gaussian_slam import GaussianSLAM as JSLAM
from eags_slam_torch.config import load_config
from eags_slam_torch.datasets import ArrayDataset
from eags_slam_torch.lc.loop_closure import LC_TAG
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.slam.gaussian_slam import GaussianSLAM

N_FRAMES = 5
MAPPING = {"new_submap_every": 2, "iterations": 8,
           "new_submap_iterations": 16}
TRACKING = {"iterations": 8}
LC = {"enabled": True, "parallel": True, "min_interval": 2, "final": True,
      "pose_opt_iters": 12, "localize_restarts": 2, "top_views": 1}


class JaxDraws:
    """The JAX package's random draws for the key the run hands out (as in
    tests/test_torch_slice.py)."""

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


def _configure(cfg, out):
    cfg["frame_limit"] = N_FRAMES
    cfg["mapping"].update(MAPPING)
    cfg["tracking"].update(TRACKING)
    cfg["lc"] = dict(LC)
    cfg["data"]["output_path"] = str(out)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        return _runs(tmp_path_factory.mktemp("slice_lc"))
    finally:
        torch.set_num_threads(threads)


def _runs(out):
    mp = pytest.MonkeyPatch()
    mp.setenv("EAGS_RCFG", "backend=sorted")
    cfg = _configure(j_load_config("configs/synthetic/tiny.yaml"),
                     out / "jax")
    jslam = JSLAM(cfg)
    try:
        jslam.loop_closer.rcfg = jslam.loop_closer.rcfg._replace(
            backend="sorted")
        j_report = jslam.run()
        ds = jslam.dataset
        colors = np.stack([ds._frame_cache[i][0] for i in range(len(ds))])
        depths = np.stack([ds._frame_cache[i][1] for i in range(len(ds))])
        poses = np.stack([ds.poses[i] for i in range(len(ds))])
        j_c2w = jslam.estimated_c2ws.copy()
    finally:
        jslam.cleanup()
        mp.undo()

    tcfg = _configure(load_config("configs/synthetic/tiny.yaml"),
                      out / "port")
    tcfg["device"] = "cpu"
    tslam = GaussianSLAM(tcfg, dataset=ArrayDataset(tcfg, colors, depths,
                                                    poses),
                         draws=JaxDraws())
    try:
        cs.reset_counts()
        t_report = tslam.run()
        counts = (cs.counts(), cs.counts(LC_TAG))
    finally:
        tslam.cleanup()
    return dict(j_report=j_report, t_report=t_report, j_c2w=j_c2w,
                t_c2w=tslam.estimated_c2ws, poses=poses, counts=counts,
                t_slam=tslam)


def test_slice_lc_closes_like_jax(runs):
    j, t = runs["j_report"]["lc"], runs["t_report"]["lc"]
    assert t["n_submits"] == j["n_submits"] == 3
    assert t["n_closures"] == j["n_closures"] >= 1
    assert t["corrections_applied"] > 0
    assert runs["t_report"]["frames"] == N_FRAMES
    assert runs["t_slam"].submap_id == 2
    assert "lc_drain" in runs["t_report"]["stage_totals_s"]


def test_slice_lc_positions_match_jax(runs):
    d = np.linalg.norm(runs["t_c2w"][:, :3, 3] - runs["j_c2w"][:, :3, 3],
                       axis=-1)
    assert d.max() < 0.01, d


def test_slice_lc_counts_closer_apart(runs):
    """The closer's renders (twins on the CPU) count under its tag; the
    main path's counts hold only the SLAM loop's."""
    main, lc = runs["counts"]
    assert lc["fwd_twin_calls"] > 0 and lc["bwd_twin_calls"] > 0
    assert main["fwd_twin_calls"] > 0
    assert all(v == 0 for k, v in {**main, **lc}.items()
               if k.endswith("_launches"))
