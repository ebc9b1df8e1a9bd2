"""The whole slice on the entry-binned backend: the JAX GaussianSLAM and the
port's GaussianSLAM on device="cpu", both with EAGS_RCFG=backend=pallas
(the JAX package's v1 Pallas kernels in interpret mode; the port's K5 / K6
twins), on 3 frames of configs/synthetic/tiny.yaml with the iterations cut
(20 tracking, 20 mapping for the first submap, 10 for the last frame), the
same frames and the same random draws (the JAX keys'). On this backend the
tracker refines on a frozen entry binning of the full image and the mapper
runs the plain loop, which draws a keyframe every iteration: the draws come
from the JAX key split three ways per iteration, as the JAX loop splits it.

Tolerance on the per-frame cameras: 1 mm in position and 0.1 degree in
rotation (measured: 4e-5 m and 0.013 degree on the tracked frame; the
packages round float32 differently). The refine moves the tracked camera
about 1 cm from its constant-speed guess, so a refine that did nothing
would fail this. Both runs must also pass the e2e bounds (max position
error < 4 cm, ATE < 5 cm).

Also a unit parity of the plain mapping loop on the sorted backend
(`kf_block: 0`) with fixed keyframe draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.config import load_config as j_load_config
from eags_slam_tpu.core import gaussians as JG
from eags_slam_tpu.slam import mapper as JM
from eags_slam_tpu.slam.gaussian_slam import GaussianSLAM as JSLAM
from eags_slam_torch.config import load_config
from eags_slam_torch.core import gaussians as G
from eags_slam_torch.datasets import ArrayDataset
from eags_slam_torch.evaluation.trajectory import evaluate_trajectory
from eags_slam_torch.ops import composite_entries as ce
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.slam import mapper as M
from eags_slam_torch.slam.gaussian_slam import GaussianSLAM
from test_torch_mapper import (CAM, JCAM, JRCFG, RCFG, _frame, _jax_state,
                               _jax_to_numpy, _rows)
from test_torch_slice import JaxDraws

N_FRAMES = 3
OVERRIDES = {"tracking": {"iterations": 20},
             "mapping": {"iterations": 10, "new_submap_iterations": 20}}


def _plain_sampler(key):
    """The JAX plain loop's keyframe draws: the key splits three ways every
    iteration, the second part draws."""
    state = {"key": jnp.asarray(key)}

    def draw(p_kf, it):
        state["key"], k_sel, _ = jax.random.split(state["key"], 3)
        if it < 5:
            return 0
        return int(jax.random.categorical(
            k_sel, jnp.log(jnp.asarray(p_kf) + 1e-12)))
    return draw


class JaxPlainDraws(JaxDraws):
    def kf_sampler(self, key):
        return _plain_sampler(key)


def _config(load, out):
    cfg = load("configs/synthetic/tiny.yaml")
    cfg["frame_limit"] = N_FRAMES
    for sec, d in OVERRIDES.items():
        cfg[sec].update(d)
    cfg["data"]["output_path"] = str(out)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # Two intra-op threads: the suite runs in several processes at once.
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    mp = pytest.MonkeyPatch()
    mp.setenv("EAGS_RCFG", "backend=pallas")
    try:
        return _runs(tmp_path_factory.mktemp("entries"))
    finally:
        mp.undo()
        torch.set_num_threads(threads)


def _runs(out):
    jslam = JSLAM(_config(j_load_config, out / "jax"))
    try:
        jslam.run()
        ds = jslam.dataset
        n = len(ds)
        colors = np.stack([ds._frame_cache[i][0] for i in range(n)])
        depths = np.stack([ds._frame_cache[i][1] for i in range(n)])
        poses = np.stack([ds.poses[i] for i in range(n)])
        j_c2w = jslam.estimated_c2ws.copy()
        j_backend = jslam.rcfg.backend
    finally:
        jslam.cleanup()

    tcfg = _config(load_config, out / "port")
    tcfg["device"] = "cpu"
    tslam = GaussianSLAM(tcfg, dataset=ArrayDataset(tcfg, colors, depths,
                                                    poses),
                         draws=JaxPlainDraws())
    try:
        cs.reset_counts()
        ce.reset_counts()
        report = tslam.run()
        counts = {**cs.counts(), **ce.counts()}
    finally:
        tslam.cleanup()
    return dict(poses=poses, c2w={"jax": j_c2w, "port": tslam.estimated_c2ws},
                report=report, counts=counts,
                backends=(j_backend, tslam.rcfg.backend))


def test_entries_slice_positions_match_jax(runs):
    assert runs["backends"] == ("pallas", "pallas")
    port, ref = runs["c2w"]["port"], runs["c2w"]["jax"]
    d = np.linalg.norm(port[:, :3, 3] - ref[:, :3, 3], axis=-1)
    assert d.max() < 1e-3, d
    rel = np.einsum("nji,njk->nik", port[:, :3, :3], ref[:, :3, :3])
    cos = (np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0
    angle = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    assert angle.max() < 0.1, angle
    assert runs["report"]["frames"] == N_FRAMES


@pytest.mark.parametrize("side", ["jax", "port"])
def test_entries_slice_within_e2e_bounds(runs, side):
    c2w = runs["c2w"][side]
    err = np.linalg.norm(c2w[:, :3, 3] - runs["poses"][:, :3, 3], axis=-1)
    assert err.max() < 0.04, err
    assert evaluate_trajectory(c2w, runs["poses"])["ate"]["rmse"] < 0.05


def test_entries_slice_runs_entry_path(runs):
    """Every render of the run went through K5 / K6's twins: no sorted
    compositing (so no tile subset: it renders the sorted layout), no
    kernel launch."""
    assert runs["backends"] == ("pallas", "pallas")
    c = runs["counts"]
    assert c["entries_fwd_twin_calls"] > 0 and c["entries_bwd_twin_calls"] > 0
    assert all(v == 0 for k, v in c.items() if not k.startswith("entries")
               or "launches" in k), c


def test_plain_mapping_loop_matches_jax():
    """`kf_block: 0` on the sorted backend: the plain loop, a keyframe drawn
    every iteration from 3 keyframes (the JAX key's draws), 10 iterations
    with both prunes. Tolerance as tests/test_torch_mapper.py: parameters
    1e-4 absolute, alive masks equal, losses 1e-4 relative."""
    color, depth = _frame()
    base = _rows(color, depth, 600, seed=1)
    new = _rows(color, depth, 300, seed=2)
    mcfg_j = JM.MapperConfig(max_keyframes=4, kf_block=0)
    mcfg_t = M.MapperConfig(max_keyframes=4, kf_block=0)
    w2cs = []
    for i in range(3):
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = [0.01 * i, -0.005 * i, 0.0]
        w2cs.append(w)
    jst = _jax_state(base, 1024)
    kfs = JM.empty_keyframes(4, JCAM)
    for i, w in enumerate(w2cs):
        kfs = JM.push_keyframe(kfs, i, jnp.asarray(color),
                               jnp.asarray(depth), jnp.asarray(w),
                               jnp.zeros(2))
    jrows = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in new.items()})
    valid = np.ones(300, bool)
    valid[::7] = False
    key = np.asarray(jax.random.PRNGKey(3))
    j_state, j_added, j_losses, j_alive, _ = JM.insert_and_optimize(
        jst, jrows, jnp.asarray(valid), kfs, jnp.asarray(3, jnp.int32),
        jnp.asarray(key), 10, JCAM, JRCFG, mcfg_j)

    st = G.state_from_numpy(_jax_to_numpy(jst))
    tkfs = M.empty_keyframes(4, CAM)
    for i, w in enumerate(w2cs):
        M.push_keyframe(tkfs, i, torch.as_tensor(color),
                        torch.as_tensor(depth), torch.as_tensor(w),
                        torch.zeros(2))
    trows = G.GaussianParams(**{k: torch.as_tensor(v) for k, v in
                                new.items()})
    draws = []
    sampler = _plain_sampler(key)

    def record(p, it):
        draws.append(sampler(p, it))
        return draws[-1]

    cs.reset_counts()
    t_state, t_added, t_losses, t_alive, _ = M.insert_and_optimize(
        st, trows, torch.as_tensor(valid), tkfs, 3, 10, CAM, RCFG, mcfg_t,
        kf_sampler=record)
    assert len(draws) == 10 and set(draws[5:]) - {0}, draws
    assert cs.counts()["bwd_twin_calls"] == 10     # one render an iteration
    assert t_added == int(j_added) and t_alive == int(j_alive)
    np.testing.assert_array_equal(t_state.alive.numpy(),
                                  np.asarray(j_state.alive))
    for k in G.OPT_KEYS:
        np.testing.assert_allclose(
            getattr(t_state.params, k).numpy(),
            np.asarray(getattr(j_state.params, k)), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(t_losses, np.asarray(j_losses), rtol=1e-4)
