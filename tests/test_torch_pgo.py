"""The port's pose-graph optimisation against the JAX package's, on the
graphs of tests/test_lc.py (a drifted 6-node chain with one exact loop edge,
and the same chain with a wildly wrong loop edge): the port's corrected
poses must pass the JAX test's own assertions and equal JAX's
`optimize_pose_graph` to atol 1e-4 (both float32), with the same loop edges
pruned (line weight below the threshold in both solves)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core.se3 import se3_exp as j_se3_exp
from eags_slam_tpu.lc import pgo as JP
from eags_slam_torch.lc import pgo as TP

ATOL = 1e-4


def _chain(rng, n=6, bad_loop=False, noise=0.02, loop_w=5.0):
    step = np.asarray(j_se3_exp(jnp.asarray([0.5, 0.0, 0.0, 0.0, 0.2, 0.0])))
    true_poses = [np.eye(4)]
    for _ in range(1, n):
        true_poses.append(true_poses[-1] @ step)
    true_poses = np.stack(true_poses)
    est = [np.eye(4)]
    for _ in range(1, n):
        nz = np.asarray(j_se3_exp(jnp.asarray(
            noise * rng.normal(size=6).astype(np.float32))))
        est.append(est[-1] @ step @ nz)
    est = np.stack(est)
    edges_ij = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]
    edges_T = [np.linalg.inv(est[i]) @ est[i + 1] for i in range(n - 1)]
    loop = np.linalg.inv(true_poses[0]) @ true_poses[n - 1]
    if bad_loop:
        loop = np.asarray(j_se3_exp(jnp.asarray(
            [1.5, -1.0, 0.8, 0.4, -0.5, 0.3]))) @ loop
    edges_T.append(loop)
    info = np.stack([np.eye(6)] * (n - 1) + [loop_w * np.eye(6)])
    is_loop = [False] * (n - 1) + [True]
    jg = JP.PoseGraph(
        poses=jnp.asarray(est, dtype=jnp.float32),
        edges_ij=jnp.asarray(np.asarray(edges_ij, np.int32)),
        edges_T=jnp.asarray(np.stack(edges_T), dtype=jnp.float32),
        edges_info=jnp.asarray(info, dtype=jnp.float32),
        edges_valid=jnp.ones((len(edges_ij),), bool),
        edges_is_loop=jnp.asarray(is_loop))
    tg = TP.PoseGraph(
        poses=torch.as_tensor(est, dtype=torch.float32),
        edges_ij=torch.as_tensor(np.asarray(edges_ij, np.int64)),
        edges_T=torch.as_tensor(np.stack(edges_T), dtype=torch.float32),
        edges_info=torch.as_tensor(info, dtype=torch.float32),
        edges_valid=torch.ones(len(edges_ij), dtype=torch.bool),
        edges_is_loop=torch.as_tensor(is_loop))
    return jg, tg, est, true_poses


def _both(jg, tg, **kw):
    j = np.asarray(JP.optimize_pose_graph(jg, **kw))
    t = TP.optimize_pose_graph(tg, **kw).numpy()
    np.testing.assert_allclose(t, j, atol=ATOL)
    return t


def _pruned(jg, tg, thres, iters=15):
    """Loop edges each package's line-process solve would prune."""
    _, _, sj = JP._gn_solve(jg, iters=iters, line_mu=0.25)
    _, _, st = TP._gn_solve(tg, iters=iters, line_mu=0.25)
    lj = np.asarray(jg.edges_is_loop) & (np.asarray(sj) < thres)
    lt = tg.edges_is_loop.numpy() & (st.numpy() < thres)
    return lj, lt


def test_pgo_corrects_drift(rng):
    """Twin of test_lc.py::test_pgo_corrects_drift (noise 0.03)."""
    jg, tg, est, true_poses = _chain(rng, noise=0.03)
    corrected = _both(jg, tg, iters=15)
    n = est.shape[0]
    err_before = np.linalg.norm(est[n - 1][:3, 3] - true_poses[n - 1][:3, 3])
    err_after = np.linalg.norm(corrected[n - 1][:3, 3]
                               - true_poses[n - 1][:3, 3])
    assert err_after < 0.5 * err_before, (err_before, err_after)


def test_pgo_prunes_bad_loop_edge(rng):
    """Twin of test_lc.py::test_pgo_prunes_bad_loop_edge."""
    jg, tg, est, _ = _chain(rng, bad_loop=True)
    n = est.shape[0]
    no_prune = _both(jg, tg, iters=15)
    assert np.linalg.norm(no_prune[n - 1][:3, 3] - est[n - 1][:3, 3]) > 0.3
    lj, lt = _pruned(jg, tg, 0.5)
    np.testing.assert_array_equal(lt, lj)
    assert lt[-1]
    pruned = _both(jg, tg, iters=15, edge_prune_thres=0.5)
    assert np.linalg.norm(pruned[n - 1][:3, 3] - est[n - 1][:3, 3]) < 0.05


def test_pgo_keeps_good_loop_edge_under_prune(rng):
    """Twin of test_lc.py::test_pgo_keeps_good_loop_edge_under_prune."""
    jg, tg, est, true_poses = _chain(rng)
    lj, lt = _pruned(jg, tg, 0.5)
    np.testing.assert_array_equal(lt, lj)
    assert not lt.any()
    corrected = _both(jg, tg, iters=15, edge_prune_thres=0.5)
    n = est.shape[0]
    err_before = np.linalg.norm(est[n - 1][:3, 3] - true_poses[n - 1][:3, 3])
    err_after = np.linalg.norm(corrected[n - 1][:3, 3]
                               - true_poses[n - 1][:3, 3])
    assert err_after < 0.5 * err_before, (err_before, err_after)


@pytest.mark.parametrize("case", ["invalid_edge", "full_info"])
def test_pgo_masked_and_correlated_edges(rng, case):
    """A wildly wrong loop edge marked invalid stays out of the solve (the
    odometry chain is left as it is), and a full 6x6 information whitens
    through its Cholesky factor, as in JAX."""
    jg, tg, est, _ = _chain(rng, bad_loop=case == "invalid_edge")
    if case == "invalid_edge":
        valid = np.array([True] * 5 + [False])
        jg = jg._replace(edges_valid=jnp.asarray(valid))
        tg = tg._replace(edges_valid=torch.as_tensor(valid))
    else:
        A = rng.normal(size=(6, 6, 6))
        info = (np.einsum("eij,ekj->eik", A, A) + 6 * np.eye(6)).astype(
            np.float32) / 6.0
        jg = jg._replace(edges_info=jnp.asarray(info))
        tg = tg._replace(edges_info=torch.as_tensor(info))
    out = _both(jg, tg, iters=10)
    assert np.isfinite(out).all()
    if case == "invalid_edge":
        np.testing.assert_allclose(out, est, atol=1e-4)
