"""Pose-graph optimisation on SE(3) (port of eags_slam_tpu.lc.pgo).

Odometry edges between consecutive submaps and loop edges from
registration, each with a 6x6 information matrix; Gauss-Newton over all
edges at once: residuals r_ij = log(Z_ij^-1 X_i^-1 X_j), whitened by the
Cholesky factor of each edge's information, a Huber weight on the whitened
norm, and the jacobian by `torch.func.jacrev` over the stacked tangent
increments. Node 0 is fixed.

Loop edges carry line-process weights s_e = (mu / (mu + chi2_e))^2,
recomputed every iteration (switchable constraints, as in Open3D's
GlobalOptimization); edges whose final weight falls below
`edge_prune_thres` are dropped and the graph re-solved at full weight.

The graph has at most a few dozen nodes, so the solve runs in float32 on
the host CPU and leaves the card to the SLAM loop.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.se3 import se3_exp, se3_log


class PoseGraph(NamedTuple):
    poses: torch.Tensor          # (N, 4, 4) node poses (world)
    edges_ij: torch.Tensor       # (E, 2) int64 node index pairs
    edges_T: torch.Tensor        # (E, 4, 4) measured T_i_j
    edges_info: torch.Tensor     # (E, 6, 6) information matrices
    edges_valid: torch.Tensor    # (E,) bool
    edges_is_loop: torch.Tensor  # (E,) bool: prunable (odometry never)


def scalar_info(w) -> torch.Tensor:
    """Scalar weight -> isotropic 6x6 information."""
    return torch.as_tensor(w, dtype=torch.float32)[..., None, None] \
        * torch.eye(6)


def _edge_residuals(poses, graph: PoseGraph):
    Xi = poses[graph.edges_ij[:, 0]]
    Xj = poses[graph.edges_ij[:, 1]]
    rel = torch.linalg.inv(graph.edges_T) @ torch.linalg.inv(Xi) @ Xj
    return se3_log(rel)


def _gn_solve(graph: PoseGraph, iters: int = 20, huber: float = 0.5,
              line_mu: Optional[float] = None):
    """Whitened Gauss-Newton over the valid edges. Returns (poses (N,4,4),
    per-edge chi2 (E,), per-edge final line weight (E,))."""
    n = graph.poses.shape[0]
    e = graph.edges_T.shape[0]
    eye6 = torch.eye(6, dtype=graph.edges_info.dtype)
    info = graph.edges_info + 1e-9 * eye6
    L, bad_chol = torch.linalg.cholesky_ex(info)
    # A factor that failed is NaN, as it is in the JAX package.
    L = torch.where((bad_chol != 0)[:, None, None],
                    torch.full_like(L, float("nan")), L)
    valid = graph.edges_valid
    validf = valid.to(L.dtype)

    def chi2_of(poses):
        r = _edge_residuals(poses, graph)
        chi2 = torch.einsum("ei,eij,ej->e", r, info, r)
        # A non-finite residual (degenerate se3_log) is maximal
        # inconsistency, not a solver poison.
        return torch.where(torch.isfinite(chi2), chi2,
                           torch.full_like(chi2, 1e12))

    def line_weights(poses):
        if line_mu is None:
            return torch.ones((e,), dtype=L.dtype)
        s = (line_mu / (line_mu + chi2_of(poses))) ** 2
        return torch.where(graph.edges_is_loop, s, torch.ones_like(s))

    def residuals(tangents, base_poses, s):
        X = base_poses @ se3_exp(tangents)
        r = _edge_residuals(X, graph)
        # `where`, not a product: 0 * NaN is NaN, and se3_log of a wildly
        # wrong pruned edge must not poison the solve.
        r = torch.where(valid[:, None] & torch.isfinite(r), r,
                        torch.zeros_like(r))
        rw = torch.einsum("eij,ei->ej", L, r)
        # sqrt(max(., eps)) keeps the jacobian finite at zero residuals.
        nrm = torch.sqrt(torch.clamp((rw * rw).sum(-1), min=1e-18))
        w = torch.where(nrm > huber, huber / torch.clamp(nrm, min=1e-9),
                        torch.ones_like(nrm))
        w = w * s * validf
        return (rw * torch.sqrt(w)[:, None]).reshape(-1)

    mask = torch.cat([torch.zeros(6), torch.ones((n - 1) * 6)]).to(L.dtype)
    jac = torch.func.jacrev(residuals)
    poses = graph.poses
    z = torch.zeros((n, 6), dtype=L.dtype)
    for _ in range(iters):
        s = line_weights(poses)
        r = residuals(z, poses, s)
        J = jac(z, poses, s).reshape(r.shape[0], n * 6) * mask[None, :]
        H = J.T @ J + 1e-6 * torch.eye(n * 6) + torch.diag(1.0 - mask)
        g = -J.T @ r
        delta = torch.linalg.solve(H, g).reshape(n, 6) * mask.reshape(n, 6)
        poses = poses @ se3_exp(delta)
    return poses, chi2_of(poses), line_weights(poses)


def optimize_pose_graph(graph: PoseGraph, iters: int = 20,
                        huber: float = 0.5,
                        edge_prune_thres: Optional[float] = None,
                        line_mu: float = 0.25) -> torch.Tensor:
    """Gauss-Newton PGO with line-process loop edges; returns the corrected
    (N, 4, 4) poses, node 0 fixed. With `edge_prune_thres`, loop edges
    whose final line weight falls below it are dropped and the graph is
    re-solved from the original poses at full weight (`line_mu`: the chi2
    at which a loop edge's weight halves)."""
    graph = PoseGraph(*(t.detach().cpu() for t in graph))
    with torch.no_grad():
        if edge_prune_thres is None:
            return _gn_solve(graph, iters=iters, huber=huber)[0]
        poses, _, s = _gn_solve(graph, iters=iters, huber=huber,
                                line_mu=line_mu)
        bad = graph.edges_is_loop & (s < edge_prune_thres) \
            & graph.edges_valid
        if not bool(bad.any()):
            return poses
        # Clearing edges_is_loop makes every line weight exactly 1.
        return _gn_solve(
            graph._replace(edges_valid=graph.edges_valid & ~bad,
                           edges_is_loop=torch.zeros_like(bad)),
            iters=iters, huber=huber, line_mu=line_mu)[0]
