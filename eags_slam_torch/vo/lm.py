"""SE(3) Levenberg-Marquardt alignment of edge points to a keyframe's
distance transform (port of eags_slam_tpu.vo.lm).

Per iteration: transform and project the edge points, sample (gx, gy, dt)
bilinearly, weight w = min(1, huber_edge / r) with the per-level
edge-distance filter, accumulate the 6x6 normal equations in one einsum,
then try up to `max_lambda_tries` damped steps (success halves lambda,
failure doubles it). Stop when no step was accepted or the cost fell by
less than the factor `eps`.

The JAX version is two nested `lax.while_loop`s; here they are host loops
over the same iterates. Each lambda try reads one flag and one cost back
to the host (tens of reads per frame); the 6x6 solve uses `solve_ex`, which
does not synchronise to check for a singular matrix (a singular step gives
a non-finite delta and is rejected, as in the JAX version).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.camera import Camera
from ..core.se3 import se3_exp
from ..ops.image import bilinear_sample


class LMSettings(NamedTuple):
    huber_edge: float = 0.3
    max_iters: int = 100
    eps: float = 0.999          # stop when new_cost > eps * old_cost
    lambda_init: float = 1e-4
    max_lambda_tries: int = 5
    dist_filter: float = 30.0   # ignore points with dt > filter (per level)


class LMResult(NamedTuple):
    R: torch.Tensor     # (3, 3)
    t: torch.Tensor     # (3,)
    cost: float         # mean weighted residual
    good: int           # points with a small residual
    bad: int            # valid points that are not good
    iters: int


def _residuals(R, t, pts, valid, kf_gx, kf_gy, kf_dt, cam: Camera,
               s: LMSettings):
    p = pts @ R.T + t
    z = p[:, 2]
    in_front = z > 1e-3
    inv_z = 1.0 / torch.clamp(z, min=1e-3)
    u = p[:, 0] * inv_z * cam.fx + cam.cx
    v = p[:, 1] * inv_z * cam.fy + cam.cy
    uv = torch.stack([u, v], -1)
    dt, in_b = bilinear_sample(kf_dt, uv)
    gx, _ = bilinear_sample(kf_gx, uv)
    gy, _ = bilinear_sample(kf_gy, uv)
    ok = valid & in_front & in_b & (dt <= s.dist_filter)
    r = torch.where(ok, dt, torch.zeros_like(dt))
    w = torch.where(r > s.huber_edge,
                    s.huber_edge / torch.clamp(r, min=1e-9),
                    torch.ones_like(r))
    w = torch.where(ok, w, torch.zeros_like(w))
    return p, r, w, gx, gy, ok


def _normal_equations(p, r, w, gx, gy, cam: Camera):
    """A = J^T W J (6x6), b = -J^T W r; twist order [rho, phi] as se3_exp."""
    z = torch.clamp(p[:, 2], min=1e-3)
    inv_z = 1.0 / z
    x, y = p[:, 0], p[:, 1]
    gu = gx * cam.fx * inv_z
    gv = gy * cam.fy * inv_z
    J = torch.stack([
        gu, gv, -(gu * x + gv * y) * inv_z,
        -gu * x * y * inv_z - gv * (z + y * y * inv_z),
        gu * (z + x * x * inv_z) + gv * x * y * inv_z,
        -gu * y + gv * x], -1)                         # (P, 6)
    Jw = J * w[:, None]
    return torch.einsum("pi,pj->ij", Jw, J), -torch.einsum("pi,p->i", Jw, r)


def _cost(r, w, ok):
    n = torch.clamp(ok.to(torch.float32).sum(), min=1.0)
    return (w * r * r).sum() / n


@torch.no_grad()
def lm_align(pts, valid, kf_gx, kf_gy, kf_dt, R0, t0, cam: Camera,
             s: LMSettings) -> LMResult:
    """LM solve for the pose aligning `pts` onto the keyframe DT."""
    eye6 = torch.eye(6, dtype=torch.float32, device=pts.device)

    def eval_cost(R, t):
        _, r, w, _, _, ok = _residuals(R, t, pts, valid, kf_gx, kf_gy, kf_dt,
                                       cam, s)
        return _cost(r, w, ok)

    R, t = R0, t0
    best_cost = None
    lam = np.float32(s.lambda_init)
    it = 0
    while it < s.max_iters:
        p, r, w, gx, gy, ok = _residuals(R, t, pts, valid, kf_gx, kf_gy,
                                         kf_dt, cam, s)
        A, b = _normal_equations(p, r, w, gx, gy, cam)
        cost0 = _cost(r, w, ok)
        best_cost, accepted = cost0, False
        for _ in range(s.max_lambda_tries):
            Areg = A + float(lam) * torch.diag(torch.diag(A)) + 1e-8 * eye6
            delta = torch.linalg.solve_ex(Areg, b)[0]
            T_new = se3_exp(delta)
            R_new = T_new[:3, :3] @ R
            t_new = T_new[:3, :3] @ t + T_new[:3, 3]
            new_cost = eval_cost(R_new, t_new)
            better = torch.isfinite(delta).all() & (new_cost < best_cost)
            if bool(better):
                lam = np.float32(lam * np.float32(0.5))
                R, t, best_cost, accepted = R_new, t_new, new_cost, True
                break
            lam = np.float32(lam * np.float32(2.0))
        it += 1
        if not accepted or bool(best_cost > s.eps * cost0):
            break
    _, r, w, _, _, ok = _residuals(R, t, pts, valid, kf_gx, kf_gy, kf_dt,
                                   cam, s)
    good = int((ok & (r < s.huber_edge)).sum())
    bad = int(valid.sum()) - good
    cost = float(eval_cost(R0, t0) if best_cost is None else best_cost)
    return LMResult(R, t, cost, good, bad, it)
