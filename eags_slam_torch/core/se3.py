"""Quaternion and SE(3) math (port of eags_slam_tpu.core.se3): the
quaternion algebra, the SO(3) / SE(3) exponential and logarithm, and the
rotation averaging of loop closure. Quaternions are wxyz, unit norm."""
from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, batched."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz.

    Shepperd-style: all four candidates, pick the largest pivot, canonical
    sign w >= 0."""
    m = R
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw_w = _safe_sqrt(1.0 + t) / 2.0
    q_w = torch.stack([
        qw_w,
        (m[..., 2, 1] - m[..., 1, 2]) / (4 * qw_w),
        (m[..., 0, 2] - m[..., 2, 0]) / (4 * qw_w),
        (m[..., 1, 0] - m[..., 0, 1]) / (4 * qw_w),
    ], dim=-1)
    qx_x = _safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q_x = torch.stack([
        (m[..., 2, 1] - m[..., 1, 2]) / (4 * qx_x),
        qx_x,
        (m[..., 0, 1] + m[..., 1, 0]) / (4 * qx_x),
        (m[..., 0, 2] + m[..., 2, 0]) / (4 * qx_x),
    ], dim=-1)
    qy_y = _safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q_y = torch.stack([
        (m[..., 0, 2] - m[..., 2, 0]) / (4 * qy_y),
        (m[..., 0, 1] + m[..., 1, 0]) / (4 * qy_y),
        qy_y,
        (m[..., 1, 2] + m[..., 2, 1]) / (4 * qy_y),
    ], dim=-1)
    qz_z = _safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q_z = torch.stack([
        (m[..., 1, 0] - m[..., 0, 1]) / (4 * qz_z),
        (m[..., 0, 2] + m[..., 2, 0]) / (4 * qz_z),
        (m[..., 1, 2] + m[..., 2, 1]) / (4 * qz_z),
        qz_z,
    ], dim=-1)
    pivots = torch.stack([t, m00, m11, m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([q_w, q_x, q_y, q_z], dim=-2)        # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def skew(w: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros_like(w[..., 0])
    rows = [
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def so3_exp(w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues formula, stable near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 <= eps
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    W = skew(w)
    WW = W @ W
    a = torch.sinc(torch.sqrt(theta2 + eps * eps) / torch.pi)
    b = torch.where(small, torch.full_like(theta2, 0.5),
                    (1.0 - torch.cos(theta_safe)) / theta2_safe)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * WW


def se3_exp(tau: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Twist (..., 6) [rho(3), phi(3)] -> homogeneous (..., 4, 4)."""
    rho, phi = tau[..., :3], tau[..., 3:]
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 <= eps
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    W = skew(phi)
    WW = W @ W
    R = so3_exp(phi)
    b = torch.where(small, torch.full_like(theta2, 0.5),
                    (1.0 - torch.cos(theta_safe)) / theta2_safe)
    c = torch.where(small, torch.full_like(theta2, 1.0 / 6.0),
                    (theta_safe - torch.sin(theta_safe))
                    / (theta2_safe * theta_safe))
    eye = torch.eye(3, dtype=tau.dtype, device=tau.device).expand(W.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    t = torch.einsum("...ij,...j->...i", V, rho)
    return Rt_to_mat(R, t)


def Rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.eye(4, dtype=R.dtype, device=R.device).expand(
        batch + (4, 4)).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def mat_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE3 inverse [R^T, -R^T t]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return Rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    return torch.einsum("...ij,...j->...i", quat_to_rotmat(q), v)


def so3_log(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    cos(theta) is clipped strictly inside (-1, 1) and theta / (2 sin theta)
    is taken as 0.5 / sinc(theta / pi), so that the gradient stays finite
    at the identity (a Gauss-Newton jacobian goes through exactly-zero
    residuals). Near theta = pi the formula degrades."""
    cos_theta = torch.clamp(
        (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0,
        -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    w_hat = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                         R[..., 0, 2] - R[..., 2, 0],
                         R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = 0.5 / torch.sinc(theta / torch.pi)
    return scale[..., None] * w_hat


def se3_log(T: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Homogeneous (..., 4, 4) -> twist (..., 6) [rho, phi]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3_log(R, eps)
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 <= eps
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    W = skew(phi)
    WW = W @ W
    half = theta_safe / 2.0
    cot = torch.where(
        small, torch.full_like(theta2, 1.0 / 12.0),
        (1.0 - half * torch.cos(half) / (torch.sin(half) + eps))
        / theta2_safe)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    Vinv = eye - 0.5 * W + cot[..., None, None] * WW
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, phi], dim=-1)


def const_speed_extrapolate(T_prev2: torch.Tensor,
                            T_prev1: torch.Tensor) -> torch.Tensor:
    """Constant-velocity pose prediction T1 @ T0^-1 @ T1."""
    return T_prev1 @ mat_inverse(T_prev2) @ T_prev1


def special_procrustes(M: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto SO(3) through the SVD, the sign of
    det(U V^T) on D[2, 2]."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.zeros_like(M)
    D[..., 0, 0] = 1.0
    D[..., 1, 1] = 1.0
    D[..., 2, 2] = det
    return U @ D @ Vt


def rotation_average(Rs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted chordal-L2 rotation mean: the procrustes of the weighted
    sum of (..., K, 3, 3) rotations."""
    M = torch.sum(Rs * weights[..., None, None], dim=-3)
    return special_procrustes(M)
