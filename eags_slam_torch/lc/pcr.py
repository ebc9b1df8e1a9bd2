"""Global point-cloud registration: FPFH features + RANSAC (port of
eags_slam_tpu.lc.pcr).

Open3D's `preprocess_point_cloud` and `execute_global_registration` as
batched tensor math: voxel downsampling, kNN-PCA normals, FPFH (SPFH
angular triplets histogrammed into 3 x 11 bins, plus the distance-weighted
mean of the neighbours' SPFH), mutual nearest neighbours in feature space,
and a RANSAC that solves Kabsch for thousands of sampled triples at once
and scores each on the whole correspondence set, with the edge-length
check as a validity mask. Only the `robust_icp` registration reaches it.

The RANSAC's triples are an input (`_ransac_core`): `global_registration`
draws them with a `torch.Generator` seeded from `seed`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def voxel_downsample(pts: np.ndarray, voxel: float, cap: int = 8192,
                     seed: int = 0) -> np.ndarray:
    """One point per occupied voxel (first hit), capped to `cap` points."""
    keys = np.floor(pts / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    out = pts[np.sort(idx)]
    if len(out) > cap:
        rng = np.random.default_rng(seed)
        out = out[rng.choice(len(out), cap, replace=False)]
    return out


def _knn_indices(pts: torch.Tensor, k: int):
    """(N, k) neighbour indices (self excluded) and distances."""
    d2 = torch.sum((pts[:, None, :] - pts[None, :, :]) ** 2, -1)
    d2 = d2 + torch.eye(pts.shape[0], device=pts.device) * 1e9
    neg, idx = torch.topk(-d2, k, dim=1)
    return idx, torch.sqrt(torch.clamp(-neg, min=1e-12))


def estimate_normals(pts: torch.Tensor, k: int = 16) -> torch.Tensor:
    """kNN-PCA normals, flipped into the +z half-space."""
    idx, _ = _knn_indices(pts, k)
    nbrs = pts[idx]
    d = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", d, d) / k
    _, vecs = torch.linalg.eigh(cov)
    n = vecs[..., 0]
    return n * torch.where(n[..., 2:3] < 0, -1.0, 1.0)


def fpfh(pts: torch.Tensor, normals: torch.Tensor, k: int = 16,
         bins: int = 11) -> torch.Tensor:
    """(N, 3 * bins) L1-normalised FPFH descriptors."""
    idx, dist = _knn_indices(pts, k)
    pq = pts[idx] - pts[:, None, :]
    d = torch.linalg.norm(pq, dim=-1, keepdim=True)
    pq_n = pq / torch.clamp(d, min=1e-9)
    nq = normals[idx]
    u = normals[:, None, :].expand(pq.shape)
    v = torch.linalg.cross(pq_n, u, dim=-1)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)
    w = torch.linalg.cross(u, v, dim=-1)
    alpha = torch.sum(v * nq, -1)
    phi = torch.sum(u * pq_n, -1)
    theta = torch.atan2(torch.sum(w * nq, -1), torch.sum(u * nq, -1))

    def hist(x, lo, hi):
        t = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0 - 1e-6)
        b = torch.floor(t * bins).long()
        return torch.nn.functional.one_hot(b, bins).to(pts.dtype).sum(1)

    spfh = torch.cat([hist(alpha, -1.0, 1.0), hist(phi, -1.0, 1.0),
                      hist(theta, -torch.pi, torch.pi)], dim=-1)
    wk = 1.0 / (1.0 + dist)
    out = spfh + torch.einsum("nk,nkb->nb", wk, spfh[idx]) / k
    return out / torch.clamp(out.abs().sum(-1, keepdim=True), min=1e-9)


def _kabsch(x, y):
    """Batched (H, 3, 3) point triples -> (R (H, 3, 3), t (H, 3)) with
    R x + t ~ y, the det sign on the last singular direction."""
    xm, ym = x.mean(1), y.mean(1)
    Hm = (x - xm[:, None]).transpose(1, 2) @ (y - ym[:, None])
    U, _, Vt = torch.linalg.svd(Hm)
    V = Vt.transpose(1, 2)
    s = torch.sign(torch.linalg.det(V @ U.transpose(1, 2)))
    S = torch.diag_embed(torch.stack([torch.ones_like(s), torch.ones_like(s),
                                      s], -1))
    R = V @ S @ U.transpose(1, 2)
    return R, ym - torch.einsum("hij,hj->hi", R, xm)


def _ransac_core(trip: torch.Tensor, src, tgt, corr_s, corr_t,
                 dist_thres: float):
    """3-point RANSAC over a correspondence set. `trip` (H, 3): sampled
    indices into corr_s / corr_t. Returns (T_best 4x4, inlier fraction).
    The edge-length check (Open3D, factor 0.9) masks implausible triples
    before scoring."""
    m = corr_s.shape[0]
    a = src[corr_s[trip]]
    b = tgt[corr_t[trip]]

    def el(z):
        return torch.stack([torch.linalg.norm(z[:, 0] - z[:, 1], dim=-1),
                            torch.linalg.norm(z[:, 1] - z[:, 2], dim=-1),
                            torch.linalg.norm(z[:, 0] - z[:, 2], dim=-1)], -1)

    ea, eb = el(a), el(b)
    r = torch.minimum(ea, eb) / torch.clamp(torch.maximum(ea, eb), min=1e-9)
    ok = torch.all(r > 0.9, dim=-1) & torch.all(ea > 1e-4, dim=-1)
    Rs, ts = _kabsch(a, b)
    moved = torch.einsum("hij,mj->hmi", Rs, src[corr_s]) + ts[:, None, :]
    inl = torch.sum(torch.sum((moved - tgt[corr_t][None]) ** 2, -1)
                    < dist_thres * dist_thres, dim=1)
    inl = torch.where(ok, inl, torch.full_like(inl, -1))
    best = int(torch.argmax(inl))
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    T[:3, :3] = Rs[best]
    T[:3, 3] = ts[best]
    return T, float(inl[best]) / max(m, 1)


def global_registration(src_pts: np.ndarray, tgt_pts: np.ndarray,
                        voxel: float = 0.05,
                        dist_thres: Optional[float] = None, seed: int = 0,
                        n_hyp: int = 4096,
                        device="cpu") -> Tuple[np.ndarray, float]:
    """FPFH + RANSAC coarse alignment: (T mapping src into the tgt frame,
    inlier fraction); distance threshold 1.5 voxels by default."""
    if dist_thres is None:
        dist_thres = 1.5 * voxel
    dev = torch.device(device)
    s = torch.as_tensor(voxel_downsample(src_pts, voxel, seed=seed),
                        dtype=torch.float32, device=dev)
    t = torch.as_tensor(voxel_downsample(tgt_pts, voxel, seed=seed),
                        dtype=torch.float32, device=dev)
    fs = fpfh(s, estimate_normals(s))
    ft = fpfh(t, estimate_normals(t))
    d_st = torch.sum((fs[:, None, :] - ft[None, :, :]) ** 2, -1)
    nn_st = torch.argmin(d_st, dim=1)
    nn_ts = torch.argmin(d_st, dim=0)
    mutual = nn_ts[nn_st] == torch.arange(fs.shape[0], device=dev)
    corr_s = torch.nonzero(mutual)[:, 0]
    if corr_s.numel() < 10:
        return np.eye(4), 0.0
    corr_t = nn_st[corr_s]
    gen = torch.Generator(device=dev).manual_seed(seed)
    trip = torch.randint(0, corr_s.numel(), (n_hyp, 3), generator=gen,
                         device=dev)
    T, frac = _ransac_core(trip, s, t, corr_s, corr_t, dist_thres)
    return T.cpu().numpy().astype(np.float64), frac
