"""Nearest-neighbour primitives (port of the functions of
eags_slam_tpu.ops.knn that map growth reaches): Morton-window dedup + kNN
scale init, chunked brute-force kNN, radius dedup, statistical outliers.

Masked entries use 1e30 distances; inputs are capacity-padded with masks.
"""
from __future__ import annotations

import torch

_INF = 1e30


def _chunked_topk(query, qmask, ref, rmask, k: int, chunk: int,
                  exclude_self_offset=None):
    """Per-query k smallest squared distances to `ref` (masked), ascending,
    clamped at 0. `exclude_self_offset`: ref[i + offset] is excluded for
    query i."""
    nq = query.shape[0]
    ref_sq = torch.where(rmask, (ref * ref).sum(-1),
                         torch.full_like(ref[:, 0], _INF))
    outs = []
    for c0 in range(0, nq, chunk):
        q = query[c0:c0 + chunk]
        d2 = (q * q).sum(-1, keepdim=True) - 2.0 * (q @ ref.T) \
            + ref_sq[None, :]
        d2 = torch.where(rmask[None, :], d2, torch.full_like(d2, _INF))
        if exclude_self_offset is not None:
            rows = torch.arange(c0, c0 + q.shape[0], device=q.device)
            cols = rows + exclude_self_offset
            valid = cols < ref.shape[0]
            d2[torch.arange(q.shape[0], device=q.device)[valid],
               cols[valid]] = _INF
        kk = min(k, d2.shape[1])
        top = -torch.topk(-d2, kk, dim=1).values
        if kk < k:
            top = torch.nn.functional.pad(top, (0, k - kk), value=_INF)
        outs.append(top)
    out = torch.cat(outs, 0) if outs else query.new_zeros((0, k))
    return torch.clamp(out, min=0.0)


def mean_sq_dist_knn(pts, mask, k: int = 3, chunk: int = 1024):
    """distCUDA2 equivalent: mean squared distance to the k nearest
    neighbours (self excluded). Invalid rows get 1e-8."""
    d2 = _chunked_topk(pts, mask, pts, mask, k, chunk, exclude_self_offset=0)
    md = torch.where(d2 >= _INF * 0.5, torch.zeros_like(d2), d2).mean(-1)
    return torch.where(mask, torch.clamp(md, min=1e-8),
                       torch.full_like(md, 1e-8))


def mean_sq_dist_knn_query(query, qmask, ref, rmask, k: int = 3,
                           chunk: int = 1024, self_offset=None):
    """distCUDA2 for query rows only, against a reference set."""
    d2 = _chunked_topk(query, qmask, ref, rmask, k, chunk,
                       exclude_self_offset=self_offset)
    md = torch.where(d2 >= _INF * 0.5, torch.zeros_like(d2), d2).mean(-1)
    return torch.where(qmask, torch.clamp(md, min=1e-8),
                       torch.full_like(md, 1e-8))


def nearest_sq_dist(query, qmask, ref, rmask, chunk: int = 1024):
    return _chunked_topk(query, qmask, ref, rmask, 1, chunk)[:, 0]


def radius_dedup(new_pts, new_mask, existing, ex_mask, radius: float,
                 chunk: int = 1024):
    """Keep-mask: candidate i is dropped when an existing point, or a
    candidate j < i, lies within `radius`."""
    r2 = radius * radius
    keep = nearest_sq_dist(new_pts, new_mask, existing, ex_mask, chunk) > r2
    n = new_pts.shape[0]
    sq = torch.where(new_mask, (new_pts * new_pts).sum(-1),
                     torch.full_like(new_pts[:, 0], _INF))
    prior = []
    for c0 in range(0, n, chunk):
        q = new_pts[c0:c0 + chunk]
        d2 = (q * q).sum(-1, keepdim=True) - 2.0 * (q @ new_pts.T) \
            + sq[None, :]
        rows = torch.arange(c0, c0 + q.shape[0], device=q.device)[:, None]
        cols = torch.arange(n, device=q.device)[None, :]
        d2 = torch.where((cols < rows) & new_mask[None, :], d2,
                         torch.full_like(d2, _INF))
        prior.append(d2.min(1).values if n else d2.new_zeros(0))
    d2_prior = torch.cat(prior) if prior else new_pts.new_zeros(0)
    return keep & (d2_prior > r2) & new_mask


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x to every 3rd bit (int64 arithmetic)."""
    x = x & 0x3FF
    x = (x ^ (x << 16)) & 0xFF0000FF
    x = (x ^ (x << 8)) & 0x0300F00F
    x = (x ^ (x << 4)) & 0x030C30C3
    x = (x ^ (x << 2)) & 0x09249249
    return x


def morton_codes(pts: torch.Tensor, valid: torch.Tensor,
                 offset: float = 0.0) -> torch.Tensor:
    """30-bit Morton codes over the valid points' bounding box (int64);
    invalid rows get 0xFFFFFFFF."""
    v = valid[:, None]
    lo = torch.where(v, pts, torch.full_like(pts, _INF)).min(0).values
    hi = torch.where(v, pts, torch.full_like(pts, -_INF)).max(0).values
    extent = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp(((pts - lo) / extent) * 1023.0 + offset, 0.0,
                    1023.0).long()
    code = (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1)
            | (_part1by2(q[:, 2]) << 2))
    return torch.where(valid, code, torch.full_like(code, 0xFFFFFFFF))


def _window_pass(pts, valid, code, window: int, k: int):
    """Sort rows by `code` and compare each against its +-window neighbours.
    Returns, in original row order, the k smallest (d2, neighbour id) pairs
    and the smallest d2 to a lower-index row."""
    m = pts.shape[0]
    dev = pts.device
    window = min(window, m - 1)
    if window < 1:
        return (torch.full((m, k), _INF, device=dev),
                torch.full((m, k), -1, dtype=torch.long, device=dev),
                torch.full((m,), _INF, device=dev))
    order = torch.sort(code, stable=True).indices
    xs, ys, zs = pts[order, 0], pts[order, 1], pts[order, 2]
    prio_s = order
    val_s = valid[order]
    inf = torch.full((m,), _INF, device=dev)
    neg1 = torch.full((m,), -1, dtype=torch.long, device=dev)
    nbr_d2, nbr_id = [], []
    prior_min = inf.clone()
    for s in range(1, window + 1):
        d2s = ((xs[s:] - xs[:-s]) ** 2 + (ys[s:] - ys[:-s]) ** 2
               + (zs[s:] - zs[:-s]) ** 2)
        pad = inf[:s]
        fwd = torch.cat([d2s, pad])
        bwd = torch.cat([pad, d2s])
        fwd_ok = torch.cat([val_s[s:], torch.zeros(s, dtype=torch.bool,
                                                   device=dev)])
        bwd_ok = torch.cat([torch.zeros(s, dtype=torch.bool, device=dev),
                            val_s[:-s]])
        fwd_d2 = torch.where(fwd_ok, fwd, inf)
        bwd_d2 = torch.where(bwd_ok, bwd, inf)
        fwd_prio = torch.cat([prio_s[s:], neg1[:s]])
        bwd_prio = torch.cat([neg1[:s], prio_s[:-s]])
        nbr_d2 += [fwd_d2, bwd_d2]
        nbr_id += [torch.where(fwd_ok, fwd_prio, neg1),
                   torch.where(bwd_ok, bwd_prio, neg1)]
        prior_min = torch.minimum(prior_min, torch.where(
            fwd_prio < prio_s, fwd_d2, inf))
        prior_min = torch.minimum(prior_min, torch.where(
            bwd_prio < prio_s, bwd_d2, inf))
    stack = torch.stack(nbr_d2, 1)
    ids = torch.stack(nbr_id, 1)
    srt = torch.sort(stack, dim=1, stable=True)
    top = srt.values[:, :k]
    top_id = torch.gather(ids, 1, srt.indices)[:, :k]
    out_top = torch.empty_like(top)
    out_id = torch.empty_like(top_id)
    out_prior = torch.empty_like(prior_min)
    out_top[prio_s] = top
    out_id[prio_s] = top_id
    out_prior[prio_s] = prior_min
    return out_top, out_id, out_prior


def morton_window_nn(cand, cand_mask, existing, ex_mask, radius: float,
                     k: int = 3, window: int = 16):
    """Fused approximate radius dedup + kNN scale init for map growth: all
    points (existing + candidates) sorted by two Morton orders, each
    compared with its +-window neighbours. Returns (keep, mean_sq_knn) for
    the candidate rows (same rules as the JAX version)."""
    na = existing.shape[0]
    pts = torch.cat([existing, cand], 0).to(torch.float32)
    valid = torch.cat([ex_mask.bool(), cand_mask.bool()])
    code_a = morton_codes(pts, valid)
    top_a, id_a, prior_a = _window_pass(pts, valid, code_a, window, k)
    code_b = morton_codes(pts[:, (2, 0, 1)], valid, offset=0.5)
    top_b, id_b, prior_b = _window_pass(pts, valid, code_b, window, k)

    d2 = torch.cat([top_a, top_b], 1)
    ids = torch.cat([id_a, id_b], 1)
    # Sort by (d2, id): id first (stable), then d2 (stable).
    o1 = torch.sort(ids, dim=1, stable=True).indices
    d2, ids = torch.gather(d2, 1, o1), torch.gather(ids, 1, o1)
    o2 = torch.sort(d2, dim=1, stable=True).indices
    merged, mids = torch.gather(d2, 1, o2), torch.gather(ids, 1, o2)
    dup = torch.cat([torch.zeros((merged.shape[0], 1), dtype=torch.bool,
                                 device=merged.device),
                     (merged[:, 1:] == merged[:, :-1])
                     & (mids[:, 1:] == mids[:, :-1])], 1)
    merged = torch.where(dup, torch.full_like(merged, _INF), merged)
    top = torch.sort(merged, dim=1).values[:, :k]
    knn_mean = torch.where(top >= _INF * 0.5, torch.zeros_like(top),
                           top).mean(1)
    prior_min = torch.minimum(prior_a, prior_b)
    keep = cand_mask.bool() & (prior_min[na:] > radius * radius)
    mean_d2 = torch.where(cand_mask.bool(), torch.clamp(knn_mean[na:],
                                                        min=1e-8),
                          torch.full_like(knn_mean[na:], 1e-8))
    return keep, mean_d2


def statistical_inlier_mask(pts, mask, nb: int = 20, std_ratio: float = 2.0,
                            chunk: int = 1024):
    """Inlier iff the mean distance to `nb` neighbours is below
    mean + std_ratio * std (Open3D remove_statistical_outlier)."""
    d2 = _chunked_topk(pts, mask, pts, mask, nb, chunk, exclude_self_offset=0)
    d = torch.sqrt(torch.where(d2 >= _INF * 0.5, torch.zeros_like(d2),
                               d2)).mean(-1)
    w = mask.to(torch.float32)
    cnt = torch.clamp(w.sum(), min=1.0)
    mean = (d * w).sum() / cnt
    var = (w * (d - mean) ** 2).sum() / cnt
    return mask & (d < mean + std_ratio * torch.sqrt(var))
