"""Mesh extraction, cleaning and 3D reconstruction metrics (port of
eags_slam_tpu.evaluation.mesh).

- `surface_nets` extracts the mesh from a TSDF grid on the grid's device:
  one vertex per sign-change cell at the mean of its edge zero-crossings
  (placed in float64, as numpy places it), quads across sign-change edges
  split into two triangles. Cells and faces come out in the JAX package's
  order (`torch.nonzero` enumerates as `np.argwhere` does), so the mesh is
  the same mesh. Vertices and faces are returned as host numpy.
- `clean_mesh` (scipy connected components), `save_ply` / `load_ply` and
  `sample_surface` (numpy `default_rng`) are host numpy, copied as they are.
- `mesh_metrics` (accuracy / completion / F-score at tau) measures
  distances with the port's `ops.knn.nearest_sq_dist` on `device`.
- `unseen_depth_l1` renders both surfaces into random virtual views as
  point-splat z-buffers, a batch of views at a time, each a scatter-min on
  `device` (`_zbuffer_batch`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# Corner offsets of the 12 cell edges, in the JAX package's order.
_EDGES = (
    ((0, 0, 0), (1, 0, 0)), ((0, 1, 0), (1, 1, 0)),
    ((0, 0, 1), (1, 0, 1)), ((0, 1, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0)), ((1, 0, 0), (1, 1, 0)),
    ((0, 0, 1), (0, 1, 1)), ((1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1)), ((1, 0, 0), (1, 0, 1)),
    ((0, 1, 0), (0, 1, 1)), ((1, 1, 0), (1, 1, 1)),
)


def _corner(t: torch.Tensor, c) -> torch.Tensor:
    """The (X-1, Y-1, Z-1) view of `t` at corner offset c of each cell."""
    X, Y, Z = t.shape
    return t[c[0]:X - 1 + c[0], c[1]:Y - 1 + c[1], c[2]:Z - 1 + c[2]]


@torch.no_grad()
def surface_nets(sdf, weight, origin, voxel: float, min_weight: float = 1.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) f64, faces (F, 3) int64) of a TSDF grid's zero set.

    `sdf` and `weight` (X, Y, Z) are tensors (the work runs on their
    device) or numpy arrays (run on the CPU). A voxel counts as observed
    when its weight is at least `min_weight`; a cell is active when its 8
    corners are observed and their sdf changes sign (min <= 0 < max)."""
    s = torch.as_tensor(sdf)
    w = torch.as_tensor(weight, device=s.device)
    dev = s.device
    # The origin's own precision, widened to float64 as numpy widens it.
    origin = torch.as_tensor(np.asarray(
        origin.cpu() if torch.is_tensor(origin) else origin)).to(
            dev, torch.float64)
    voxel = float(voxel)
    obs = (w >= min_weight) & torch.isfinite(s)

    smin = smax = None
    all_obs = None
    for c in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
              (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)):
        sc, oc = _corner(s, c), _corner(obs, c)
        if smin is None:
            smin, smax, all_obs = sc.clone(), sc.clone(), oc.clone()
        else:
            torch.minimum(smin, sc, out=smin)
            torch.maximum(smax, sc, out=smax)
            all_obs &= oc
    active = all_obs & (smin <= 0) & (smax > 0)
    del smin, smax, all_obs
    idx = torch.nonzero(active)                       # (N, 3) row-major
    n = idx.shape[0]
    if n == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    cell_id = torch.full(active.shape, -1, dtype=torch.int32, device=dev)
    cell_id[active] = torch.arange(n, dtype=torch.int32, device=dev)
    del active

    # A vertex per active cell: the mean of its edges' zero crossings. The
    # crossing parameter is float32 (numpy's, on float32 sdf), the sum
    # float64.
    acc = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    cnt = torch.zeros((n,), dtype=torch.float64, device=dev)
    for a, b in _EDGES:
        va = s[idx[:, 0] + a[0], idx[:, 1] + a[1], idx[:, 2] + a[2]]
        vb = s[idx[:, 0] + b[0], idx[:, 1] + b[1], idx[:, 2] + b[2]]
        cross = (va <= 0) != (vb <= 0)
        den = va - vb
        den = torch.where(torch.abs(den) < 1e-12,
                          torch.full_like(den, 1e-12), den)
        t = torch.where(cross, va / den, torch.zeros_like(va))
        pa = idx + torch.tensor(a, device=dev)
        pb = idx + torch.tensor(b, device=dev)
        pt = pa + t.double()[:, None] * (pb - pa)
        acc += torch.where(cross[:, None], pt, torch.zeros_like(pt))
        cnt += cross
    verts = origin + voxel * (
        acc / torch.clamp(cnt, min=1)[:, None])
    del acc, cnt

    # Faces: for each axis, a quad between the 4 cells around each
    # sign-changing grid edge, in the orientation of the edge's sign.
    shape = torch.tensor(cell_id.shape, device=dev)
    faces = []
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, s.shape[axis] - 1)
        hi[axis] = slice(1, s.shape[axis])
        a_vals, b_vals = s[tuple(lo)], s[tuple(hi)]
        cross = (obs[tuple(lo)] & obs[tuple(hi)]
                 & ((a_vals <= 0) != (b_vals <= 0)))
        eidx = torch.nonzero(cross)
        del cross
        if eidx.shape[0] == 0:
            continue
        flips = a_vals[eidx[:, 0], eidx[:, 1], eidx[:, 2]] > 0
        o1, o2 = [(1, 2), (0, 2), (0, 1)][axis]
        ncell = torch.empty((eidx.shape[0], 4), dtype=torch.int64,
                            device=dev)
        ok = torch.ones(eidx.shape[0], dtype=torch.bool, device=dev)
        for k, (da, db) in enumerate(((0, 0), (1, 0), (1, 1), (0, 1))):
            cc = eidx.clone()
            cc[:, o1] -= da
            cc[:, o2] -= db
            inb = (cc >= 0).all(1) & (cc < shape[None, :]).all(1)
            cc = torch.minimum(torch.clamp(cc, min=0), shape[None, :] - 1)
            cid = cell_id[cc[:, 0], cc[:, 1], cc[:, 2]].long()
            ok &= inb & (cid >= 0)
            ncell[:, k] = cid
        ncell = torch.where(flips[:, None], ncell.flip(1), ncell)[ok]
        if ncell.shape[0]:
            faces.append(ncell[:, [0, 1, 2]])
            faces.append(ncell[:, [0, 2, 3]])
    faces = (torch.cat(faces).cpu().numpy() if faces
             else np.zeros((0, 3), np.int64))
    return verts.cpu().numpy(), faces


def clean_mesh(verts: np.ndarray, faces: np.ndarray, min_faces: int = 200
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop connected components with fewer than `min_faces` triangles
    (host numpy and scipy)."""
    if faces.shape[0] == 0:
        return verts, faces
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    n = verts.shape[0]
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = sp.coo_matrix((np.ones_like(rows), (rows, cols)), shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    face_labels = labels[faces[:, 0]]
    keep_labels = {
        lab for lab in np.unique(face_labels)
        if (face_labels == lab).sum() >= min_faces
    }
    keep = np.isin(face_labels, list(keep_labels))
    faces = faces[keep]
    used = np.unique(faces)
    remap = -np.ones(n, np.int64)
    remap[used] = np.arange(used.shape[0])
    return verts[used], remap[faces]


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        np.savetxt(f, verts, fmt="%.5f %.5f %.5f")
        if len(faces):
            np.savetxt(
                f,
                np.concatenate(
                    [np.full((len(faces), 1), 3, np.int64), faces], axis=1),
                fmt="%d %d %d %d",
            )


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path) as f:
        n_v = n_f = 0
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line == "end_header":
                break
        for _ in range(n_v):
            verts.append([float(x) for x in next(f).split()[:3]])
        for _ in range(n_f):
            parts = next(f).split()
            faces.append([int(x) for x in parts[1:4]])
    return np.asarray(verts), np.asarray(faces, np.int64)


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface samples (host numpy)."""
    if faces.shape[0] == 0:
        return verts[:0]
    rng = np.random.default_rng(seed)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    p = area / max(area.sum(), 1e-12)
    tri = rng.choice(len(faces), n, p=p)
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    return (1 - r1) * a[tri] + r1 * (1 - r2) * b[tri] + r1 * r2 * c[tri]


def mesh_metrics(pred_pts: np.ndarray, gt_pts: np.ndarray,
                 tau: float = 0.01, device="cuda") -> Dict[str, float]:
    """Accuracy / completion / F-score at threshold tau; the nearest
    distances in float32 on `device`."""
    from ..ops.knn import nearest_sq_dist

    def nn_dist(a, b):
        qa = torch.as_tensor(np.asarray(a, np.float32), device=device)
        rb = torch.as_tensor(np.asarray(b, np.float32), device=device)
        d2 = nearest_sq_dist(
            qa, torch.ones(len(a), dtype=torch.bool, device=device),
            rb, torch.ones(len(b), dtype=torch.bool, device=device))
        return np.sqrt(d2.cpu().numpy())

    d_pred_gt = nn_dist(pred_pts, gt_pts)   # accuracy distances
    d_gt_pred = nn_dist(gt_pts, pred_pts)   # completion distances
    precision = float((d_pred_gt < tau).mean())
    recall = float((d_gt_pred < tau).mean())
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "accuracy": float(d_pred_gt.mean()),
        "completion": float(d_gt_pred.mean()),
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }


# ---------------------------------------------------------------------------
# Unseen-view depth L1 (reference evaluate_reconstruction.py:97-197)
# ---------------------------------------------------------------------------


@torch.no_grad()
def _zbuffer_batch(points, c2ws, res: int, focal: float, device="cuda"):
    """Point-splat z-buffers of `points` (N, 3) seen from each of `c2ws`
    (V, 4, 4): a (V, res, res) float32 tensor on `device` (0 = empty),
    every view one scatter-min into a res*res + 1 buffer whose last cell
    takes the points that miss the view."""
    cx = cy = res / 2.0 - 0.5
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    w2cs = torch.linalg.inv(torch.as_tensor(np.asarray(c2ws, np.float32),
                                            device=device))
    nv, npix = w2cs.shape[0], res * res + 1
    p = torch.einsum("nj,vij->vni", pts, w2cs[:, :3, :3]) \
        + w2cs[:, None, :3, 3]
    z = p[..., 2]
    zc = torch.clamp(z, min=1e-6)
    u = torch.round(p[..., 0] / zc * focal + cx)
    v = torch.round(p[..., 1] / zc * focal + cy)
    ok = (z > 0.05) & (u >= 0) & (u < res) & (v >= 0) & (v < res)
    pix = torch.where(ok, (v * res + u).long(),
                      torch.full_like(z, res * res, dtype=torch.long))
    pix = pix + npix * torch.arange(nv, device=device)[:, None]
    zb = torch.full((nv * npix,), float("inf"), device=device)
    zb.scatter_reduce_(0, pix.reshape(-1),
                       torch.where(ok, z, torch.full_like(z, float("inf")))
                       .reshape(-1), reduce="amin")
    zb = zb.reshape(nv, npix)[:, :-1].reshape(nv, res, res)
    return torch.where(torch.isfinite(zb), zb, torch.zeros_like(zb))


def _viewmatrix(target: np.ndarray, up: np.ndarray, origin: np.ndarray):
    z = target / max(np.linalg.norm(target), 1e-9)
    x = np.cross(up, z)
    x = x / max(np.linalg.norm(x), 1e-9)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, origin
    return c2w


def unseen_depth_l1(pred_pts: np.ndarray, gt_pts: np.ndarray,
                    n_views: int = 1000, res: int = 128,
                    seed: int = 0, batch: int = 100,
                    device="cuda") -> float:
    """Depth L1 (cm) over random virtual views of the predicted against
    the GT surface: camera origins uniform in the shrunk GT box, random
    look-at directions, z-up; per view the mean |gt - pred| over pixels
    where both z-buffers have depth; the mean over views, times 100.
    Surfaces are point-splat z-buffers at `res`^2 (the JAX package's
    deviation from the reference's mesh renders)."""
    rng = np.random.default_rng(seed)
    lo = np.percentile(gt_pts, 5, axis=0)
    hi = np.percentile(gt_pts, 95, axis=0)
    center, half = (lo + hi) / 2, (hi - lo) / 2 * 0.6
    focal = 0.6 * res  # fov ~80deg, like the reference's 300/500

    errs = []
    for b0 in range(0, n_views, batch):
        nb = min(batch, n_views - b0)
        origins = center + rng.uniform(-1, 1, (nb, 3)) * half
        targets = rng.normal(size=(nb, 3))
        c2ws = np.stack([
            _viewmatrix(t, np.array([0.0, 0.0, -1.0]), o)
            for t, o in zip(targets, origins)
        ])
        d_pred = _zbuffer_batch(pred_pts, c2ws, res, focal, device)
        d_gt = _zbuffer_batch(gt_pts, c2ws, res, focal, device)
        m = (d_pred > 0) & (d_gt > 0)
        n_m = m.sum((1, 2))
        tot = torch.where(m, torch.abs(d_gt - d_pred),
                          torch.zeros_like(d_gt)).sum((1, 2))
        err = (tot / torch.clamp(n_m, min=1)).cpu().numpy()
        errs.extend(float(e) for e in err[n_m.cpu().numpy() > 0])
    return float(np.mean(errs) * 100.0) if errs else float("nan")
