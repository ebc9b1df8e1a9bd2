"""Differentiable tile-binned 3D Gaussian splat rasterizer (port of
eags_slam_tpu.ops.rasterizer): the `sorted` backend, the entry-binned
`pallas` backend and the dense `jnp` backend.

Pipeline of the sorted backend:
  1. EWA projection (`project_gaussians`): 3D covariance R S S^T R^T to a 2D
     conic through the perspective Jacobian, 0.3 px low-pass, near plane,
     opacity-aware footprint radius capped to the +-r_n tile neighbourhood.
  2. Centre-tile sort (`_center_sort`): gaussians sorted by (centre tile,
     depth bits); each tile's `bands` neighbouring tile-row segments come
     from searchsorted, clipped to `seg_cap` lanes from the 128-aligned start.
  3. Compositing: `ops.composite_sorted` (the K1 and K2 CUDA kernels on the
     card, K3 for the backward with `rmw_window`, their plain twins on the
     CPU).

The `pallas` backend (named after the JAX package's v1 Pallas kernel; here
K5 / K6) bins per entry instead: each gaussian goes to each of the up to
dup_side^2 tiles its radius box covers (`_bin_entries`), the entries are
sorted by (tile, depth), cut to the entry budget and laid out in 128-aligned
per-tile segments (`_build_slots`), gathered attr-major (`_gather_entries`)
and composited by `ops.composite_entries`. Its tracking path freezes the
binning at the init pose (`freeze_binning`, `render_frozen`).

The `jnp` backend (named after the JAX package's plain-XLA compositor; it
has no kernel there either) bins as `pallas` does into a fixed-capacity
tile table (`_build_tile_table`: the first `tile_capacity` entries of each
tile in depth order, sentinel index N in the empty slots) and composites
it in plain PyTorch (`_composite_dense`): every tile at once, `chunk`
gaussians a step, log-space transmittance, each step under
`torch.utils.checkpoint` so that the backward keeps one chunk's
intermediates at a time. It runs only when a config asks for it; `auto`
is the sorted backend on every device.

The frozen-sorted tracking render also has a pose-contraction backward
(`render_frozen_sorted(_tiles)_pose`): the gradient w.r.t. the 7 relative
pose parameters comes from K4, which contracts the replay's per-entry
grads with per-gaussian pose jacobians instead of writing a (16, Npad)
grad array and running autograd through the reprojection.

Gradients reach every array input (means, quats, scales, opacity, colours
and the pose) through PyTorch autograd; the column gather of `_sorted_attrs`
is plain indexing, whose backward is a scatter-add.

`kernel_quadform` and `kernel_bf16` pick the variant of K1-K4 on every
sorted path (render, tiles, resident, frozen and its K4 backward;
`ops.composite_sorted`); the `pallas` backend's K5 / K6 have no such
variants, as in the JAX package. `tile_capacity`, `chunk` and `alpha_max`
configure the `jnp` backend only (the kernels clip alpha at the fixed
`ALPHA_MAX` and take 128-entry chunks). `group` bounds the run of tiles a
K3 cluster replays (`window_run`).
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from ..core.camera import Camera
from . import composite_sorted as _cs
from .composite_entries import composite_entries, gather_entries_bwd
from .composite_sorted import (NCH, P_MAX, PJ, composite_sorted,
                               composite_sorted_fwd, pose_grad_sorted,
                               to_bf16_layout)


class RasterConfig(NamedTuple):
    tile: int = 16            # square tile side in pixels
    dup_side: int = 4         # pallas / jnp: <= dup_side^2 tiles a gaussian
    tile_capacity: int = 1024  # jnp: gaussians composited per tile at most
    chunk: int = 64           # jnp: gaussians per compositing step
    near: float = 0.2         # z culling plane
    alpha_min: float = 1.0 / 255.0
    alpha_max: float = 0.99   # jnp: alpha clip (the kernels' ALPHA_MAX)
    sigma_clip: float = 3.0   # radius = sigma_clip * sqrt(lambda_max)
    low_pass: float = 0.3     # 2D covariance dilation (3DGS convention)
    backend: str = "sorted"   # sorted | pallas | jnp (auto == sorted)
    max_per_tile: int = 8192  # pallas: entries composited per tile at most
    group: int = 16           # sorted with rmw_window: tiles per K3 block
    entry_cap_factor: int = 4  # pallas: total entry budget = factor * N
    seg_cap: int = 1024       # per-band segment capacity
    bands: int = 3            # centre-tile neighbourhood side
    kernel_bf16: bool = False  # sorted: K1-K4 read the bf16 attr layout
    kernel_quadform: bool = False  # sorted: expanded-form Gaussian power
    rmw_window: bool = False  # sorted backward through K3


def apply_rcfg_env(cfg: RasterConfig) -> RasterConfig:
    """Return cfg with the `EAGS_RCFG` comma-separated overrides applied
    (e.g. EAGS_RCFG="backend=pallas,max_per_tile=4096"). Keys are
    RasterConfig fields, values parse by the field's current type, and an
    unknown key raises."""
    spec = os.environ.get("EAGS_RCFG", "").strip()
    if not spec:
        return cfg
    kv = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in cfg._fields:
            raise KeyError(f"EAGS_RCFG: unknown RasterConfig field {k!r}")
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kv[k] = v.strip().lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            kv[k] = int(v)
        elif isinstance(cur, float):
            kv[k] = float(v)
        else:
            kv[k] = v.strip()
    print(f"EAGS_RCFG overrides: {kv}")
    return cfg._replace(**kv)


def backend_of(cfg: RasterConfig) -> str:
    """The backend a config runs: `auto` is the sorted backend."""
    return "sorted" if cfg.backend == "auto" else cfg.backend


BACKENDS = ("sorted", "pallas", "jnp")


def check_config(cfg: RasterConfig) -> None:
    """Raise for a backend name that is none of BACKENDS (or `auto`)."""
    if backend_of(cfg) not in BACKENDS:
        raise ValueError(f"RasterConfig.backend={cfg.backend!r}: not one of "
                         f"{BACKENDS + ('auto',)}")


class RenderOutput(NamedTuple):
    color: torch.Tensor   # (H, W, 3)
    depth: torch.Tensor   # (H, W)
    alpha: torch.Tensor   # (H, W)
    radii: torch.Tensor   # (N,) int32, 0 for culled gaussians


class TileRender(NamedTuple):
    color: torch.Tensor   # (S, ts, ts, 3)
    depth: torch.Tensor   # (S, ts, ts)
    alpha: torch.Tensor   # (S, ts, ts)


class _Projected(NamedTuple):
    mean2d: torch.Tensor  # (N, 2)
    conic: torch.Tensor   # (N, 3)
    depth: torch.Tensor   # (N,)
    radius: torch.Tensor  # (N,) float, 0 for culled
    opacity: torch.Tensor  # (N,) post-sigmoid


def _tiles(cam: Camera, cfg: RasterConfig):
    tiles_x = -(-cam.width // cfg.tile)
    tiles_y = -(-cam.height // cfg.tile)
    return tiles_x, tiles_y


def _quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def small_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` (batch axes broadcast) for a small inner size, a pose's 3
    or 4: a sum of broadcast products in a fixed order, forward and
    backward with no cuBLAS call, so that the tracker's CUDA graph, which
    captures on a side stream, takes no cuBLAS workspace of its own."""
    out = a[..., :, :1] * b[..., :1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def _v2_radius_cap(cfg: RasterConfig) -> float:
    """A gaussian centred in tile c with radius <= r_n * tile cannot cover
    a tile outside [c - r_n, c + r_n]."""
    return ((cfg.bands - 1) // 2) * cfg.tile - 1.0


def project_gaussians(means3d, quats, log_scales, opacity_logits, w2c,
                      cam: Camera, cfg: RasterConfig, alive=None,
                      radius_cap: Optional[float] = None) -> _Projected:
    """EWA projection of 3D gaussians to image-space conics."""
    R_cw = w2c[:3, :3]
    t_cw = w2c[:3, 3]
    p_cam = means3d @ R_cw.T + t_cw
    z = p_cam[..., 2]
    in_front = z > cfg.near
    zc = torch.clamp(z, min=cfg.near)
    inv_z = 1.0 / zc
    u = p_cam[..., 0] * inv_z * cam.fx + cam.cx
    v = p_cam[..., 1] * inv_z * cam.fy + cam.cy
    mean2d = torch.stack([u, v], dim=-1)

    S = torch.exp(log_scales)
    Rg = _quat_to_rotmat(quats)
    M = Rg * S[..., None, :]
    A = torch.einsum("ij,njk->nik", R_cw, M)

    lim_x = 1.3 * (0.5 * cam.width / cam.fx)
    lim_y = 1.3 * (0.5 * cam.height / cam.fy)
    tx = torch.clamp(p_cam[..., 0] * inv_z, -lim_x, lim_x) * zc
    ty = torch.clamp(p_cam[..., 1] * inv_z, -lim_y, lim_y) * zc
    j00 = cam.fx * inv_z
    j02 = -cam.fx * tx * inv_z * inv_z
    j11 = cam.fy * inv_z
    j12 = -cam.fy * ty * inv_z * inv_z
    b0 = j00[:, None] * A[:, 0, :] + j02[:, None] * A[:, 2, :]
    b1 = j11[:, None] * A[:, 1, :] + j12[:, None] * A[:, 2, :]
    a = torch.sum(b0 * b0, dim=-1) + cfg.low_pass
    b = torch.sum(b0 * b1, dim=-1)
    c = torch.sum(b1 * b1, dim=-1) + cfg.low_pass
    det = torch.clamp(a * c - b * b, min=1e-12)
    inv_det = 1.0 / det
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    opacity = torch.sigmoid(opacity_logits.reshape(-1))
    # Opacity-aware exact footprint (beyond r_cut every compositor zeroes
    # alpha, value and gradient); the 1/255 floor matches the kernels.
    a_min = min(float(cfg.alpha_min), 1.0 / 255.0)
    r_cut = torch.sqrt(2.0 * torch.log(torch.clamp(opacity / a_min,
                                                   min=1.0 + 1e-6)))
    radius = torch.clamp(r_cut, max=cfg.sigma_clip) * torch.sqrt(lam_max)
    if radius_cap is None:
        radius_cap = 0.5 * cfg.dup_side * cfg.tile - 1.0
    radius = torch.clamp(radius, max=radius_cap)
    visible = (in_front
               & (u + radius > 0) & (u - radius < cam.width)
               & (v + radius > 0) & (v - radius < cam.height)
               & (opacity > cfg.alpha_min))
    if alive is not None:
        visible = visible & alive
    radius = torch.where(visible, radius, torch.zeros_like(radius))
    return _Projected(mean2d, conic, z, radius, opacity)


def _center_sort(proj: _Projected, cam: Camera, cfg: RasterConfig):
    """Sort gaussians by (centre tile, depth); per-(tile, band) segments.
    Returns (order (N,) i64, seg_start (T, B) i32, seg_cnt (T, B) i32)."""
    n = proj.mean2d.shape[0]
    dev = proj.mean2d.device
    tiles_x, tiles_y = _tiles(cam, cfg)
    num_tiles = tiles_x * tiles_y
    bands = cfg.bands
    r_n = (bands - 1) // 2
    with torch.no_grad():
        u, v = proj.mean2d[:, 0], proj.mean2d[:, 1]
        ctx = torch.clamp(torch.floor(u / cfg.tile), 0, tiles_x - 1).long()
        cty = torch.clamp(torch.floor(v / cfg.tile), 0, tiles_y - 1).long()
        ct = torch.where(proj.radius > 0, cty * tiles_x + ctx,
                         torch.full_like(ctx, num_tiles))
        dbits = torch.clamp(proj.depth, min=1e-6).view(torch.int32).long()
        s_key, order = torch.sort(ct * (1 << 32) + dbits, stable=True)
        s_ct = s_key >> 32

        t = torch.arange(num_tiles, device=dev)
        tx = t % tiles_x
        ty = t // tiles_x
        rows = ty[:, None] + torch.arange(bands, device=dev)[None, :] - r_n
        row_ok = (rows >= 0) & (rows < tiles_y)
        rows_c = torch.clamp(rows, 0, tiles_y - 1)
        c_lo = rows_c * tiles_x + torch.clamp(tx[:, None] - r_n, 0,
                                              tiles_x - 1)
        c_hi = rows_c * tiles_x + torch.clamp(tx[:, None] + r_n, 0,
                                              tiles_x - 1)
        start = torch.searchsorted(s_ct, c_lo.reshape(-1)).reshape(
            num_tiles, bands)
        end = torch.searchsorted(s_ct, c_hi.reshape(-1) + 1).reshape(
            num_tiles, bands)
        cnt = torch.where(row_ok, end - start, torch.zeros_like(start))
        # The kernel reads seg_cap lanes from the 128-aligned start;
        # entries past that window are dropped.
        lead = start % 128
        cnt = torch.minimum(cnt, cfg.seg_cap - lead)
    return order, start.to(torch.int32), cnt.to(torch.int32)


def _pad_sorted(attrs_sorted: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """Pad (NCH, N) to (NCH, Npad) so any aligned band window stays in
    bounds; pad columns have radius 0 and are never covered."""
    n = attrs_sorted.shape[1]
    n128 = -(-n // 128) * 128
    return torch.nn.functional.pad(attrs_sorted, (0, n128 + cfg.seg_cap - n))


def _stack_attrs(proj: _Projected, colors: torch.Tensor) -> torch.Tensor:
    n = proj.mean2d.shape[0]
    zeros = torch.zeros((NCH - 11, n), dtype=torch.float32,
                        device=colors.device)
    return torch.cat([
        torch.stack([proj.mean2d[:, 0], proj.mean2d[:, 1],
                     proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
                     proj.opacity, colors[:, 0], colors[:, 1], colors[:, 2],
                     proj.depth, proj.radius.detach()], dim=0),
        zeros,
    ], dim=0)


def _sorted_attrs(proj: _Projected, colors, cam: Camera, cfg: RasterConfig):
    """Sorted attr array + segment table: one N-column gather (its
    backward is a scatter-add)."""
    order, seg_start, seg_cnt = _center_sort(proj, cam, cfg)
    attrs = _stack_attrs(proj, colors)
    return _pad_sorted(attrs[:, order], cfg), seg_start, seg_cnt


def _assemble_image(out, cam: Camera, cfg: RasterConfig):
    tiles_x, tiles_y = _tiles(cam, cfg)
    ts = cfg.tile
    img = out[: tiles_x * tiles_y, :5].reshape(tiles_y, tiles_x, 5, ts, ts)
    img = img.permute(0, 3, 1, 4, 2).reshape(tiles_y * ts, tiles_x * ts, 5)
    return img[..., :3], img[..., 3], img[..., 4]


def _full_image(out, cam: Camera, cfg: RasterConfig, radii):
    color, depth, alpha = _assemble_image(out, cam, cfg)
    return RenderOutput(color[: cam.height, : cam.width],
                        depth[: cam.height, : cam.width],
                        alpha[: cam.height, : cam.width], radii)


def _tile_render(out, s: int, ts: int) -> TileRender:
    img = out[:s, :5].reshape(s, 5, ts, ts)
    return TileRender(color=img[:, 0:3].permute(0, 2, 3, 1),
                      depth=img[:, 3], alpha=img[:, 4])


def _all_tiles(cam: Camera, cfg: RasterConfig, device):
    tiles_x, tiles_y = _tiles(cam, cfg)
    return torch.arange(tiles_x * tiles_y, dtype=torch.int32, device=device)


def _composite(attrs, seg_start, seg_cnt, tile_ids, cam, cfg):
    tiles_x, _ = _tiles(cam, cfg)
    return composite_sorted(attrs, seg_start, seg_cnt, tile_ids, cfg.tile,
                            tiles_x, cfg.bands, cfg.seg_cap, cfg.group,
                            cfg.rmw_window, cfg.kernel_quadform,
                            cfg.kernel_bf16)


def render(means3d, quats, log_scales, opacity_logits, colors, w2c,
           cam: Camera, cfg: RasterConfig = RasterConfig(),
           alive=None) -> RenderOutput:
    """Render gaussians into (color, depth, alpha, radii); differentiable
    w.r.t. every array input including `w2c`."""
    check_config(cfg)
    if backend_of(cfg) == "jnp":
        proj = project_gaussians(means3d, quats, log_scales, opacity_logits,
                                 w2c, cam, cfg, alive)
        table, count = _build_tile_table(proj, cam, cfg)
        color, depth, alpha = _composite_dense(table, count, proj, colors,
                                               cam, cfg)
        return RenderOutput(color[: cam.height, : cam.width],
                            depth[: cam.height, : cam.width],
                            alpha[: cam.height, : cam.width],
                            torch.ceil(proj.radius.detach()).to(torch.int32))
    if backend_of(cfg) == "pallas":
        proj = project_gaussians(means3d, quats, log_scales, opacity_logits,
                                 w2c, cam, cfg, alive)
        out = _composite_pallas(proj, colors, cam, cfg)
    else:
        proj = project_gaussians(means3d, quats, log_scales, opacity_logits,
                                 w2c, cam, cfg, alive,
                                 radius_cap=_v2_radius_cap(cfg))
        attrs, seg_start, seg_cnt = _sorted_attrs(proj, colors, cam, cfg)
        out = _composite(attrs, seg_start, seg_cnt,
                         _all_tiles(cam, cfg, attrs.device), cam, cfg)
    return _full_image(out, cam, cfg,
                       torch.ceil(proj.radius.detach()).to(torch.int32))


def sorted_layout(means3d, quats, log_scales, opacity_logits, w2c,
                  cam: Camera, cfg: RasterConfig, alive=None):
    """Centre-tile layout (order, seg_start, seg_cnt) of the current row
    order for pose `w2c` (resident-sorted mapping)."""
    with torch.no_grad():
        proj = project_gaussians(means3d, quats, log_scales, opacity_logits,
                                 w2c, cam, cfg, alive,
                                 radius_cap=_v2_radius_cap(cfg))
        return _center_sort(proj, cam, cfg)


def _resident_attrs(means3d, quats, log_scales, opacity_logits, colors, w2c,
                    cam: Camera, cfg: RasterConfig, alive):
    """Projection + attr stack for rows ALREADY in `sorted_layout` order."""
    proj = project_gaussians(means3d, quats, log_scales, opacity_logits,
                             w2c, cam, cfg, alive,
                             radius_cap=_v2_radius_cap(cfg))
    return proj, _pad_sorted(_stack_attrs(proj, colors), cfg)


def render_sorted_resident(means3d, quats, log_scales, opacity_logits, colors,
                           w2c, seg_start, seg_cnt, cam: Camera,
                           cfg: RasterConfig, alive=None) -> RenderOutput:
    """Render gaussians stored in centre-tile-sorted order for `w2c`
    (segment membership frozen; a centre that drifts outside its +-r_n
    neighbourhood within a block is clipped, as in the JAX version)."""
    check_config(cfg)
    proj, attrs = _resident_attrs(means3d, quats, log_scales, opacity_logits,
                                  colors, w2c, cam, cfg, alive)
    out = _composite(attrs, seg_start, seg_cnt,
                     _all_tiles(cam, cfg, attrs.device), cam, cfg)
    return _full_image(out, cam, cfg,
                       torch.ceil(proj.radius.detach()).to(torch.int32))


def render_sorted_resident_tiles(means3d, quats, log_scales, opacity_logits,
                                 colors, w2c, seg_start, seg_cnt, tile_ids,
                                 cam: Camera, cfg: RasterConfig,
                                 alive=None) -> TileRender:
    """Tile-subset variant of `render_sorted_resident`."""
    check_config(cfg)
    _, attrs = _resident_attrs(means3d, quats, log_scales, opacity_logits,
                               colors, w2c, cam, cfg, alive)
    out = _composite(attrs, seg_start, seg_cnt, tile_ids, cam, cfg)
    return _tile_render(out, tile_ids.shape[0], cfg.tile)


class FrozenSorted(NamedTuple):
    """Centre-tile-sorted per-gaussian 3D attrs + frozen segment table.
    e3d rows: 0-2 xyz (world), 3-8 cov3d packed, 9 opacity (0 for dead),
    10-12 rgb, 13-15 zero. Constant (no gradient)."""

    e3d: torch.Tensor        # (NCH, Npad)
    seg_start: torch.Tensor  # (T, B)
    seg_cnt: torch.Tensor    # (T, B)


@torch.no_grad()
def freeze_sorted(means3d, quats, log_scales, opacity_logits, colors,
                  init_w2c, cam: Camera, cfg: RasterConfig,
                  alive=None) -> FrozenSorted:
    """Centre-sort once at the init pose; gather 3D attrs into that order."""
    proj = project_gaussians(means3d, quats, log_scales, opacity_logits,
                             init_w2c, cam, cfg, alive,
                             radius_cap=_v2_radius_cap(cfg))
    order, seg_start, seg_cnt = _center_sort(proj, cam, cfg)
    attrs = _rows3d(means3d, quats, log_scales, colors, proj)
    return FrozenSorted(_pad_sorted(attrs[:, order], cfg).contiguous(),
                        seg_start, seg_cnt)


def _rows3d(means3d, quats, log_scales, colors, proj: _Projected):
    """(NCH, N) frozen 3D rows: xyz, packed world covariance, opacity (0
    where culled at the init pose), rgb."""
    n = means3d.shape[0]
    S = torch.exp(log_scales)
    M = _quat_to_rotmat(quats) * S[..., None, :]
    c00 = torch.sum(M[:, 0] * M[:, 0], -1)
    c01 = torch.sum(M[:, 0] * M[:, 1], -1)
    c02 = torch.sum(M[:, 0] * M[:, 2], -1)
    c11 = torch.sum(M[:, 1] * M[:, 1], -1)
    c12 = torch.sum(M[:, 1] * M[:, 2], -1)
    c22 = torch.sum(M[:, 2] * M[:, 2], -1)
    opac = proj.opacity * (proj.radius > 0)
    return torch.cat([
        torch.stack([means3d[:, 0], means3d[:, 1], means3d[:, 2],
                     c00, c01, c02, c11, c12, c22, opac,
                     colors[:, 0], colors[:, 1], colors[:, 2]], 0),
        torch.zeros((NCH - 13, n), dtype=torch.float32, device=means3d.device),
    ], 0)


def _reproject_rows(e3d, w2c, cam: Camera, cfg: RasterConfig,
                    radius_cap: Optional[float] = None):
    """Elementwise EWA reprojection of packed 3D rows under a new pose.
    Returns the kernel channel rows [u, v, conic a/b/c, opacity, rgb, depth,
    radius]."""
    R = w2c[:3, :3]
    t = w2c[:3, 3]
    p = small_matmul(R, e3d[0:3]) + t[:, None]
    z = p[2]
    vis = z > cfg.near
    zc = torch.clamp(z, min=cfg.near)
    inv_z = 1.0 / zc
    u = p[0] * inv_z * cam.fx + cam.cx
    v = p[1] * inv_z * cam.fy + cam.cy
    s00, s01, s02, s11, s12, s22 = (e3d[3], e3d[4], e3d[5],
                                    e3d[6], e3d[7], e3d[8])

    def sandwich_row(ri, rj):
        return (ri[0] * (s00 * rj[0] + s01 * rj[1] + s02 * rj[2])
                + ri[1] * (s01 * rj[0] + s11 * rj[1] + s12 * rj[2])
                + ri[2] * (s02 * rj[0] + s12 * rj[1] + s22 * rj[2]))

    r0, r1, r2 = R[0], R[1], R[2]
    C00 = sandwich_row(r0, r0)
    C01 = sandwich_row(r0, r1)
    C02 = sandwich_row(r0, r2)
    C11 = sandwich_row(r1, r1)
    C12 = sandwich_row(r1, r2)
    C22 = sandwich_row(r2, r2)
    lim_x = 1.3 * (0.5 * cam.width / cam.fx)
    lim_y = 1.3 * (0.5 * cam.height / cam.fy)
    tx = torch.clamp(p[0] * inv_z, -lim_x, lim_x) * zc
    ty = torch.clamp(p[1] * inv_z, -lim_y, lim_y) * zc
    j00 = cam.fx * inv_z
    j02 = -cam.fx * tx * inv_z * inv_z
    j11 = cam.fy * inv_z
    j12 = -cam.fy * ty * inv_z * inv_z
    a = (j00 * (j00 * C00 + j02 * C02) + j02 * (j00 * C02 + j02 * C22)
         + cfg.low_pass)
    b = j11 * (j00 * C01 + j02 * C12) + j12 * (j00 * C02 + j02 * C22)
    c = (j11 * (j11 * C11 + j12 * C12) + j12 * (j11 * C12 + j12 * C22)
         + cfg.low_pass)
    det = torch.clamp(a * c - b * b, min=1e-12)
    inv_det = 1.0 / det
    opac = e3d[9] * vis
    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    radius = cfg.sigma_clip * torch.sqrt(lam_max)
    if radius_cap is None:
        radius_cap = 0.5 * cfg.dup_side * cfg.tile - 1.0
    radius = torch.clamp(radius, max=radius_cap)
    radius = torch.where(vis & (e3d[9] > 0), radius, torch.zeros_like(radius))
    return [u, v, c * inv_det, -b * inv_det, a * inv_det, opac,
            e3d[10], e3d[11], e3d[12], z, radius.detach()]


def _stack_reproj_rows(e3d, w2c, cam: Camera, cfg: RasterConfig):
    rows = _reproject_rows(e3d, w2c, cam, cfg, radius_cap=_v2_radius_cap(cfg))
    n_pad = e3d.shape[1]
    zeros = torch.zeros((NCH - len(rows), n_pad), dtype=torch.float32,
                        device=e3d.device)
    return torch.cat([torch.stack(rows, 0), zeros], 0)


def render_frozen_sorted_tiles(fs: FrozenSorted, w2c, tile_ids,
                               cam: Camera, cfg: RasterConfig) -> TileRender:
    """Render only `tile_ids` from a frozen sorted layout; differentiable
    w.r.t. `w2c`."""
    check_config(cfg)
    attrs = _stack_reproj_rows(fs.e3d, w2c, cam, cfg)
    out = _composite(attrs, fs.seg_start, fs.seg_cnt, tile_ids, cam, cfg)
    return _tile_render(out, tile_ids.shape[0], cfg.tile)


def render_frozen_sorted(fs: FrozenSorted, w2c, cam: Camera,
                         cfg: RasterConfig) -> RenderOutput:
    """Render from a frozen sorted layout; differentiable w.r.t. `w2c`."""
    check_config(cfg)
    attrs = _stack_reproj_rows(fs.e3d, w2c, cam, cfg)
    out = _composite(attrs, fs.seg_start, fs.seg_cnt,
                     _all_tiles(cam, cfg, attrs.device), cam, cfg)
    return _full_image(out, cam, cfg,
                       torch.zeros(1, dtype=torch.int32, device=attrs.device))


def render_tiles(means3d, quats, log_scales, opacity_logits, colors, w2c,
                 tile_ids, cam: Camera, cfg: RasterConfig,
                 alive=None) -> TileRender:
    """Render only the tiles in `tile_ids` (S,)."""
    check_config(cfg)
    proj = project_gaussians(means3d, quats, log_scales, opacity_logits, w2c,
                             cam, cfg, alive, radius_cap=_v2_radius_cap(cfg))
    attrs, seg_start, seg_cnt = _sorted_attrs(proj, colors, cam, cfg)
    out = _composite(attrs, seg_start, seg_cnt, tile_ids, cam, cfg)
    return _tile_render(out, tile_ids.shape[0], cfg.tile)


# ---------------------------------------------------------------------------
# Entry-binned backend (`pallas`: K5 / K6)
# ---------------------------------------------------------------------------

CHUNK_V1 = 128  # the v1 kernels' chunk and segment alignment


def _bin_entries(proj: _Projected, cam: Camera, cfg: RasterConfig,
                 margin: float = 0.0):
    """Duplicate gaussians into the tiles their radius box covers (at most
    dup_side^2, clipped to the image) and sort the entries by (tile, depth
    bits, entry id). Returns (s_tile, s_gauss, start, count): sorted entry
    tiles and gaussians, N * dup_side^2 long (invalid entries carry tile T
    and sort last), and each tile's segment start / length."""
    tiles_x, tiles_y = _tiles(cam, cfg)
    num_tiles = tiles_x * tiles_y
    d = cfg.dup_side
    dev = proj.mean2d.device
    with torch.no_grad():
        u, v = proj.mean2d[:, 0], proj.mean2d[:, 1]
        r = torch.where(proj.radius > 0, proj.radius + margin,
                        torch.zeros_like(proj.radius))

        def cell(x, hi):
            return torch.clamp(torch.floor(x / cfg.tile), 0, hi - 1).long()

        tx0, ty0 = cell(u - r, tiles_x), cell(v - r, tiles_y)
        tx1, ty1 = cell(u + r, tiles_x), cell(v + r, tiles_y)
        k = torch.arange(d * d, device=dev)
        dx, dy = (k % d)[None, :], (k // d)[None, :]
        valid = ((proj.radius[:, None] > 0) & (dx < (tx1 - tx0 + 1)[:, None])
                 & (dy < (ty1 - ty0 + 1)[:, None]))
        tile_id = (ty0[:, None] + dy) * tiles_x + (tx0[:, None] + dx)
        tile_id = torch.where(valid, tile_id, torch.full_like(tile_id,
                                                             num_tiles))
        dbits = torch.clamp(proj.depth, min=1e-6).view(torch.int32).long()
        dkey = torch.where(valid, dbits[:, None],
                           torch.full_like(tile_id, 2**31 - 1))
        # One int64 key (tile, depth bits); the stable sort breaks ties by
        # the entry id gaussian * d^2 + k.
        s_key, s_flat = torch.sort((tile_id * (1 << 32) + dkey).reshape(-1),
                                   stable=True)
        s_tile = s_key >> 32
        t = torch.arange(num_tiles + 1, device=dev)
        bounds = torch.searchsorted(s_tile, t)
    return s_tile, s_flat // (d * d), bounds[:-1], bounds[1:] - bounds[:-1]


def _build_slots(proj: _Projected, cam: Camera, cfg: RasterConfig,
                 margin: float = 0.0):
    """Binning -> 128-aligned per-tile slot layout. The sorted entries are
    cut to the budget entry_cap_factor * N (rounded up to 128), so the last
    tiles lose entries first; each tile keeps at most max_per_tile. Returns
    (slot_gid (Epad,) i64, the gaussian of each slot, N for an empty one;
    pstart (T,) i32; count (T,) i32), Epad = budget + 128 * T."""
    n = proj.mean2d.shape[0]
    tiles_x, tiles_y = _tiles(cam, cfg)
    num_tiles = tiles_x * tiles_y
    s_tile, s_gauss, start, count = _bin_entries(proj, cam, cfg, margin)
    with torch.no_grad():
        e_cap = min(s_gauss.shape[0],
                    -(-cfg.entry_cap_factor * n // CHUNK_V1) * CHUNK_V1)
        start = torch.clamp(start, max=e_cap)
        count = torch.clamp(torch.clamp(start + count, max=e_cap) - start,
                            max=cfg.max_per_tile)
        padded = -(-count // CHUNK_V1) * CHUNK_V1
        pstart = torch.cumsum(padded, 0) - padded
        e_pad = e_cap + CHUNK_V1 * num_tiles
        s_tile, s_gauss = s_tile[:e_cap], s_gauss[:e_cap]
        tile_c = torch.clamp(s_tile, 0, num_tiles - 1)
        pos = torch.arange(e_cap, device=s_tile.device) - start[tile_c]
        ok = (s_tile < num_tiles) & (pos >= 0) & (pos < count[tile_c])
        slot_gid = torch.full((e_pad,), n, dtype=torch.long,
                              device=s_tile.device)
        slot_gid[(pstart[tile_c] + pos)[ok]] = s_gauss[ok]
    return slot_gid, pstart.to(torch.int32), count.to(torch.int32)


class _GatherEntries(torch.autograd.Function):
    """entries (NCH, Epad) = attrs[:, slot_gid]; the backward sums the
    entry grads back into (NCH, N + 1) columns in a fixed order
    (`gather_entries_bwd`: each column's entries in ascending entry order;
    column N, the sentinel, which `_with_sentinel`'s caller drops, zero)."""

    @staticmethod
    def forward(ctx, attrs, slot_gid):
        ctx.save_for_backward(slot_gid)
        ctx.n_cols = attrs.shape[1]
        return attrs[:, slot_gid]

    @staticmethod
    def backward(ctx, g):
        (slot_gid,) = ctx.saved_tensors
        return gather_entries_bwd(g, slot_gid, ctx.n_cols), None


def _gather_entries(attrs, slot_gid):
    return _GatherEntries.apply(attrs, slot_gid)


def _with_sentinel(attrs):
    """Append the inert column N that empty slots gather."""
    return torch.cat([attrs, attrs.new_zeros((attrs.shape[0], 1))], 1)


def _composite_pallas(proj: _Projected, colors, cam: Camera,
                      cfg: RasterConfig):
    """Entry-binned compositing: slot layout, one attr-major gather, K5."""
    tiles_x, _ = _tiles(cam, cfg)
    slot_gid, pstart, count = _build_slots(proj, cam, cfg)
    entries = _gather_entries(_with_sentinel(_stack_attrs(proj, colors)),
                              slot_gid)
    return composite_entries(entries, pstart, count, cfg.tile, tiles_x)


# ---------------------------------------------------------------------------
# Dense backend (`jnp`: plain PyTorch, no kernel)
# ---------------------------------------------------------------------------


def _build_tile_table(proj: _Projected, cam: Camera, cfg: RasterConfig):
    """The entry binning as a fixed-capacity table: (table (T, C) int64,
    each tile's gaussians in depth order, N in the empty slots; count (T,)
    int64, at most C = tile_capacity). A tile's entries past C are its
    deepest and are dropped."""
    n = proj.mean2d.shape[0]
    tiles_x, tiles_y = _tiles(cam, cfg)
    num_tiles = tiles_x * tiles_y
    cap = cfg.tile_capacity
    s_tile, s_gauss, start, count = _bin_entries(proj, cam, cfg)
    with torch.no_grad():
        pos = (torch.arange(s_tile.shape[0], device=s_tile.device)
               - start[torch.clamp(s_tile, 0, num_tiles - 1)])
        ok = (s_tile < num_tiles) & (pos < cap)
        table = torch.full((num_tiles + 1, cap), n, dtype=torch.long,
                           device=s_tile.device)
        table[torch.where(ok, s_tile, num_tiles),
              torch.where(ok, pos, 0)] = torch.where(ok, s_gauss, n)
    return table[:num_tiles], torch.clamp(count, max=cap)


def _dense_chunk(log_t, acc, idx, in_slot, pu, pv, mean2d_p, conic_p,
                 opac_p, feat_p, alpha_min: float, alpha_max: float):
    """One front-to-back step over every tile: the chunk's gaussians `idx`
    (T, K) against the tiles' pixels (T, P). Returns (log T, acc)."""
    m2 = mean2d_p[idx]                                  # (T, K, 2)
    co = conic_p[idx]                                   # (T, K, 3)
    du = pu[:, None, :] - m2[..., 0:1]                  # (T, K, P)
    dv = pv[:, None, :] - m2[..., 1:2]
    power = (-0.5 * (co[..., 0:1] * du * du + co[..., 2:3] * dv * dv)
             - co[..., 1:2] * du * dv)
    g = torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.where((power <= 0.0) & in_slot[..., None],
                        opac_p[idx][..., None] * g, torch.zeros_like(g))
    alpha = torch.clamp(alpha, max=alpha_max)
    alpha = torch.where(alpha < alpha_min, torch.zeros_like(alpha), alpha)
    log1m = torch.log1p(-alpha)
    cum = torch.cumsum(log1m, dim=1)
    w = alpha * torch.exp(cum - log1m + log_t[:, None, :])
    acc = acc + torch.einsum("tkp,tkf->tpf", w, feat_p[idx])
    return log_t + cum[:, -1], acc


def _composite_dense(table, count, proj: _Projected, colors, cam: Camera,
                     cfg: RasterConfig):
    """Front-to-back alpha compositing over the tile table, all tiles at
    once, `chunk` slots a step. Returns the padded (Hp, Wp) images: colour
    (.., 3), depth, alpha. Steps past the fullest tile's count composite
    nothing and are skipped (one host read of the largest count)."""
    n = proj.mean2d.shape[0]
    tiles_x, tiles_y = _tiles(cam, cfg)
    num_tiles = tiles_x * tiles_y
    ts = cfg.tile
    dev = proj.mean2d.device

    def pad(x, fill=0.0):
        return torch.cat([x, torch.full((1,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=dev)], 0)

    mean2d_p = pad(proj.mean2d, -1e6)
    conic_p = pad(proj.conic)
    opac_p = pad(proj.opacity)
    feat_p = pad(torch.cat([colors, proj.depth[:, None],
                            torch.ones((n, 1), dtype=colors.dtype,
                                       device=dev)], -1))  # rgb, depth, 1
    tid = torch.arange(num_tiles, device=dev)
    lu = torch.arange(ts, dtype=torch.float32, device=dev)
    local_v, local_u = torch.meshgrid(lu, lu, indexing="ij")
    pu = ((tid % tiles_x) * ts).to(torch.float32)[:, None] \
        + local_u.reshape(-1)[None]                     # (T, P)
    pv = ((tid // tiles_x) * ts).to(torch.float32)[:, None] \
        + local_v.reshape(-1)[None]
    log_t = torch.zeros(pu.shape, dtype=torch.float32, device=dev)
    acc = torch.zeros(pu.shape + (5,), dtype=torch.float32, device=dev)
    k = cfg.chunk
    n_steps = min(-(-int(count.max()) // k) if num_tiles else 0,
                  cfg.tile_capacity // k)
    slot = torch.arange(k, device=dev)
    for ci in range(n_steps):
        args = (log_t, acc, table[:, ci * k:(ci + 1) * k],
                (slot + ci * k)[None, :] < count[:, None], pu, pv, mean2d_p,
                conic_p, opac_p, feat_p, cfg.alpha_min, cfg.alpha_max)
        if torch.is_grad_enabled():
            log_t, acc = torch.utils.checkpoint.checkpoint(
                _dense_chunk, *args, use_reentrant=False)
        else:
            log_t, acc = _dense_chunk(*args)
    img = acc.reshape(tiles_y, tiles_x, ts, ts, 5).permute(0, 2, 1, 3, 4) \
        .reshape(tiles_y * ts, tiles_x * ts, 5)
    return img[..., :3], img[..., 3], img[..., 4]


class FrozenBinning(NamedTuple):
    """Per-entry 3D attrs and the slot layout, binned once at the init pose
    (with a margin) for the pose refinement of the `pallas` backend.
    e3d rows as FrozenSorted's, one column per slot (the sentinel's for an
    empty slot). Constant (no gradient)."""

    e3d: torch.Tensor     # (NCH, Epad)
    pstart: torch.Tensor  # (T,)
    count: torch.Tensor   # (T,)


@torch.no_grad()
def freeze_binning(means3d, quats, log_scales, opacity_logits, colors,
                   init_w2c, cam: Camera, cfg: RasterConfig, alive=None,
                   margin: Optional[float] = None) -> FrozenBinning:
    """Bin once at the init pose (margin tile / 2) and gather per-entry 3D
    attrs; culled gaussians get opacity 0."""
    if margin is None:
        margin = cfg.tile / 2.0
    proj = project_gaussians(means3d, quats, log_scales, opacity_logits,
                             init_w2c, cam, cfg, alive)
    slot_gid, pstart, count = _build_slots(proj, cam, cfg, margin)
    attrs = _with_sentinel(_rows3d(means3d, quats, log_scales, colors, proj))
    return FrozenBinning(attrs[:, slot_gid].contiguous(), pstart, count)


def render_frozen(fb: FrozenBinning, w2c, cam: Camera,
                  cfg: RasterConfig) -> RenderOutput:
    """Render from a frozen binning; differentiable w.r.t. `w2c` (the entry
    grads of K6 chain elementwise back to the pose)."""
    check_config(cfg)
    rows = _reproject_rows(fb.e3d, w2c, cam, cfg)
    zeros = torch.zeros((NCH - 10, fb.e3d.shape[1]), dtype=torch.float32,
                        device=fb.e3d.device)
    entries = torch.cat([torch.stack(rows[:10], 0), zeros], 0)
    tiles_x, _ = _tiles(cam, cfg)
    out = composite_entries(entries, fb.pstart, fb.count, cfg.tile, tiles_x,
                            layout="frozen")
    return _full_image(out, cam, cfg,
                       torch.zeros(1, dtype=torch.int32, device=out.device))


def tile_sums(x: torch.Tensor, ts: int, tiles_x: int, tiles_y: int):
    """Per-tile sums of an (H, W) map, flattened to (tiles_y * tiles_x,)."""
    hp, wp = tiles_y * ts, tiles_x * ts
    xp = torch.nn.functional.pad(x, (0, wp - x.shape[1], 0, hp - x.shape[0]))
    return xp.reshape(tiles_y, ts, tiles_x, ts).sum((1, 3)).reshape(-1)


def gt_tiles(image: torch.Tensor, tile_ids, ts: int, tiles_x: int,
             tiles_y: int):
    """Ground-truth tiles matching `render_tiles`: (S, ts, ts[, C])."""
    chan = tuple(image.shape[2:])
    hp, wp = tiles_y * ts, tiles_x * ts
    pad = [0, 0] * len(chan) + [0, wp - image.shape[1], 0,
                                hp - image.shape[0]]
    img = torch.nn.functional.pad(image, pad)
    img = img.reshape((tiles_y, ts, tiles_x, ts) + chan)
    img = img.movedim(2, 1).reshape((tiles_y * tiles_x, ts, ts) + chan)
    return img[tile_ids.long()]


# ---------------------------------------------------------------------------
# Pose-contraction tracking path (K4)
# ---------------------------------------------------------------------------

_HOMOGENEOUS = torch.tensor([[0.0, 0.0, 0.0, 1.0]])
_ON_DEVICE = {}   # (name, dtype, device) -> a constant's copy there


def _on_device(name: str, value: torch.Tensor, dtype, device):
    """`value` on `device`, copied there once and kept, so that a tracker
    iteration makes no host-to-device copy (a CUDA graph captures none)."""
    key = (name, dtype, torch.device(device))
    t = _ON_DEVICE.get(key)
    if t is None:
        # Two threads that miss at once keep the first copy.
        t = _ON_DEVICE.setdefault(key, value.to(device=device, dtype=dtype))
    return t


def homogeneous_row(dtype, device) -> torch.Tensor:
    """[[0, 0, 0, 1]], the last row of a rigid transform, on `device`."""
    return _on_device("homogeneous", _HOMOGENEOUS, dtype, device)


def _pose_rel_w2c(pose_vec: torch.Tensor, last_w2c: torch.Tensor):
    """w2c = last_w2c @ Rel(quat=pose_vec[:4], trans=pose_vec[4:7]), the
    float chain of the tracker's `last_w2c @ _rel_matrix(quat, trans)`."""
    R = _quat_to_rotmat(pose_vec[:4])
    top = torch.cat([R, pose_vec[4:7, None]], 1)
    rel = torch.cat([top, homogeneous_row(R.dtype, R.device)], 0)
    return small_matmul(last_w2c, rel)


# d rotmat(n) / d n for a unit quaternion n = (w, x, y, z): every entry is
# linear in n, d R[i, j] / d n_k = sum_l _DROT[3 i + j, k, l] n_l.
_DROT = torch.zeros((9, 4, 4))
for _ij, _k, _l, _c in (
        (0, 2, 2, -4), (0, 3, 3, -4),
        (1, 0, 3, -2), (1, 1, 2, 2), (1, 2, 1, 2), (1, 3, 0, -2),
        (2, 0, 2, 2), (2, 1, 3, 2), (2, 2, 0, 2), (2, 3, 1, 2),
        (3, 0, 3, 2), (3, 1, 2, 2), (3, 2, 1, 2), (3, 3, 0, 2),
        (4, 1, 1, -4), (4, 3, 3, -4),
        (5, 0, 1, -2), (5, 1, 0, -2), (5, 2, 3, 2), (5, 3, 2, 2),
        (6, 0, 2, -2), (6, 1, 3, 2), (6, 2, 0, -2), (6, 3, 1, 2),
        (7, 0, 1, 2), (7, 1, 0, 2), (7, 2, 3, 2), (7, 3, 2, 2),
        (8, 1, 1, -4), (8, 2, 2, -4)):
    _DROT[_ij, _k, _l] = _c


def _w2c_tangents(pose_vec, last_w2c):
    """Tangents of w2c = last_w2c @ Rel(pose_vec) along the 7 pose
    parameters: dR (7, 3, 3), dt (7, 3). The quaternion is normalised
    inside Rel, so d n / d q = (I - n n^T) / |q|."""
    q = pose_vec[:4]
    s = torch.clamp(torch.linalg.norm(q), min=1e-12)
    n = q / s
    drot = _on_device("drot", _DROT, _DROT.dtype, q.device)
    dfdn = (drot * n).sum(-1)                                   # (9, 4)
    dndq = (torch.eye(4, device=q.device) - n[:, None] * n[None, :]) / s
    dRq = small_matmul(dfdn, dndq).reshape(3, 3, 4).permute(2, 0, 1)
    LR = last_w2c[:3, :3]
    dR = torch.cat([small_matmul(LR, dRq),                      # (4, 3, 3)
                    torch.zeros((3, 3, 3), device=q.device)])
    dt = torch.cat([torch.zeros((4, 3), device=q.device), LR.T])
    return dR, dt


def _pose_jacobian(e3d, pose_vec, last_w2c, cam: Camera, cfg: RasterConfig):
    """(P_MAX * PJ, Npad) jacobian d(pose-dependent rows) / d(pose_vec) in
    K4's row layout p * PJ + ch, columns in e3d's (sorted) order.

    Forward-mode derivative of `_reproject_rows` (rows u, v, conic a/b/c,
    depth), written out with the 7 tangents as a leading batch axis: the
    same derivative as the JAX package's 7 JVP passes (clamps pass the
    tangent inside their range and zero it outside), in about 80 elementwise
    operations on (7, Npad) tensors."""
    R = _pose_rel_w2c(pose_vec, last_w2c)
    Rw, tw = R[:3, :3], R[:3, 3]
    dR, dt = _w2c_tangents(pose_vec, last_w2c)
    x = e3d[0:3]
    p = small_matmul(Rw, x) + tw[:, None]                       # (3, N)
    dp = small_matmul(dR, x) + dt[:, :, None]                   # (7, 3, N)
    z = p[2]
    zc = torch.clamp(z, min=cfg.near)
    inv_z = 1.0 / zc
    dzc = dp[:, 2] * (z > cfg.near)
    dinv = -inv_z * inv_z * dzc
    du = cam.fx * (dp[:, 0] * inv_z + p[0] * dinv)
    dv = cam.fy * (dp[:, 1] * inv_z + p[1] * dinv)

    sig = torch.stack([torch.stack([e3d[3], e3d[4], e3d[5]]),
                       torch.stack([e3d[4], e3d[6], e3d[7]]),
                       torch.stack([e3d[5], e3d[7], e3d[8]])])  # (3, 3, N)
    n = x.shape[1]
    # S[i] = Sigma r_i (3, N); C[i, j] = r_j Sigma r_i; dRS: dr_i . Sigma r_j
    S = small_matmul(Rw, sig.reshape(3, 3 * n)).reshape(3, 3, n)
    C = small_matmul(Rw, S)
    dRS = small_matmul(dR, S.permute(1, 0, 2).reshape(3, 3 * n)
                       ).reshape(7, 3, 3, n)
    dC = dRS + dRS.transpose(1, 2)               # (7, 3, 3, N)

    lim_x = 1.3 * (0.5 * cam.width / cam.fx)
    lim_y = 1.3 * (0.5 * cam.height / cam.fy)
    gx = p[0] * inv_z
    gy = p[1] * inv_z
    dgx = dp[:, 0] * inv_z + p[0] * dinv
    dgy = dp[:, 1] * inv_z + p[1] * dinv
    cx_ = torch.clamp(gx, -lim_x, lim_x)
    cy_ = torch.clamp(gy, -lim_y, lim_y)
    tx = cx_ * zc
    ty = cy_ * zc
    dtx = dgx * ((gx > -lim_x) & (gx < lim_x)) * zc + cx_ * dzc
    dty = dgy * ((gy > -lim_y) & (gy < lim_y)) * zc + cy_ * dzc
    iz2 = inv_z * inv_z
    j00 = cam.fx * inv_z
    j02 = -cam.fx * tx * iz2
    j11 = cam.fy * inv_z
    j12 = -cam.fy * ty * iz2
    dj00 = cam.fx * dinv
    dj02 = -cam.fx * (dtx * iz2 + tx * 2.0 * inv_z * dinv)
    dj11 = cam.fy * dinv
    dj12 = -cam.fy * (dty * iz2 + ty * 2.0 * inv_z * dinv)

    C00, C01, C02 = C[0, 0], C[0, 1], C[0, 2]
    C11, C12, C22 = C[1, 1], C[1, 2], C[2, 2]
    dC00, dC01, dC02 = dC[:, 0, 0], dC[:, 0, 1], dC[:, 0, 2]
    dC11, dC12, dC22 = dC[:, 1, 1], dC[:, 1, 2], dC[:, 2, 2]
    A1 = j00 * C00 + j02 * C02
    A2 = j00 * C02 + j02 * C22
    B1 = j00 * C01 + j02 * C12
    D1 = j11 * C11 + j12 * C12
    D2 = j11 * C12 + j12 * C22
    dA1 = dj00 * C00 + j00 * dC00 + dj02 * C02 + j02 * dC02
    dA2 = dj00 * C02 + j00 * dC02 + dj02 * C22 + j02 * dC22
    dB1 = dj00 * C01 + j00 * dC01 + dj02 * C12 + j02 * dC12
    dD1 = dj11 * C11 + j11 * dC11 + dj12 * C12 + j12 * dC12
    dD2 = dj11 * C12 + j11 * dC12 + dj12 * C22 + j12 * dC22
    a = j00 * A1 + j02 * A2 + cfg.low_pass
    b = j11 * B1 + j12 * A2
    c = j11 * D1 + j12 * D2 + cfg.low_pass
    da = dj00 * A1 + j00 * dA1 + dj02 * A2 + j02 * dA2
    db = dj11 * B1 + j11 * dB1 + dj12 * A2 + j12 * dA2
    dc = dj11 * D1 + j11 * dD1 + dj12 * D2 + j12 * dD2
    det_raw = a * c - b * b
    det = torch.clamp(det_raw, min=1e-12)
    inv_det = 1.0 / det
    ddet = (da * c + a * dc - 2.0 * b * db) * (det_raw > 1e-12)
    dinv_det = -inv_det * inv_det * ddet
    jac = torch.stack([du, dv, dc * inv_det + c * dinv_det,
                       -(db * inv_det + b * dinv_det),
                       da * inv_det + a * dinv_det, dp[:, 2]], 1)  # (7, 6, N)
    jac = jac.reshape(7 * PJ, -1)
    pad = torch.zeros((P_MAX * PJ - jac.shape[0], jac.shape[1]),
                      dtype=jac.dtype, device=jac.device)
    return torch.cat([jac, pad], 0).contiguous()


class _FrozenPoseTiles(torch.autograd.Function):
    """Raw tile blocks (S, 8, PX) of the frozen-sorted render, differentiable
    w.r.t. `pose_vec` (7,) only: e3d and last_w2c are constants of the
    refinement. The backward is K4."""

    @staticmethod
    def forward(ctx, pose_vec, e3d, seg_start, seg_cnt, tile_ids, last_w2c,
                cam, cfg):
        tiles_x, _ = _tiles(cam, cfg)
        with torch.no_grad():
            attrs = _stack_reproj_rows(
                e3d, _pose_rel_w2c(pose_vec, last_w2c), cam, cfg).contiguous()
            if cfg.kernel_bf16:
                attrs = to_bf16_layout(attrs)
        out, cols = composite_sorted_fwd(
            attrs, seg_start.to(torch.int32).contiguous(),
            seg_cnt.to(torch.int32).contiguous(), tile_ids, cfg.tile,
            tiles_x, cfg.bands, cfg.seg_cap, cfg.kernel_quadform)
        ctx.save_for_backward(pose_vec, e3d, last_w2c, attrs, tile_ids, out,
                              cols)
        ctx.geom = (cam, cfg)
        return out

    @staticmethod
    def backward(ctx, dout):
        pose_vec, e3d, last_w2c, attrs, tile_ids, out, cols = \
            ctx.saved_tensors
        cam, cfg = ctx.geom
        tiles_x, _ = _tiles(cam, cfg)
        with torch.no_grad():
            jac = _pose_jacobian(e3d, pose_vec.detach(), last_w2c, cam, cfg)
        dpose = pose_grad_sorted(attrs, jac, tile_ids, out, cols,
                                 dout.contiguous(), cfg.tile, tiles_x,
                                 cfg.kernel_quadform)
        return (dpose[: pose_vec.shape[0]].to(pose_vec.dtype), None, None,
                None, None, None, None, None)


def _frozen_pose_tiles(fs: FrozenSorted, pose_vec, last_w2c, tile_ids,
                       cam: Camera, cfg: RasterConfig):
    check_config(cfg)
    return _FrozenPoseTiles.apply(pose_vec, fs.e3d, fs.seg_start, fs.seg_cnt,
                                  tile_ids.to(torch.int32).contiguous(),
                                  last_w2c, cam, cfg)


def render_frozen_sorted_tiles_pose(fs: FrozenSorted, pose_vec, last_w2c,
                                    tile_ids, cam: Camera,
                                    cfg: RasterConfig) -> TileRender:
    """`render_frozen_sorted_tiles` at w2c = last_w2c @ Rel(pose_vec), with
    the pose-contraction backward (K4): the same forward, the gradient
    w.r.t. pose_vec (quat wxyz + trans) only."""
    out = _frozen_pose_tiles(fs, pose_vec, last_w2c, tile_ids, cam, cfg)
    return _tile_render(out, tile_ids.shape[0], cfg.tile)


def render_frozen_sorted_pose(fs: FrozenSorted, pose_vec, last_w2c,
                              cam: Camera, cfg: RasterConfig) -> RenderOutput:
    """Full-image `render_frozen_sorted` with the pose-contraction
    backward (see render_frozen_sorted_tiles_pose)."""
    out = _frozen_pose_tiles(fs, pose_vec, last_w2c,
                             _all_tiles(cam, cfg, fs.e3d.device), cam, cfg)
    return _full_image(out, cam, cfg,
                       torch.zeros(1, dtype=torch.int32, device=out.device))


# ---------------------------------------------------------------------------
# The frozen sorted render step by step (the tracker's refine iteration)
# ---------------------------------------------------------------------------
# `render_frozen_sorted(_tiles)(_pose)` run K1 and its backward inside
# autograd. The tracker's refinement takes the same steps one by one: the
# rows (`frozen_rows`, `frozen_pose_rows`), K1 (`frozen_fwd`), its losses
# on `out`, then K2 / K3 (`frozen_bwd`) and autograd through the rows, or
# K4 (`frozen_pose_grad`). So a CUDA graph can hold the work between the
# kernels while each kernel launches as a call of its own
# (`slam/tracker.py` `RefineGraph`). The kernels are looked up in their
# modules at each call.


def frozen_rows(fs: FrozenSorted, w2c, cam: Camera, cfg: RasterConfig):
    """The float32 kernel rows of `fs` at `w2c`, differentiable w.r.t. w2c
    (`render_frozen_sorted`'s)."""
    check_config(cfg)
    return _stack_reproj_rows(fs.e3d, w2c, cam, cfg)


@torch.no_grad()
def frozen_pose_rows(fs: FrozenSorted, pose_vec, last_w2c, cam: Camera,
                     cfg: RasterConfig):
    """The float32 kernel rows at last_w2c @ Rel(pose_vec) and their pose
    jacobian in K4's layout (`render_frozen_sorted_pose`'s)."""
    check_config(cfg)
    rows = _stack_reproj_rows(fs.e3d, _pose_rel_w2c(pose_vec, last_w2c),
                              cam, cfg)
    return rows, _pose_jacobian(fs.e3d, pose_vec, last_w2c, cam, cfg)


def frozen_tile_ids(tile_ids, cam: Camera, cfg: RasterConfig, device):
    """`tile_ids` as K1 reads them (int32, contiguous); every tile of the
    image when None."""
    if tile_ids is None:
        return _all_tiles(cam, cfg, device)
    return tile_ids.to(torch.int32).contiguous()


def frozen_image(out, tile_ids, cam: Camera, cfg: RasterConfig):
    """K1's `out` as `render_frozen_sorted_tiles` returns it for `tile_ids`,
    or with `tile_ids` None as `render_frozen_sorted` does (radii zero)."""
    if tile_ids is not None:
        return _tile_render(out, tile_ids.shape[0], cfg.tile)
    return _full_image(out, cam, cfg,
                       torch.zeros(1, dtype=torch.int32, device=out.device))


def kernel_rows(rows, cfg: RasterConfig):
    """The rows as K1-K4 read them: detached, contiguous, in the bf16 layout
    with `kernel_bf16`."""
    rows = rows.detach().contiguous()
    return to_bf16_layout(rows) if cfg.kernel_bf16 else rows


def frozen_fwd(rows, seg_start, seg_cnt, tile_ids, cam: Camera,
               cfg: RasterConfig):
    """K1 on `kernel_rows` over int32 `tile_ids`: (out (S, 8, PX), cols)."""
    tiles_x, _ = _tiles(cam, cfg)
    return composite_sorted_fwd(rows, seg_start, seg_cnt, tile_ids, cfg.tile,
                                tiles_x, cfg.bands, cfg.seg_cap,
                                cfg.kernel_quadform)


def frozen_bwd(rows, seg_start, tile_ids, out, cols, dout, cam: Camera,
               cfg: RasterConfig):
    """K2 (K3 with `rmw_window`) after `frozen_fwd`: the float32 rows'
    gradient (NCH, Npad) for the cotangent `dout` of `out`."""
    tiles_x, _ = _tiles(cam, cfg)
    if cfg.rmw_window:
        return _cs.composite_sorted_bwd_window(
            rows, seg_start, tile_ids, out, cols, dout, cfg.tile, tiles_x,
            cfg.bands, cfg.seg_cap, cfg.group, cfg.kernel_quadform)
    return _cs.composite_sorted_bwd(rows, tile_ids, out, cols, dout,
                                    cfg.tile, tiles_x, cfg.bands,
                                    cfg.kernel_quadform)


def frozen_pose_grad(rows, jac, tile_ids, out, cols, dout, cam: Camera,
                     cfg: RasterConfig):
    """K4 after `frozen_fwd`: the gradient (7,) w.r.t. `frozen_pose_rows`'
    pose_vec for the cotangent `dout` of `out`."""
    tiles_x, _ = _tiles(cam, cfg)
    return pose_grad_sorted(rows, jac, tile_ids, out, cols, dout, cfg.tile,
                            tiles_x, cfg.kernel_quadform)
