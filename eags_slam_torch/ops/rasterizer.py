"""Differentiable tile-binned 3D Gaussian splat rasterizer, sorted backend
(port of the `sorted` path of eags_slam_tpu.ops.rasterizer).

Pipeline:
  1. EWA projection (`project_gaussians`): 3D covariance R S S^T R^T to a 2D
     conic through the perspective Jacobian, 0.3 px low-pass, near plane,
     opacity-aware footprint radius capped to the +-r_n tile neighbourhood.
  2. Centre-tile sort (`_center_sort`): gaussians sorted by (centre tile,
     depth bits); each tile's `bands` neighbouring tile-row segments come
     from searchsorted, clipped to `seg_cap` lanes from the 128-aligned start.
  3. Compositing: `ops.composite_sorted` (the K1/K2 CUDA kernels on the
     card, their plain twins on the CPU).

Gradients reach every array input (means, quats, scales, opacity, colours
and the pose) through PyTorch autograd; the column gather of `_sorted_attrs`
is plain indexing, whose backward is a scatter-add.

Only the sorted backend is ported. `RasterConfig` keeps the JAX fields the
sorted path reads, plus the selectors of the unported branches, for which
`check_config` raises. The dense/pallas-only fields (`tile_capacity`,
`chunk`, `max_per_tile`, `entry_cap_factor`), the TPU grid `group` and
`alpha_max` (the kernels clip alpha at the fixed `ALPHA_MAX`, as K1/K2 do)
are left out.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.camera import Camera
from .composite_sorted import NCH, composite_sorted


class RasterConfig(NamedTuple):
    tile: int = 16            # square tile side in pixels
    dup_side: int = 4         # frozen-reprojection radius cap (v1 semantics)
    near: float = 0.2         # z culling plane
    alpha_min: float = 1.0 / 255.0
    sigma_clip: float = 3.0   # radius = sigma_clip * sqrt(lambda_max)
    low_pass: float = 0.3     # 2D covariance dilation (3DGS convention)
    backend: str = "sorted"   # sorted (auto == sorted); jnp/pallas not ported
    seg_cap: int = 1024       # per-band segment capacity
    bands: int = 3            # centre-tile neighbourhood side
    kernel_bf16: bool = False  # not ported (ROADMAP Queue 2)
    kernel_quadform: bool = False  # not ported (ROADMAP Queue 2)
    rmw_window: bool = False  # K3, not ported (ROADMAP Queue 2)


def check_config(cfg: RasterConfig) -> None:
    """Raise for the configuration branches this port does not have yet."""
    if cfg.backend not in ("sorted", "auto"):
        raise NotImplementedError(
            f"RasterConfig.backend={cfg.backend!r}: only the sorted backend "
            "is ported (ROADMAP Queue 2: K5/K6 for 'pallas'; the dense 'jnp' "
            "compositor is not on the port's path)")
    for flag, item in (("kernel_bf16", "K1 bf16 option"),
                       ("kernel_quadform", "K1 quadform option"),
                       ("rmw_window", "K3 windowed backward")):
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"RasterConfig.{flag}: not ported (ROADMAP Queue 2, {item})")


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
                            tiles_x, cfg.bands, cfg.seg_cap)


def render(means3d, quats, log_scales, opacity_logits, colors, w2c,
           cam: Camera, cfg: RasterConfig = RasterConfig(),
           alive=None) -> RenderOutput:
    """Render gaussians into (color, depth, alpha, radii); differentiable
    w.r.t. every array input including `w2c`."""
    check_config(cfg)
    proj = project_gaussians(means3d, quats, log_scales, opacity_logits, w2c,
                             cam, cfg, alive, radius_cap=_v2_radius_cap(cfg))
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
    n = means3d.shape[0]
    proj = project_gaussians(means3d, quats, log_scales, opacity_logits,
                             init_w2c, cam, cfg, alive,
                             radius_cap=_v2_radius_cap(cfg))
    order, seg_start, seg_cnt = _center_sort(proj, cam, cfg)
    S = torch.exp(log_scales)
    M = _quat_to_rotmat(quats) * S[..., None, :]
    c00 = torch.sum(M[:, 0] * M[:, 0], -1)
    c01 = torch.sum(M[:, 0] * M[:, 1], -1)
    c02 = torch.sum(M[:, 0] * M[:, 2], -1)
    c11 = torch.sum(M[:, 1] * M[:, 1], -1)
    c12 = torch.sum(M[:, 1] * M[:, 2], -1)
    c22 = torch.sum(M[:, 2] * M[:, 2], -1)
    opac = proj.opacity * (proj.radius > 0)
    attrs = torch.cat([
        torch.stack([means3d[:, 0], means3d[:, 1], means3d[:, 2],
                     c00, c01, c02, c11, c12, c22, opac,
                     colors[:, 0], colors[:, 1], colors[:, 2]], 0),
        torch.zeros((NCH - 13, n), dtype=torch.float32, device=means3d.device),
    ], 0)
    return FrozenSorted(_pad_sorted(attrs[:, order], cfg).contiguous(),
                        seg_start, seg_cnt)


def _reproject_rows(e3d, w2c, cam: Camera, cfg: RasterConfig,
                    radius_cap: Optional[float] = None):
    """Elementwise EWA reprojection of packed 3D rows under a new pose.
    Returns the kernel channel rows [u, v, conic a/b/c, opacity, rgb, depth,
    radius]."""
    R = w2c[:3, :3]
    t = w2c[:3, 3]
    p = R @ e3d[0:3] + t[:, None]
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
