"""Dense reference splatter: brute force, O(N * H * W) (port of
eags_slam_tpu.ops.rasterizer_ref).

The golden model of the rasterizer tests: the same projection, culling and
alpha rules as `rasterizer.render`, but every gaussian composited over
every pixel after one global depth sort, so neither tile capacity nor
duplication caps apply. `respect_tile_span` keeps a pixel only in the
tiles of its gaussian's radius box, as the tiled backends do.
"""
from __future__ import annotations

import torch

from ..core.camera import Camera
from .rasterizer import RasterConfig, RenderOutput, project_gaussians


def render_dense(means3d, quats, log_scales, opacity_logits, colors, w2c,
                 cam: Camera, cfg: RasterConfig = RasterConfig(), alive=None,
                 respect_tile_span: bool = True) -> RenderOutput:
    """Render (color, depth, alpha, radii); differentiable w.r.t. every
    array input including `w2c`."""
    proj = project_gaussians(means3d, quats, log_scales, opacity_logits, w2c,
                             cam, cfg, alive)
    n = means3d.shape[0]
    dev = means3d.device
    order = torch.argsort(proj.depth.detach(), stable=True)
    m2 = proj.mean2d[order]
    co = proj.conic[order]
    op = proj.opacity[order]
    rad = proj.radius[order].detach()
    dep = proj.depth[order]
    col = colors[order]

    vv, uu = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float32, device=dev),
        torch.arange(cam.width, dtype=torch.float32, device=dev),
        indexing="ij")
    pu = uu.reshape(-1)  # (P,)
    pv = vv.reshape(-1)

    du = pu[None, :] - m2[:, :1]
    dv = pv[None, :] - m2[:, 1:2]
    power = (-0.5 * (co[:, :1] * du * du + co[:, 2:3] * dv * dv)
             - co[:, 1:2] * du * dv)
    g = torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.where(power <= 0.0, op[:, None] * g, torch.zeros_like(g))

    if respect_tile_span:
        ts = cfg.tile
        tiles_x = -(-cam.width // ts)
        tiles_y = -(-cam.height // ts)

        def cell(x, hi):
            return torch.clamp(torch.floor(x / ts), 0, hi - 1)

        tx0, ty0 = cell(m2[:, 0] - rad, tiles_x), cell(m2[:, 1] - rad, tiles_y)
        tx1, ty1 = cell(m2[:, 0] + rad, tiles_x), cell(m2[:, 1] + rad, tiles_y)
        ptx = torch.floor(pu / ts)
        pty = torch.floor(pv / ts)
        in_span = ((ptx[None, :] >= tx0[:, None].detach())
                   & (ptx[None, :] <= tx1[:, None].detach())
                   & (pty[None, :] >= ty0[:, None].detach())
                   & (pty[None, :] <= ty1[:, None].detach())
                   & (rad[:, None] > 0))
        alpha = torch.where(in_span, alpha, torch.zeros_like(alpha))

    alpha = torch.clamp(alpha, max=cfg.alpha_max)
    alpha = torch.where(alpha < cfg.alpha_min, torch.zeros_like(alpha), alpha)
    log1m = torch.log1p(-alpha)
    w = alpha * torch.exp(torch.cumsum(log1m, dim=0) - log1m)  # (N, P)
    feat = torch.cat([col, dep[:, None],
                      torch.ones((n, 1), dtype=col.dtype, device=dev)], -1)
    img = (w.T @ feat).reshape(cam.height, cam.width, 5)
    radii = torch.ceil(proj.radius.detach()).to(torch.int32)
    return RenderOutput(img[..., :3], img[..., 3], img[..., 4], radii)
