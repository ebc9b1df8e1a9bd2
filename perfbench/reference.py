"""The plain reference of the benchmark: NumPy and PyTorch only, nothing of
the program (`tests/test_perfbench_reference.py` checks its imports).

  - Frames: decodes the files the benchmark wrote (colour through Pillow,
    16-bit depth PNG through zlib), undistorts colour with the OpenCV
    5-coefficient lens model (bilinear, border clamp, rounded to uint8),
    crops `crop_edge` and scales, as a reader of that layout returns a
    frame: colour float32 in [0, 1], depth float32 in metres. ScanNet++'s
    DSLR frames are resized to the reader's 640x480 first (`scannetpp_frame`).
  - Rendering: the tile-binned Gaussian splat composite of the program's
    sorted backend, written out plainly: EWA projection (0.3 px low pass,
    opacity-aware radius capped to the +-r_n tile neighbourhood), the
    centre-tile sort by (tile, depth bits), each tile's band segments
    clipped to `seg_cap` lanes from their 128-aligned start, the tile's
    covered gaussians in (depth bits >> 12, lane) order, alpha clipped to
    [1/255, 0.99], front to back in chunks of 128 with the tile-wide stop
    at log T <= -11.5. The alpha decisions (the 1/255 cut, the 0.99 clip)
    are taken in float32, as the kernels take them; the values and sums
    are float64; the gradient of a clipped alpha is the kernels' (d alpha /
    d opacity = g, d alpha / d power = 0.99). Gradients w.r.t.
    every gaussian parameter come from autograd, tile block by tile block.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict

import numpy as np
import torch

CHUNK = 128
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
LOG_T_MIN = -11.5
SH_C0 = 0.28209479177387814
# Elements of a (tiles, pixels, survivors) block the reference holds at once.
BLOCK_ELEMS = 24 * 1024 * 1024


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def distort_points(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """OpenCV's distortion (k1, k2, p1, p2, k3) of normalised coords."""
    k1, k2, p1, p2, k3 = [float(v) for v in dist[:5]]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_maps(cam: dict, dist) -> tuple:
    """Source pixel of each rectified pixel (new camera matrix = K)."""
    u, v = np.meshgrid(np.arange(cam["W"], dtype=np.float64),
                       np.arange(cam["H"], dtype=np.float64))
    xy = np.stack([(u - cam["cx"]) / cam["fx"],
                   (v - cam["cy"]) / cam["fy"]], -1)
    xyd = distort_points(xy, np.asarray(dist, np.float64))
    return ((cam["fx"] * xyd[..., 0] + cam["cx"]).astype(np.float32),
            (cam["fy"] * xyd[..., 1] + cam["cy"]).astype(np.float32))


def remap_bilinear(img: np.ndarray, map_u: np.ndarray,
                   map_v: np.ndarray) -> np.ndarray:
    """Bilinear sample of uint8 `img` (H, W, C) at (map_u, map_v), border
    clamped, rounded to uint8."""
    H, W = img.shape[:2]
    u0 = np.floor(map_u).astype(np.int32)
    v0 = np.floor(map_v).astype(np.int32)
    fu = (map_u - u0)[..., None]
    fv = (map_v - v0)[..., None]
    u0c, u1c = np.clip(u0, 0, W - 1), np.clip(u0 + 1, 0, W - 1)
    v0c, v1c = np.clip(v0, 0, H - 1), np.clip(v0 + 1, 0, H - 1)
    a = img[v0c, u0c].astype(np.float32)
    b = img[v0c, u1c].astype(np.float32)
    c = img[v1c, u0c].astype(np.float32)
    d = img[v1c, u1c].astype(np.float32)
    out = (a * (1 - fu) + b * fu) * (1 - fv) + (c * (1 - fu) + d * fu) * fv
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def read_depth_png(path) -> np.ndarray:
    """A 16-bit gray PNG whose rows are unfiltered (as the benchmark writes
    depth): (H, W) uint16."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, bits, ctype = struct.unpack(">IIBB", body[:10])
            if (bits, ctype) != (16, 0):
                raise ValueError(f"{path}: not a 16-bit gray PNG")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 2 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: filtered depth rows")
    return raw[:, 1:].copy().view(">u2").reshape(h, w).astype(np.uint16)


def read_color(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def frame(color_path, depth_path, cam: dict) -> tuple:
    """(colour (h, w, 3) float32 in [0, 1], depth (h, w) float32 metres) as
    a reader of the layout returns frame i, cropped by cam["crop_edge"]."""
    rgb = read_color(color_path)
    dist = cam.get("distortion")
    if dist is not None and np.any(np.asarray(dist)):
        rgb = remap_bilinear(rgb, *undistort_maps(cam, dist))
    return _as_read(rgb, read_depth_png(depth_path), cam)


def _as_read(rgb: np.ndarray, depth: np.ndarray, cam: dict) -> tuple:
    """uint8 colour and 16-bit depth as a reader returns them: depth over
    cam["depth_scale"], both cropped by cam["crop_edge"], colour in [0, 1]."""
    depth = depth.astype(np.float32) / np.float32(cam["depth_scale"])
    e = int(cam.get("crop_edge", 0))
    if e:
        rgb, depth = rgb[e:-e, e:-e], depth[e:-e, e:-e]
    return rgb.astype(np.float32) / np.float32(255.0), depth


# The size the ScanNet++ reader resizes every DSLR frame to.
SCANNETPP_WH = (640, 480)


def resize_nearest(img: np.ndarray, wh: tuple) -> np.ndarray:
    """`img` (H, W, ...) resampled to `wh` = (width, height): output index
    j of an axis of n_in samples reads floor((j + 0.5) * n_in / n_out),
    the source sample under the output sample's centre."""
    def index(n_in, n_out):
        j = np.arange(n_out, dtype=np.float64)
        return np.minimum(np.floor((j + 0.5) * (n_in / n_out)).astype(
            np.int64), n_in - 1)

    h, w = img.shape[:2]
    return img[index(h, wh[1])[:, None], index(w, wh[0])]


def scannetpp_frame(color_path, depth_path, cam: dict) -> tuple:
    """ScanNet++'s frame as its reader returns it: the DSLR JPEG decoded
    and resized to 640x480 bilinearly by Pillow, the 16-bit depth decoded
    by `read_depth_png`, resized by `resize_nearest` and divided by
    cam["depth_scale"], both cropped by cam["crop_edge"]. The colour goes
    through Pillow's own resize, the library that `read_color` decodes
    with: a rewrite of its fixed-point filter would be a second program to
    get right, not a check of the first. Depth needs no such trust."""
    from PIL import Image

    with Image.open(color_path) as im:
        rgb = np.asarray(im.convert("RGB").resize(SCANNETPP_WH,
                                                  Image.BILINEAR), np.uint8)
    return _as_read(rgb, resize_nearest(read_depth_png(depth_path),
                                        SCANNETPP_WH), cam)


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def _quat_to_rotmat(q):
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


def project(xyz, quats, log_scales, opacity_logits, w2c, cam: dict,
            rast: dict, alive):
    """EWA projection: u, v, conic (a, b, c), opacity, depth, radius (0
    for a culled gaussian), all (N,) float32."""
    R_cw, t_cw = w2c[:3, :3], w2c[:3, 3]
    p = xyz @ R_cw.T + t_cw
    z = p[:, 2]
    near = float(rast["near"])
    zc = torch.clamp(z, min=near)
    inv_z = 1.0 / zc
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    W, H = cam["W"], cam["H"]
    u = p[:, 0] * inv_z * fx + cx
    v = p[:, 1] * inv_z * fy + cy
    M = _quat_to_rotmat(quats) * torch.exp(log_scales)[..., None, :]
    A = torch.einsum("ij,njk->nik", R_cw, M)
    lim_x = 1.3 * (0.5 * W / fx)
    lim_y = 1.3 * (0.5 * H / fy)
    tx = torch.clamp(p[:, 0] * inv_z, -lim_x, lim_x) * zc
    ty = torch.clamp(p[:, 1] * inv_z, -lim_y, lim_y) * zc
    j00, j11 = fx * inv_z, fy * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j12 = -fy * ty * inv_z * inv_z
    b0 = j00[:, None] * A[:, 0, :] + j02[:, None] * A[:, 2, :]
    b1 = j11[:, None] * A[:, 1, :] + j12[:, None] * A[:, 2, :]
    lp = float(rast["low_pass"])
    a = torch.sum(b0 * b0, dim=-1) + lp
    b = torch.sum(b0 * b1, dim=-1)
    c = torch.sum(b1 * b1, dim=-1) + lp
    det = torch.clamp(a * c - b * b, min=1e-12)
    inv_det = 1.0 / det
    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    op = torch.sigmoid(opacity_logits.reshape(-1))
    a_min = min(float(rast["alpha_min"]), 1.0 / 255.0)
    r_cut = torch.sqrt(2.0 * torch.log(torch.clamp(op / a_min,
                                                   min=1.0 + 1e-6)))
    radius = torch.clamp(r_cut, max=float(rast["sigma_clip"])) \
        * torch.sqrt(lam_max)
    tile, bands = int(rast["tile"]), int(rast["bands"])
    radius = torch.clamp(radius, max=((bands - 1) // 2) * tile - 1.0)
    vis = ((z > near) & (u + radius > 0) & (u - radius < W)
           & (v + radius > 0) & (v - radius < H)
           & (op > float(rast["alpha_min"])))
    if alive is not None:
        vis = vis & alive
    radius = torch.where(vis, radius, torch.zeros_like(radius))
    return {"u": u, "v": v, "ca": c * inv_det, "cb": -b * inv_det,
            "cc": a * inv_det, "op": op, "depth": z,
            "radius": radius.detach()}


def _segments(pr, cam: dict, rast: dict):
    """Centre-tile order and each tile's band segments: (order (N,),
    start (T, bands), cnt (T, bands))."""
    tile, bands, seg_cap = int(rast["tile"]), int(rast["bands"]), \
        int(rast["seg_cap"])
    tiles_x = -(-cam["W"] // tile)
    tiles_y = -(-cam["H"] // tile)
    T = tiles_x * tiles_y
    r_n = (bands - 1) // 2
    dev = pr["u"].device
    with torch.no_grad():
        ctx = torch.clamp(torch.floor(pr["u"] / tile), 0, tiles_x - 1).long()
        cty = torch.clamp(torch.floor(pr["v"] / tile), 0, tiles_y - 1).long()
        ct = torch.where(pr["radius"] > 0, cty * tiles_x + ctx,
                         torch.full_like(ctx, T))
        dbits = torch.clamp(pr["depth"], min=1e-6).view(torch.int32).long()
        key, order = torch.sort(ct * (1 << 32) + dbits, stable=True)
        s_ct = key >> 32
        t = torch.arange(T, device=dev)
        tx, ty = t % tiles_x, t // tiles_x
        rows = ty[:, None] + torch.arange(bands, device=dev)[None, :] - r_n
        row_ok = (rows >= 0) & (rows < tiles_y)
        rows_c = torch.clamp(rows, 0, tiles_y - 1)
        lo = rows_c * tiles_x + torch.clamp(tx[:, None] - r_n, 0, tiles_x - 1)
        hi = rows_c * tiles_x + torch.clamp(tx[:, None] + r_n, 0, tiles_x - 1)
        start = torch.searchsorted(s_ct, lo.reshape(-1)).reshape(T, bands)
        end = torch.searchsorted(s_ct, hi.reshape(-1) + 1).reshape(T, bands)
        cnt = torch.where(row_ok, end - start, torch.zeros_like(start))
        cnt = torch.minimum(cnt, seg_cap - start % CHUNK)
    return order, start, cnt, tiles_x, tiles_y


def _survivors(sorted_attrs, start, cnt, tiles, tile, tiles_x, seg_cap):
    """Each tile's covered columns of the sorted order in composite order:
    (cols (S, capt) long, n (S,) long)."""
    bands = start.shape[1]
    capt = bands * seg_cap
    dev = start.device
    st, ct = start[tiles], cnt[tiles]
    al = (st // CHUNK) * CHUNK
    lead = st - al
    lane = torch.arange(capt, device=dev)
    band, lib = lane // seg_cap, lane % seg_cap
    col = al[:, band] + lib[None, :]
    valid = (lib[None, :] >= lead[:, band]) & (lib[None, :]
                                               < lead[:, band] + ct[:, band])
    col = torch.clamp(col, max=sorted_attrs["u"].shape[0] - 1)
    u, v = sorted_attrs["u"][col], sorted_attrs["v"][col]
    r, depth = sorted_attrs["radius"][col], sorted_attrs["depth"][col]
    tx0 = ((tiles % tiles_x) * tile).to(torch.float32)[:, None]
    ty0 = ((tiles // tiles_x) * tile).to(torch.float32)[:, None]
    cover = (valid & (r > 0.0) & (u + r > tx0) & (u - r < tx0 + tile)
             & (v + r > ty0) & (v - r < ty0 + tile))
    dbits = torch.clamp(depth, min=1e-6).view(torch.int32).long()
    key = torch.where(cover, (dbits >> 12) * 4096 + lane,
                      torch.full_like(dbits, 1 << 62) + lane)
    order = torch.argsort(key, dim=1)
    return torch.gather(col, 1, order), cover.sum(1)


def _composite_block(leaves, cols, n_surv, tiles, tile, tiles_x):
    """Composite S tiles: (S, PX, 5) float64 rows r, g, b, depth, alpha."""
    dev = cols.device
    L = int(n_surv.max())
    cols = cols[:, :L]
    slot = torch.arange(L, device=dev)
    ok = slot[None, :] < n_surv[:, None]
    p = torch.arange(tile * tile, device=dev)
    pu = ((tiles % tiles_x) * tile).to(torch.float32)[:, None] \
        + (p % tile).to(torch.float32)[None, :]
    pv = ((tiles // tiles_x) * tile).to(torch.float32)[:, None] \
        + (p // tile).to(torch.float32)[None, :]
    e32 = {k: leaves[k].detach().float()[cols] for k in
           ("u", "v", "ca", "cb", "cc", "op")}
    with torch.no_grad():
        du = pu[:, :, None] - e32["u"][:, None, :]
        dv = pv[:, :, None] - e32["v"][:, None, :]
        pw = (-0.5 * (e32["ca"][:, None, :] * du * du
                      + e32["cc"][:, None, :] * dv * dv)
              - e32["cb"][:, None, :] * du * dv)
        a32 = e32["op"][:, None, :] * torch.exp(torch.clamp(pw, max=0.0))
        keep = (pw <= 0.0) & ok[:, None, :] & (
            torch.clamp(a32, max=ALPHA_MAX) >= ALPHA_MIN)
        clipped = a32 > ALPHA_MAX
        del du, dv, pw, a32
    e = {k: leaves[k][cols] for k in leaves}
    du = pu.double()[:, :, None] - e["u"][:, None, :]
    dv = pv.double()[:, :, None] - e["v"][:, None, :]
    pw = (-0.5 * (e["ca"][:, None, :] * du * du
                  + e["cc"][:, None, :] * dv * dv)
          - e["cb"][:, None, :] * du * dv)
    pw = torch.clamp(pw, max=0.0)
    g = torch.exp(pw)
    alpha = e["op"][:, None, :] * g
    # A clipped alpha keeps the kernels' backward through the clip:
    # d alpha / d opacity = g, d alpha / d power = alpha (= ALPHA_MAX).
    op = e["op"][:, None, :]
    through = (ALPHA_MAX + (op - op.detach()) * g.detach()
               + ALPHA_MAX * (pw - pw.detach()))
    alpha = torch.where(clipped, through, alpha)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    log1m = torch.log1p(-alpha)
    cum = torch.cumsum(log1m, -1)
    with torch.no_grad():
        # The tile-wide stop: chunk ci runs while the tile's largest log T
        # before it is above LOG_T_MIN.
        n_chunks = (n_surv + CHUNK - 1) // CHUNK
        bounds = torch.arange(CHUNK, L + CHUNK, CHUNK, device=dev) - 1
        bounds = torch.clamp(bounds, max=L - 1)
        before = torch.cat([torch.zeros_like(cum[:, :, :1]),
                            cum[:, :, bounds[:-1]]], -1).amax(1)  # (S, C)
        live = torch.cumprod((before > LOG_T_MIN).long(), -1)
        ci = torch.arange(before.shape[1], device=dev)
        eff = (live * (ci[None, :] < n_chunks[:, None])).sum(1)
        run = slot[None, :] < eff[:, None] * CHUNK
    log1m = torch.where(run[:, None, :], log1m, torch.zeros_like(log1m))
    cum = torch.cumsum(log1m, -1)
    w = alpha * torch.exp(cum - log1m)
    w = torch.where(run[:, None, :], w, torch.zeros_like(w))
    feat = torch.stack([e["r"], e["g"], e["b"], e["depth"]], -1)
    acc = torch.einsum("spl,slf->spf", w, feat)
    a_out = 1.0 - torch.exp(cum[:, :, -1])
    return torch.cat([acc, a_out[..., None]], -1)


def render(params: Dict[str, torch.Tensor], w2c: torch.Tensor, cam: dict,
           rast: dict, alive=None, cotangent=None):
    """Render the map `params` (xyz, quats, log_scales, opacity_logits,
    f_dc) at w2c on camera `cam`: (color (H, W, 3), depth (H, W), alpha
    (H, W)) in float64 and, with `cotangent` (H, W, 5) for the loss
    sum(cotangent * [color, depth, alpha]), the loss's gradient w.r.t.
    each parameter (float32)."""
    want_grad = cotangent is not None
    p = {k: v.detach().float().requires_grad_(want_grad)
         for k, v in params.items()}
    with torch.set_grad_enabled(want_grad):
        pr = project(p["xyz"], p["quats"], p["log_scales"],
                     p["opacity_logits"], w2c.float(), cam, rast, alive)
        colors = p["f_dc"] * SH_C0 + 0.5
        order, start, cnt, tiles_x, tiles_y = _segments(pr, cam, rast)
        vals32 = {"u": pr["u"], "v": pr["v"], "ca": pr["ca"], "cb": pr["cb"],
                  "cc": pr["cc"], "op": pr["op"], "r": colors[:, 0],
                  "g": colors[:, 1], "b": colors[:, 2], "depth": pr["depth"]}
    leaves = {k: v.detach()[order].double().requires_grad_(want_grad)
              for k, v in vals32.items()}
    sorted_geo = {"u": pr["u"].detach()[order], "v": pr["v"].detach()[order],
                  "radius": pr["radius"][order],
                  "depth": pr["depth"].detach()[order]}
    tile, seg_cap = int(rast["tile"]), int(rast["seg_cap"])
    T = tiles_x * tiles_y
    dev = start.device
    all_tiles = torch.arange(T, device=dev)
    cols, n_surv = _survivors(sorted_geo, start, cnt, all_tiles, tile,
                              tiles_x, seg_cap)
    img = torch.zeros((T, tile * tile, 5), dtype=torch.float64, device=dev)
    if want_grad:
        cot = torch.zeros((tiles_y * tile, tiles_x * tile, 5),
                          dtype=torch.float64, device=dev)
        cot[:cam["H"], :cam["W"]] = cotangent.double()
        cot = cot.reshape(tiles_y, tile, tiles_x, tile, 5).permute(
            0, 2, 1, 3, 4).reshape(T, tile * tile, 5)
    by_len = torch.argsort(n_surv)
    lens = n_surv[by_len].tolist()
    i = 0
    while i < T:
        s = 1
        while (i + s < T
               and (s + 1) * tile * tile * max(lens[i + s], 1) <= BLOCK_ELEMS):
            s += 1
        blk = by_len[i:i + s]
        if lens[i + s - 1] > 0:
            with torch.set_grad_enabled(want_grad):
                out = _composite_block(leaves, cols[blk], n_surv[blk], blk,
                                       tile, tiles_x)
                if want_grad:
                    (out * cot[blk]).sum().backward()
            img[blk] = out.detach()
        i += s
    img = img.reshape(tiles_y, tiles_x, tile, tile, 5).permute(
        0, 2, 1, 3, 4).reshape(tiles_y * tile, tiles_x * tile, 5)
    img = img[:cam["H"], :cam["W"]]
    grads = None
    if want_grad:
        outs, gs = [], []
        for k, v in vals32.items():
            g = leaves[k].grad
            if g is None:
                continue
            full = torch.zeros_like(v)
            full[order] = g.to(v.dtype)
            outs.append(v)
            gs.append(full)
        torch.autograd.backward(outs, gs)
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in p.items()}
    return img[..., :3], img[..., 3], img[..., 4], grads
