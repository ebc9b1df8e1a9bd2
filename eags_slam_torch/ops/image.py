"""Image ops (port of eags_slam_tpu.ops.image): luma, 5-tap blur, Sobel /
Scharr, dilation, Canny, the windowed L2 distance transform and its
gradient structure, pyramids, bilinear sampling, bit-mask unpacking,
gradient sampling probabilities, hole-aware depth downsampling."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma; same scale as the input."""
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def _conv2_same(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """2D cross-correlation with edge-replicate SAME padding, (H, W)."""
    kh, kw = kernel.shape
    pad = F.pad(img[None, None], (kw // 2, kw // 2, kh // 2, kh // 2),
                mode="replicate")
    return F.conv2d(pad, kernel[None, None].to(img))[0, 0]


def gaussian_blur5(img: torch.Tensor) -> torch.Tensor:
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=img.device) / 16.0
    return _conv2_same(_conv2_same(img, k[None, :]), k[:, None])


def sobel(img: torch.Tensor):
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      device=img.device)
    return _conv2_same(img, kx), _conv2_same(img, kx.T.contiguous())


def scharr(img: torch.Tensor):
    kx = torch.tensor([[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0],
                       [-3.0, 0.0, 3.0]], device=img.device) / 32.0
    return _conv2_same(img, kx), _conv2_same(img, kx.T.contiguous())


def _same_pads(size: int):
    total = size - 1
    return total // 2, total - total // 2


def dilate(mask: torch.Tensor, size: int = 2) -> torch.Tensor:
    """Binary dilation with a size x size structuring element (XLA SAME
    window placement: pad (size-1)//2 before, the rest after)."""
    lo, hi = _same_pads(size)
    x = F.pad(mask.to(torch.float32)[None, None], (lo, hi, lo, hi))
    return F.max_pool2d(x, size, stride=1)[0, 0] > 0.0


def _nms(mag, gx, gy):
    pad = F.pad(mag, (1, 1, 1, 1))
    h, w = mag.shape

    def sh(dr, dc):
        return pad[1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    a = torch.abs(torch.atan2(gy, gx))
    horiz = (a <= math.pi / 8) | (a >= 7 * math.pi / 8)
    vert = (a >= 3 * math.pi / 8) & (a <= 5 * math.pi / 8)
    diag1 = (~horiz) & (~vert) & (torch.sign(gx) == torch.sign(gy))
    n1 = torch.where(horiz, sh(0, 1), torch.where(vert, sh(1, 0),
                     torch.where(diag1, sh(1, 1), sh(1, -1))))
    n2 = torch.where(horiz, sh(0, -1), torch.where(vert, sh(-1, 0),
                     torch.where(diag1, sh(-1, -1), sh(-1, 1))))
    return (mag >= n1) & (mag >= n2)


def canny(gray: torch.Tensor, low: float, high: float,
          hysteresis_iters: int = 8, l2gradient: bool = True) -> torch.Tensor:
    """Canny edges on a (H, W) gray image in [0, 255] (hysteresis as a
    fixed number of masked 3x3 dilations)."""
    gx, gy = sobel(gray)
    mag = torch.sqrt(gx * gx + gy * gy) if l2gradient \
        else torch.abs(gx) + torch.abs(gy)
    local_max = _nms(mag, gx, gy)
    strong = local_max & (mag >= high)
    weak = local_max & (mag >= low)
    grown = strong
    for _ in range(hysteresis_iters):
        grown = weak & dilate(grown, 3)
    return grown | strong


def _min_plus(g: torch.Tensor, window: int, dim: int, big: float):
    """min over |d| <= window of g shifted by d along `dim`, plus d^2;
    outside the image counts as `big` (never below the unshifted value)."""
    pad = [0, 0, 0, 0]
    pad[2 * (1 - dim):2 * (1 - dim) + 2] = [window, window]
    gp = F.pad(g, pad, value=big)
    d = torch.arange(-window, window + 1, device=g.device)
    win = gp.unfold(dim, 2 * window + 1, 1)            # (H, W, 2W+1)
    return (win + (d * d).to(g.dtype)).amin(-1)


def distance_transform_l2(edges: torch.Tensor, window: int = 32):
    """Euclidean distance (px) to the nearest edge pixel, exact up to
    `window` and clamped to `window` beyond: the separable squared-distance
    min-plus over 2 * window + 1 shifts per axis. Every intermediate is an
    integer below 2^24, so the result is exact in float32."""
    big = float(window * window * 4)
    f = torch.where(edges, 0.0, big).to(torch.float32)
    g = _min_plus(f, window, 0, big)
    d2 = _min_plus(g, window, 1, big)
    return torch.clamp(torch.sqrt(d2), max=float(window))


def dt_with_gradients(edges: torch.Tensor, window: int = 32):
    """(gx, gy, dt): the distance transform and its halved central
    differences (edge-replicated border)."""
    dt = distance_transform_l2(edges, window)
    pad = F.pad(dt[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    gx = 0.5 * (pad[1:-1, 2:] - pad[1:-1, :-2])
    gy = 0.5 * (pad[2:, 1:-1] - pad[:-2, 1:-1])
    return gx, gy, dt


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown equivalent: 5-tap gaussian then 2x subsample."""
    return gaussian_blur5(img)[::2, ::2]


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor):
    """Sample an (H, W) or (H, W, C) image at float pixel coords uv (..., 2).
    Returns (values, in_bounds); out-of-bounds samples read the clamped
    border. The corner indices are clamped in float before the integer
    cast (a cast of a far-off float is undefined in PyTorch)."""
    h, w = img.shape[:2]
    u, v = uv[..., 0], uv[..., 1]
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    u0i = torch.clamp(u0, 0, w - 2).long()
    v0i = torch.clamp(v0, 0, h - 2).long()
    in_b = (u >= 0) & (u <= w - 1.001) & (v >= 0) & (v <= h - 1.001)
    i00 = img[v0i, u0i]
    i01 = img[v0i, u0i + 1]
    i10 = img[v0i + 1, u0i]
    i11 = img[v0i + 1, u0i + 1]
    if img.dim() == 3:
        fu, fv = fu[..., None], fv[..., None]
    val = (i00 * (1 - fu) * (1 - fv) + i01 * fu * (1 - fv)
           + i10 * (1 - fu) * fv + i11 * fu * fv)
    return val, in_b


def depth_pyr_down(depth: torch.Tensor) -> torch.Tensor:
    """Hole-aware 2x2 depth subsample (mean of valid entries, 0 if none)."""
    h2, w2 = depth.shape[0] // 2, depth.shape[1] // 2
    d = depth[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2)
    valid = (d > 0).to(depth.dtype)
    s = (d * valid).sum((1, 3))
    c = valid.sum((1, 3))
    return torch.where(c > 0, s / torch.clamp(c, min=1.0),
                       torch.zeros_like(s))


def unpack_mask_bits(bits: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Expand an np.packbits (big-endian) (H, ceil(W/8)) uint8 mask."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    b = (bits[:, :, None] >> shifts[None, None, :]) & 1
    return b.reshape(h, -1)[:, :w].to(torch.bool)


def gradient_sample_probs(gray: torch.Tensor) -> torch.Tensor:
    """Pixel sampling distribution proportional to |grad|."""
    gx, gy = sobel(gray)
    p = torch.sqrt(gx * gx + gy * gy).reshape(-1)
    return p / torch.clamp(p.sum(), min=1e-8)
