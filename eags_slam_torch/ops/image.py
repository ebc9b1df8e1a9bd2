"""Image ops on the main path (port of the matching functions of
eags_slam_tpu.ops.image): luma, Sobel, dilation, Canny, bit-mask unpacking,
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


def sobel(img: torch.Tensor):
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      device=img.device)
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
