"""Mapping/tracking losses and image metrics (port of
eags_slam_tpu.ops.losses): L1, masked L1, banded-matmul SSIM, MS-SSIM,
isotropic scale regulariser, PSNR."""
from __future__ import annotations

import functools

import torch


def l1_loss(pred: torch.Tensor, gt: torch.Tensor, agg: str = "mean"):
    diff = torch.abs(pred - gt)
    if agg == "mean":
        return diff.mean()
    if agg == "sum":
        return diff.sum()
    return diff


def masked_l1(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor):
    """Mean of |pred - gt| over mask (sum / count), 0-safe; a mask with
    fewer trailing dims broadcasts and the count scales by those dims."""
    scale = 1.0
    if mask.dim() < pred.dim():
        for d in pred.shape[mask.dim():]:
            scale *= d
        mask = mask.reshape(mask.shape + (1,) * (pred.dim() - mask.dim()))
    diff = torch.abs(pred - gt) * mask
    return diff.sum() / torch.clamp(mask.sum() * scale, min=1.0)


@functools.lru_cache(maxsize=64)
def _band_matrix_cached(n: int, window_size: int, device: str):
    sigma = 1.5
    half = window_size // 2
    x = torch.arange(window_size, dtype=torch.float32) - half
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    i = torch.arange(n)[:, None]
    j = torch.arange(n)[None, :]
    d = j - i + half
    ok = (d >= 0) & (d <= 2 * half)
    return torch.where(ok, g[d.clamp(0, 2 * half)],
                       torch.zeros(())).to(device)


def _band_matrix(n: int, window_size: int, device) -> torch.Tensor:
    """(n, n) banded Gaussian blur matrix (zero-padded borders)."""
    return _band_matrix_cached(n, window_size, str(device))


def _window_stats(img1: torch.Tensor, img2: torch.Tensor, window_size: int):
    """Gaussian-windowed (sigma 1.5, zero-padded borders) means of img1,
    img2, img1^2, img2^2 and img1*img2 over an (H, W, C) pair: the
    separable blur as two banded matmuls over the 5 stacked quantities."""
    h, w, c = img1.shape
    bh = _band_matrix(h, window_size, img1.device)
    bw = _band_matrix(w, window_size, img1.device)
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], -1)
    cs = 5 * c
    tmp = (bh @ stack.reshape(h, w * cs)).reshape(h, w, cs)
    t = tmp.permute(0, 2, 1).reshape(h * cs, w)
    blurred = (t @ bw).reshape(h, cs, w).permute(0, 2, 1)
    return blurred.split(c, dim=-1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11):
    """Mean SSIM over an (H, W[, C]) pair; Gaussian window sigma 1.5."""
    if img1.dim() == 2:
        img1, img2 = img1[..., None], img2[..., None]
    mu1, mu2, m11, m22, m12 = _window_stats(img1, img2, window_size)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = torch.clamp(m11 - mu1_sq, min=0.0)
    sigma2_sq = torch.clamp(m22 - mu2_sq, min=0.0)
    sigma12 = m12 - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.clamp(ssim_map, -1.0, 1.0).mean()


def ssim_batched(img1: torch.Tensor, img2: torch.Tensor,
                 window_size: int = 11) -> torch.Tensor:
    """Per-image SSIM of (S, h, w, C) stacks (each image windowed on its
    own, like vmap(ssim)); returns (S,)."""
    s, h, w, c = img1.shape
    bh = _band_matrix(h, window_size, img1.device)
    bw = _band_matrix(w, window_size, img1.device)
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], -1)
    cs = 5 * c
    tmp = torch.einsum("ij,sjk->sik", bh, stack.reshape(s, h, w * cs))
    tmp = tmp.reshape(s, h, w, cs)
    blurred = torch.einsum("shwc,wv->shvc", tmp, bw)
    mu1, mu2 = blurred[..., :c], blurred[..., c:2 * c]
    m11, m22, m12 = (blurred[..., 2 * c:3 * c], blurred[..., 3 * c:4 * c],
                     blurred[..., 4 * c:])
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = torch.clamp(m11 - mu1_sq, min=0.0)
    sigma2_sq = torch.clamp(m22 - mu2_sq, min=0.0)
    sigma12 = m12 - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.clamp(ssim_map, -1.0, 1.0).mean(dim=(1, 2, 3))


def _ssim_cs(img1: torch.Tensor, img2: torch.Tensor, window_size: int):
    """Per-channel mean SSIM and contrast-structure over the valid region
    (no-padding window statistics, pytorch_msssim's convention): the
    zero-padded blur cropped by the window's half width."""
    if img1.dim() == 2:
        img1, img2 = img1[..., None], img2[..., None]
    half = window_size // 2
    h, w = img1.shape[:2]
    mu1, mu2, m11, m22, m12 = (x[half:h - half, half:w - half] for x in
                               _window_stats(img1, img2, window_size))
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    sigma1_sq = m11 - mu1 * mu1
    sigma2_sq = m22 - mu2 * mu2
    sigma12 = m12 - mu1 * mu2
    cs_map = (2 * sigma12 + C2) / (sigma1_sq + sigma2_sq + C2)
    ssim_map = ((2 * mu1 * mu2 + C1) / (mu1 * mu1 + mu2 * mu2 + C1)) * cs_map
    return ssim_map.mean((0, 1)), cs_map.mean((0, 1))


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool, zero padding on odd dims counted in the
    mean (F.avg_pool2d(x, 2, padding=dim % 2))."""
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1).permute(2, 0, 1)[None]
    y = torch.nn.functional.avg_pool2d(x, 2, padding=(h % 2, w % 2),
                                       count_include_pad=True)
    return y[0].permute(1, 2, 0).reshape(y.shape[2:] + img.shape[2:])


# Standard 5-scale MS-SSIM weights (Wang et al. 2003; pytorch_msssim).
MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor,
            window_size: int = 11) -> torch.Tensor:
    """Multi-scale SSIM over an (H, W[, C]) pair in [0, 1] (pytorch_msssim's
    algorithm: cs at scales 1-4, SSIM at scale 5, relu'd, weighted
    product). Needs min(H, W) > (window_size - 1) * 16."""
    vals = []
    for lvl in range(5):
        s, cs = _ssim_cs(img1, img2, window_size)
        vals.append(s if lvl == 4 else cs)
        if lvl < 4:
            img1, img2 = _avg_pool2(img1), _avg_pool2(img2)
    vals = torch.relu(torch.stack(vals))                     # (5, C)
    w = torch.tensor(MSSSIM_WEIGHTS, device=vals.device)[:, None]
    return torch.prod(vals ** w, dim=0).mean()


def isotropic_loss(log_scales: torch.Tensor, alive: torch.Tensor):
    """Mean |s - mean(s)| over alive gaussians."""
    scales = torch.exp(log_scales)
    mean_s = scales.mean(-1, keepdim=True)
    per_g = torch.abs(scales - mean_s).mean(-1)
    w = alive.to(per_g.dtype)
    return (per_g * w).sum() / torch.clamp(w.sum(), min=1.0)


def psnr(pred: torch.Tensor, gt: torch.Tensor):
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
