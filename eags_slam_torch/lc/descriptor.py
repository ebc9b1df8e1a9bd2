"""Global image descriptor for place recognition (port of
`eags_slam_tpu.lc.descriptor`): `GlobalDesc`, NetVLAD when its weights are
present (`lc/netvlad.py`), else `global_descriptor`, a training-free
GIST/HOG-style vector (8-bin Sobel orientation histograms on an 8x8 grid,
mean colour and gray on the same grid, a 4x4 luminance layout), each block
mean-centred, padded to `dim` and L2-normalised. Computed for every mapped
frame and cached into the submap file.

The resizes reproduce `jax.image.resize(..., "linear")` (triangle kernel,
antialiased when downsampling) as separable weight matrices.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops.image import rgb_to_gray, sobel


@functools.lru_cache(maxsize=32)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) weights of jax.image.resize's linear (triangle) kernel."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(
        inv_scale) - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[
        :, None]) / np.float32(kernel_scale)
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def _resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W[, C]) -> (out_h, out_w[, C])."""
    h, w = img.shape[:2]
    out = img
    if out_w != w:
        ww = torch.as_tensor(_resize_weights(w, out_w), device=img.device)
        out = torch.einsum("hw...,wo->ho...", out, ww)
    if out_h != h:
        wh = torch.as_tensor(_resize_weights(h, out_h), device=img.device)
        out = torch.einsum("h...,ho->o...", out, wh)
    return out


@torch.no_grad()
def global_descriptor(rgb: torch.Tensor, dim: int = 1024) -> torch.Tensor:
    """rgb (H, W, 3) float in [0, 1] -> (dim,) unit descriptor."""
    small = _resize_linear(rgb, 64, 64)
    gray = rgb_to_gray(small * 255.0)
    gx, gy = sobel(gray)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    nbins = 8
    bin_idx = torch.clamp(((ang + math.pi) / (2 * math.pi) * nbins).long(),
                          0, nbins - 1)
    # Each 8 x 8 cell's histogram: its 64 pixels' magnitudes summed per bin
    # over one fixed axis (a float index_add_ adds with atomics on CUDA, in
    # the blocks' order). hog[cell * nbins + bin], cells row-major.
    onehot = (bin_idx[..., None] == torch.arange(nbins, device=rgb.device))
    per_px = (mag[..., None] * onehot.to(mag.dtype)).reshape(8, 8, 8, 8,
                                                             nbins)
    hog = per_px.permute(0, 2, 1, 3, 4).reshape(64, 64, nbins).sum(1) \
        .reshape(-1)
    hog = hog / torch.clamp(torch.linalg.norm(hog), min=1e-6)
    color_grid = _resize_linear(small, 8, 8).reshape(-1)
    gray_grid = _resize_linear(gray, 8, 8).reshape(-1) / 255.0
    layout = _resize_linear(gray, 4, 4).reshape(-1) / 255.0

    def center(f):
        return f - f.mean()

    feats = torch.cat([center(hog), center(color_grid), center(gray_grid),
                       center(layout)])
    if feats.shape[0] < dim:
        feats = torch.nn.functional.pad(feats, (0, dim - feats.shape[0]))
    else:
        feats = feats[:dim]
    return feats / torch.clamp(torch.linalg.norm(feats), min=1e-6)


class GlobalDesc:
    """The loop closer's descriptor: VGG16 + NetVLAD when
    `weights/netvlad.npz` is present (the reference's hloc NetVLAD,
    4096-d), else the HOG stand-in above (1024-d). Both are unit vectors
    compared by dot product. Images are described on `device`."""

    def __init__(self, dim: int = 1024, device="cpu"):
        from . import netvlad

        self.device = torch.device(device)
        self._net = netvlad.load() is not None
        self.dim = 4096 if self._net else dim

    def __call__(self, rgb) -> torch.Tensor:
        """rgb (H, W, 3) in [0, 1], numpy or tensor -> (dim,) tensor."""
        if self._net:
            from . import netvlad

            return netvlad.describe(rgb, device=self.device)
        rgb = torch.as_tensor(rgb, dtype=torch.float32, device=self.device)
        return global_descriptor(rgb, self.dim)
