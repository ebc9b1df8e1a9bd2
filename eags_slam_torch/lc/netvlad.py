"""NetVLAD global descriptor (port of eags_slam_tpu.lc.netvlad), gated on
pretrained weights.

The reference uses hloc's NetVLAD: a VGG16 trunk through conv5_3, NetVLAD
pooling over 64 clusters and a PCA whitening to 4096 dimensions. The repo
ships no checkpoint: the architecture activates when a weights file sits at
`weights/netvlad.npz` (`scripts/convert_netvlad.py` writes one), and
otherwise `load()` returns None and loop closure describes frames with the
training-free HOG stand-in (`lc/descriptor.py`).

npz keys: conv{1..13}_w (OIHW), conv{1..13}_b, assign_w (K, D, 1, 1),
assign_b (K,), centroids (K, D), pca_w (out, K * D), pca_b (out,).
"""
from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "..", "..",
                             "weights", "netvlad.npz")
_NET = None                 # None: not looked for; False: gate closed
_ON_DEVICE = {}             # device -> the weights on that device
_LOCK = threading.Lock()

# VGG16 conv layout: (out_channels, maxpool_after)
_VGG = [
    (64, False), (64, True),
    (128, False), (128, True),
    (256, False), (256, False), (256, True),
    (512, False), (512, False), (512, True),
    (512, False), (512, False), (512, False),  # conv5_3, no final pool
]
_RGB_MEAN = np.array([123.68, 116.779, 103.939], np.float32)


def load(path: Optional[str] = None):
    """The weights dict (host tensors), or None when the gate is closed."""
    global _NET
    with _LOCK:
        if _NET is None:
            p = path or _WEIGHTS_PATH
            if os.path.exists(p):
                z = np.load(p)
                _NET = {k: torch.as_tensor(z[k]) for k in z.files}
            else:
                _NET = False
            _ON_DEVICE.clear()
        return _NET if _NET is not False else None


def _weights_on(device: torch.device):
    with _LOCK:
        if device not in _ON_DEVICE:
            _ON_DEVICE[device] = {k: v.to(device) for k, v in _NET.items()}
        return _ON_DEVICE[device]


def _forward(net, rgb255: torch.Tensor) -> torch.Tensor:
    """rgb255 (H, W, 3) float in [0, 255] -> unit descriptor."""
    x = (rgb255 - torch.as_tensor(_RGB_MEAN, device=rgb255.device))[None]
    x = x.permute(0, 3, 1, 2)
    for i, (_, pool) in enumerate(_VGG):
        x = F.relu(F.conv2d(x, net[f"conv{i + 1}_w"], net[f"conv{i + 1}_b"],
                            padding=1))
        if pool:
            x = F.max_pool2d(x, 2, 2)
    d = x.shape[1]
    f = x[0].reshape(d, -1).T                                  # (P, D)
    f = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True),
                        min=1e-12)
    aw = net["assign_w"].reshape(net["assign_w"].shape[0], d)  # (K, D)
    a = torch.softmax(f @ aw.T + net["assign_b"][None, :], dim=-1)
    vlad = a.T @ f - a.sum(0)[:, None] * net["centroids"]      # (K, D)
    vlad = vlad / torch.clamp(torch.linalg.norm(vlad, dim=-1, keepdim=True),
                              min=1e-12)
    v = vlad.reshape(-1)
    v = v / torch.clamp(torch.linalg.norm(v), min=1e-12)
    out = net["pca_w"] @ v + net["pca_b"]
    return out / torch.clamp(torch.linalg.norm(out), min=1e-12)


@torch.no_grad()
def describe(rgb01, resize_max: int = 1024, device=None) -> torch.Tensor:
    """Image (H, W, 3) in [0, 1] -> unit descriptor, on `device` (default:
    the image's device)."""
    from .descriptor import _resize_linear

    if load() is None:
        raise RuntimeError("netvlad weights are not loaded")
    img = torch.as_tensor(np.asarray(rgb01) if not torch.is_tensor(rgb01)
                          else rgb01, dtype=torch.float32, device=device)
    img = img * 255.0
    h, w = img.shape[:2]
    m = max(h, w)
    if m > resize_max:
        s = resize_max / m
        img = _resize_linear(img, int(round(h * s)), int(round(w * s)))
    return _forward(_weights_on(img.device), img)
