"""LPIPS(alex) perceptual metric, gated on pretrained weights (port of
eags_slam_tpu.evaluation.lpips).

The repo ships no AlexNet / LPIPS checkpoint: place one at
`weights/lpips_alex.npz` (keys conv{1..5}_w (OIHW), conv{1..5}_b,
lin{1..5}_w) and `lpips()` computes the metric; without the file it returns
None and the evaluator reports `mean_lpips: null`. The network: the AlexNet
feature trunk (five ReLU maps, 3x3 / stride-2 max pools after the first
two), each map unit-normalised over channels (floor 1e-10), squared
differences weighted by the 1x1 linear heads and averaged over pixels,
summed over the five maps. Convolutions run in float32 (no TF32) on the
images' device.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "..", "..",
                            "weights", "lpips_alex.npz")
# (stride, padding) of conv1..conv5.
_CONVS = ((4, 2), (1, 2), (1, 1), (1, 1), (1, 1))
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
_NETS: Dict[tuple, object] = {}


def _load(device: torch.device):
    """The weights on `device` (cached per path and device), or False
    without the file."""
    key = (os.path.abspath(WEIGHTS_PATH), str(device))
    if key not in _NETS:
        if not os.path.exists(WEIGHTS_PATH):
            return False
        with np.load(WEIGHTS_PATH) as z:
            _NETS[key] = {k: torch.as_tensor(np.asarray(z[k], np.float32),
                                             device=device)
                          for k in z.files}
    return _NETS[key]


def _alex_features(params, x):
    """The five ReLU feature maps of the AlexNet trunk, x (1, 3, H, W)."""
    feats = []
    for i, (stride, pad) in enumerate(_CONVS, start=1):
        if i in (2, 3):
            x = F.max_pool2d(x, 3, 2)
        x = F.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                            stride=stride, padding=pad))
        feats.append(x)
    return feats


def _prep(im: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(_MEAN, dtype=torch.float32, device=im.device)
    std = torch.tensor(_STD, dtype=torch.float32, device=im.device)
    return ((im.to(torch.float32) - mean) / std).permute(2, 0, 1)[None]


@torch.no_grad()
def lpips(img1, img2) -> Optional[float]:
    """LPIPS(alex) between (H, W, 3) images in [0, 1] (tensors, or arrays
    taken to the CPU); None without the weights file."""
    img1, img2 = torch.as_tensor(img1), torch.as_tensor(img2)
    params = _load(img1.device)
    if params is False:
        return None
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        f1 = _alex_features(params, _prep(img1))
        f2 = _alex_features(params, _prep(img2.to(img1.device)))
    total = torch.zeros((), dtype=torch.float32, device=img1.device)
    for i, (a, b) in enumerate(zip(f1, f2), start=1):
        na = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True),
                             min=1e-10)
        nb = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True),
                             min=1e-10)
        w = params[f"lin{i}_w"].reshape(1, -1, 1, 1)
        total = total + torch.mean(torch.sum((na - nb) ** 2 * w, dim=1))
    return float(total)
