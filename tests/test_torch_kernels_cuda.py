"""The K1 / K2 CUDA kernels against their plain PyTorch twins, on the card.

These tests need a CUDA card and skip without one. This file imports no JAX
(the GPU host has none), so it runs there without the repository's
conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances (those of chip_smoke.py): colour / alpha 1e-3 absolute, survivor
counts and columns exact, grads 1e-3 of each row's largest |grad| (the
kernel sums in another order and adds across tiles with atomics).
"""
import numpy as np
import pytest
import torch

from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.ops.rasterizer import (RasterConfig, _sorted_attrs,
                                            _v2_radius_cap, project_gaussians)

pytestmark = pytest.mark.cuda

CAM = Camera(fx=90.0, fy=90.0, cx=63.5, cy=47.5, width=128, height=96)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda")


def _inputs(tile, seg_cap, n, device, seed=0):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = {k: torch.as_tensor(v, device=device) for k, v in dict(
        means=means, q=q,
        ls=np.log(rng.uniform(0.01, 0.06, (n, 3))).astype(np.float32),
        op=rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32),
        col=rng.uniform(0, 1, (n, 3)).astype(np.float32)).items()}
    cfg = RasterConfig(tile=tile, dup_side=3, seg_cap=seg_cap, bands=3)
    proj = project_gaussians(t["means"], t["q"], t["ls"], t["op"],
                             torch.eye(4, device=device), CAM, cfg,
                             radius_cap=_v2_radius_cap(cfg))
    attrs, ss, sc = _sorted_attrs(proj, t["col"], CAM, cfg)
    tiles_x = -(-CAM.width // tile)
    tiles_y = -(-CAM.height // tile)
    return attrs.contiguous(), ss, sc, tiles_x, tiles_x * tiles_y


@pytest.mark.parametrize("tile,seg_cap,n", [(16, 256, 600), (32, 1024, 1500),
                                            (64, 1024, 1500), (16, 128, 1500)])
def test_kernels_match_twins_on_card(tile, seg_cap, n, cuda_device):
    """Full frame and a shuffled tile subset, at tile 16 / 32 / 64 and with
    overflowing bands (seg_cap 128)."""
    attrs, ss, sc, tx, num_tiles = _inputs(tile, seg_cap, n, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(tile)
    for ids in (torch.arange(num_tiles, dtype=torch.int32,
                             device=cuda_device),
                torch.randperm(num_tiles, generator=gen,
                               device=cuda_device)[: max(1, num_tiles // 3)]
                .to(torch.int32)):
        args = (attrs, ss, sc, ids, tile, tx, 3, seg_cap)
        ok, ck = cs.composite_sorted_fwd(*args)
        ot, ct = cs.composite_sorted_fwd_plain(*args)
        torch.cuda.synchronize()
        assert (ok[:, :5] - ot[:, :5]).abs().max() < 1e-3
        assert torch.equal(ok[:, 7], ot[:, 7])
        n_surv = ot[:, 7, 0].long()
        lane = torch.arange(ck.shape[1], device=cuda_device)
        m = lane[None, :] < n_surv[:, None]
        assert torch.equal(ck[m], ct[m])
        assert int(n_surv.max()) > 0
        dout = torch.randn(ot.shape, generator=gen, device=cuda_device)
        dout[:, 5:] = 0
        gk = cs.composite_sorted_bwd(attrs, ids, ok, ck, dout, tile, tx)
        gt = cs.composite_sorted_bwd_plain(attrs, ids, ot, ct, dout, tile, tx)
        torch.cuda.synchronize()
        for r in range(10):
            scale = float(gt[r].abs().max())
            assert float((gk[r] - gt[r]).abs().max()) <= 1e-3 * scale + 1e-9
        assert float(gk[10:].abs().max()) == 0.0


def test_autograd_function_launches_kernels(cuda_device):
    """CompositeSorted on CUDA tensors launches K1 and K2 once each and
    never calls a twin."""
    attrs, ss, sc, tx, num_tiles = _inputs(32, 1024, 800, cuda_device)
    a = attrs.clone().requires_grad_(True)
    ids = torch.arange(num_tiles, dtype=torch.int32, device=cuda_device)
    cs.reset_counts()
    out = cs.composite_sorted(a, ss, sc, ids, 32, tx, 3, 1024)
    out[:, :5].sum().backward()
    torch.cuda.synchronize()
    assert cs.counts() == {"fwd_launches": 1, "bwd_launches": 1,
                           "fwd_twin_calls": 0, "bwd_twin_calls": 0}
    assert torch.isfinite(a.grad).all() and float(a.grad.abs().max()) > 0
