"""K3's run length, `composite_sorted.window_run`: one tile a cluster,
never above `group` (the SLAM's `raster_group`), since runs of 2 and 6
measured slower than runs of 1 on the 836-tile grid. On CPU tensors the K3
call takes K2's twin, its plain version, and counts `window_twin_calls`."""
import numpy as np
import torch

from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.ops.rasterizer import (RasterConfig, _sorted_attrs,
                                            _v2_radius_cap,
                                            project_gaussians)


def test_run_is_one_tile():
    assert cs.window_run() == 1


def test_cpu_tensors_take_the_k2_twin():
    rng = np.random.default_rng(0)
    n = 300
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cam = Camera(60.0, 60.0, 31.5, 23.5, 64, 48)
    cfg = RasterConfig(tile=16, dup_side=3, seg_cap=256, bands=3)
    proj = project_gaussians(
        torch.as_tensor(means), torch.as_tensor(q),
        torch.as_tensor(np.log(rng.uniform(0.02, 0.07, (n, 3)))
                        .astype(np.float32)),
        torch.as_tensor(rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32)),
        torch.eye(4), cam, cfg, radius_cap=_v2_radius_cap(cfg))
    attrs, ss, sc = _sorted_attrs(
        proj, torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
        cam, cfg)
    attrs = attrs.contiguous()
    ids = torch.tensor([5, 0, 3, 3, 1, 11], dtype=torch.int32)
    out, cols = cs.composite_sorted_fwd(attrs, ss, sc, ids, 16, 4, 3, 256)
    dout = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32))
    dout[:, 5:] = 0
    cs.reset_counts()
    g = cs.composite_sorted_bwd_window(attrs, ss, ids, out, cols, dout, 16,
                                       4, 3, 256, 8)
    c = cs.counts()
    assert (c["window_twin_calls"], c["bwd_twin_calls"],
            c["window_launches"]) == (1, 0, 0)
    assert float(g[:10].abs().max()) > 0
    assert torch.equal(g, cs.composite_sorted_bwd_plain(
        attrs, ids, out, cols, dout, 16, 4, 3))
