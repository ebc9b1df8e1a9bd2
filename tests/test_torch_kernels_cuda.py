"""The CUDA kernels against their plain PyTorch twins, on the card: K1 /
K2 / K4, K4's whole path against the K2 + autograd chain, K3 against K2's
twin and K2 on the hazard scenes of the windowed backward, and K5 / K6 on
the entry-binned layout (full frame and frozen binning). K1 and K2 cull
with an alpha box per survivor and split tiles over warp patches (K2 also
over blocks): their cases add the 1/8 tile subset with shuffled and
repeated ids, tiles 16 / 32 / 64, and a cull hazard scene (radius-capped
survivors, opacity at and just above 1/255 and near 1, near-singular and
elongated conics, means on and just off patch borders), each with K3 and
K4 held against K2's twin on the new K1's columns. K3 also runs at runs of
1, 4 and 8 tiles a cluster on every window and cull case, ids ascending
and shuffled, and K6 on the cull hazard scene binned as entries and on a
grid with more tiles than SMs. K4 runs on K2's grid and K5 on K1's block
sizes: K4 at tiles 16 / 32 / 64 on both of K2's block sizes, twice bit for
bit and against the K2 chain; K5 at the same tiles and block sizes on a
scene whose tiles stop at the -11.5 threshold, with K6 on its outputs.
K1 and K2 also run at the loop closer's shape (tile 16 on 600x340, a
65,536-gaussian map, the full 836-tile grid and a shuffled 209-tile
quarter), at the TUM RGB-D map camera's (tile 32 on 540x380, the
204-tile grid and a 51-tile quarter) and at the global refine's (tile 16
on the full 1200x680 image, 3225 tiles, 300,000 and 1,200,000 gaussians),
and a render on a
tagged stream counts its launches apart from the main path's. The
kernel_quadform / kernel_bf16 variants of K1-K4 run on the K1 / K2 cases
(tiles 16 / 32 / 64, the wide grid, the 1/8 subset with repeats, the cull
hazard scene) against their twins under the same option, K4 twice bit for
bit, each launch counted under its variant; the autograd Function and the
frozen-sorted K4 path take the options from their arguments.

These tests need a CUDA card and skip without one. This file imports no JAX
(the GPU host has none), so it runs there without the repository's
conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances (those of chip_smoke.py): colour / alpha 1e-3 absolute, survivor
counts and columns exact, grads 1e-3 of each row's largest |grad| (the
kernel sums in another order and adds across tiles with atomics); K4's
dpose and the K4 path against the K2 chain 1e-3 of the largest |dpose|.
K4 and K6 use no atomics: two runs are equal bit for bit.
"""
import numpy as np
import pytest
import torch

from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops import composite_entries as ce
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.ops import rasterizer as R
from eags_slam_torch.ops.rasterizer import (RasterConfig, _Projected,
                                            _sorted_attrs, _v2_radius_cap,
                                            project_gaussians)
from eags_slam_torch.slam.tracker import _rel_matrix

pytestmark = pytest.mark.cuda

CAM = Camera(fx=90.0, fy=90.0, cx=63.5, cy=47.5, width=128, height=96)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda")


def _scene(n, device, seed):
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
    return t


def _inputs(tile, seg_cap, n, device, seed=0):
    t = _scene(n, device, seed)
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
                           "window_launches": 0, "pose_launches": 0,
                           "fwd_twin_calls": 0, "bwd_twin_calls": 0,
                           "window_twin_calls": 0, "pose_twin_calls": 0}
    assert torch.isfinite(a.grad).all() and float(a.grad.abs().max()) > 0


@pytest.mark.parametrize("tile,seg_cap,n", [(16, 256, 600), (32, 1024, 1500),
                                            (16, 128, 1500)])
def test_pose_kernel_matches_twin_and_k2_chain(tile, seg_cap, n,
                                               cuda_device):
    """K4 against its twin on K1's residuals (full grid and a shuffled
    subset), twice bit for bit, then the K4 path against the K2 + autograd
    chain on one loss; the K4 path launches K1 and K4 once each and no
    twin."""
    _check_pose_kernel(tile, seg_cap, n, CAM, cuda_device)


def _check_pose_kernel(tile, seg_cap, n, cam, cuda_device):
    t = _scene(n, cuda_device, 1)
    cfg = RasterConfig(tile=tile, dup_side=3, seg_cap=seg_cap, bands=3)
    last_w2c = torch.eye(4, device=cuda_device)
    last_w2c[0, 3] = 0.03
    fs = R.freeze_sorted(t["means"], t["q"], t["ls"], t["op"], t["col"],
                         last_w2c, cam, cfg)
    pv = torch.tensor([0.999, 0.01, -0.02, 0.015, 0.01, -0.02, 0.03],
                      device=cuda_device)
    tx = -(-cam.width // tile)
    num_tiles = tx * -(-cam.height // tile)
    gen = torch.Generator(device=cuda_device).manual_seed(tile)
    for ids in (torch.arange(num_tiles, dtype=torch.int32,
                             device=cuda_device),
                torch.randperm(num_tiles, generator=gen,
                               device=cuda_device)[: max(1, num_tiles // 3)]
                .to(torch.int32)):
        with torch.no_grad():
            attrs = R._stack_reproj_rows(fs.e3d, R._pose_rel_w2c(pv, last_w2c),
                                         cam, cfg).contiguous()
            out, cols = cs.composite_sorted_fwd(attrs, fs.seg_start,
                                                fs.seg_cnt, ids, tile, tx, 3,
                                                seg_cap)
            jac = R._pose_jacobian(fs.e3d, pv, last_w2c, cam, cfg)
        dout = torch.randn(out.shape, generator=gen, device=cuda_device)
        dout[:, 5:] = 0
        gk = cs.pose_grad_sorted(attrs, jac, ids, out, cols, dout, tile, tx)
        gt = cs.pose_grad_sorted_plain(attrs, jac, ids, out, cols, dout,
                                       tile, tx)
        gk2 = cs.pose_grad_sorted(attrs, jac, ids, out, cols, dout, tile, tx)
        torch.cuda.synchronize()
        scale = float(gt.abs().max())
        assert scale > 0
        assert float((gk - gt).abs().max()) <= 1e-3 * scale
        assert torch.equal(gk, gk2)            # no atomics: run to run equal

        def loss(o):
            return (o.color.sum() + 0.3 * o.depth.sum() + (o.alpha ** 2).sum()
                    + (o.color * o.color).sum())

        qt = pv.clone().requires_grad_(True)
        cs.reset_counts()
        (d4,) = torch.autograd.grad(loss(R.render_frozen_sorted_tiles_pose(
            fs, qt, last_w2c, ids, cam, cfg)), qt)
        torch.cuda.synchronize()
        assert cs.counts() == {"fwd_launches": 1, "bwd_launches": 0,
                               "window_launches": 0, "pose_launches": 1,
                               "fwd_twin_calls": 0, "bwd_twin_calls": 0,
                               "window_twin_calls": 0, "pose_twin_calls": 0}
        (d2,) = torch.autograd.grad(loss(R.render_frozen_sorted_tiles(
            fs, last_w2c @ _rel_matrix(qt[:4], qt[4:]), ids, cam, cfg)), qt)
        scale = float(d2.abs().max())
        assert float((d4 - d2).abs().max()) <= 1e-3 * scale


def _grads_close(gk, gt):
    for r in range(10):
        scale = float(gt[r].abs().max())
        assert float((gk[r] - gt[r]).abs().max()) <= 1e-3 * scale + 1e-9, r
    assert float(gk[10:].abs().max()) == 0.0


# (tile, seg_cap, gaussians, group, tile ids): the hazard scenes of
# tests/test_rasterizer_v2.py's test_window_rmw_*.
WINDOW_CASES = {
    "full_group2": (16, 256, 600, 2, "full"),
    "full_group8_t32": (32, 1024, 1500, 8, "full"),
    "overflow_seg128": (16, 128, 1500, 4, "full"),
    "shuffled_repeated": (16, 128, 800, 3, "shuffled"),
    "sparse": (16, 256, 6, 2, "full"),
    "tile64_one_run": (64, 1024, 1500, 64, "full"),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_kernel_matches_k2(case, cuda_device):
    """K3 against K2's twin (its plain version) and against K2, on K1's
    residuals; the autograd route with rmw_window launches K1 and K3."""
    tile, seg_cap, n, group, ids_kind = WINDOW_CASES[case]
    attrs, ss, sc, tx, num_tiles = _inputs(tile, seg_cap, n, cuda_device)
    ids = torch.arange(num_tiles, dtype=torch.int32, device=cuda_device)
    if ids_kind == "shuffled":
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        p = torch.randperm(num_tiles, generator=gen, device=cuda_device)
        ids = torch.cat([p[:3], p[2:3], p[3:], p[:2]]).to(torch.int32)
    ok, ck = cs.composite_sorted_fwd(attrs, ss, sc, ids, tile, tx, 3,
                                     seg_cap)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    dout = torch.randn(ok.shape, generator=gen, device=cuda_device)
    dout[:, 5:] = 0
    g3 = cs.composite_sorted_bwd_window(attrs, ss, ids, ok, ck, dout, tile,
                                        tx, 3, seg_cap, group)
    g2 = cs.composite_sorted_bwd(attrs, ids, ok, ck, dout, tile, tx)
    gt = cs.composite_sorted_bwd_plain(attrs, ids, ok, ck, dout, tile, tx)
    torch.cuda.synchronize()
    assert float(gt[:10].abs().max()) > 0
    _grads_close(g3, gt)
    _grads_close(g3, g2)
    a = attrs.clone().requires_grad_(True)
    cs.reset_counts()
    out = cs.composite_sorted(a, ss, sc, ids, tile, tx, 3, seg_cap, group,
                              rmw_window=True)
    (out[:, :5] * dout[:, :5]).sum().backward()
    torch.cuda.synchronize()
    c = cs.counts()
    assert (c["fwd_launches"], c["window_launches"], c["bwd_launches"]) == \
        (1, 1, 0)
    assert c["fwd_twin_calls"] == c["window_twin_calls"] == 0
    _grads_close(a.grad, gt)


def _entry_inputs(tile, n, max_per_tile, device, seed=0, w2c=None):
    t = _scene(n, device, seed)
    cfg = RasterConfig(tile=tile, dup_side=3, max_per_tile=max_per_tile,
                       backend="pallas")
    w2c = torch.eye(4, device=device) if w2c is None else w2c
    proj = project_gaussians(t["means"], t["q"], t["ls"], t["op"], w2c, CAM,
                             cfg)
    slot, pstart, count = R._build_slots(proj, CAM, cfg)
    entries = R._gather_entries(R._with_sentinel(R._stack_attrs(
        proj, t["col"])), slot).contiguous()
    return t, cfg, entries, pstart, count, -(-CAM.width // tile)


def _check_entries(entries, pstart, count, tile, tx, device):
    out_k = ce.composite_entries_fwd(entries, pstart, count, tile, tx)
    out_t = ce.composite_entries_fwd_plain(entries, pstart, count, tile, tx)
    torch.cuda.synchronize()
    assert (out_k[:, :5] - out_t[:, :5]).abs().max() < 1e-3
    assert torch.equal(out_k[:, 7], out_t[:, 7])
    assert float((out_k[:, 6] != out_t[:, 6]).float().mean()) <= 5e-3
    gen = torch.Generator(device=device).manual_seed(3)
    dout = torch.randn(out_t.shape, generator=gen, device=device)
    dout[:, 5:] = 0
    gk = ce.composite_entries_bwd(entries, pstart, count, out_k, dout, tile,
                                  tx)
    gk2 = ce.composite_entries_bwd(entries, pstart, count, out_k, dout, tile,
                                   tx)
    gt = ce.composite_entries_bwd_plain(entries, pstart, count, out_k, dout,
                                        tile, tx)
    torch.cuda.synchronize()
    assert float(gt[:10].abs().max()) > 0
    _grads_close(gk, gt)
    assert torch.equal(gk, gk2)                # no atomics: run to run equal
    visited = torch.zeros(entries.shape[1], dtype=torch.bool, device=device)
    eff = out_k[:, 6, 0].long()
    for t in range(pstart.shape[0]):
        p0 = int(pstart[t])
        visited[p0: p0 + 128 * int(eff[t])] = True
    assert float(gk[:, ~visited].abs().max()) == 0.0
    return out_k


@pytest.mark.parametrize("tile,n,max_per_tile", [(16, 600, 8192),
                                                 (32, 1500, 8192),
                                                 (64, 1500, 8192),
                                                 (16, 1500, 256)])
def test_entry_kernels_match_twins_on_card(tile, n, max_per_tile,
                                           cuda_device):
    """K5 / K6 against their twins on the entry layout of a full frame
    (and with max_per_tile clipping tiles), K6 twice bit for bit, zeros in
    the columns K5 did not composite; the autograd route launches K5 and
    K6 once each and no twin."""
    _, _, entries, pstart, count, tx = _entry_inputs(tile, n, max_per_tile,
                                                     cuda_device)
    _check_entries(entries, pstart, count, tile, tx, cuda_device)
    e = entries.clone().requires_grad_(True)
    ce.reset_counts()
    out = ce.composite_entries(e, pstart, count, tile, tx)
    out[:, :5].sum().backward()
    torch.cuda.synchronize()
    assert ce.counts() == {"entries_fwd_launches": 1,
                           "entries_bwd_launches": 1,
                           "entries_fwd_twin_calls": 0,
                           "entries_bwd_twin_calls": 0}


def test_entry_kernels_on_frozen_binning(cuda_device):
    """K5 / K6 on the frozen-binning layout reprojected at a shifted
    tracking pose, and the frozen render's pose gradient through K6 against
    the twins' on the CPU (1e-3 of the largest |grad|)."""
    t = _scene(1500, cuda_device, 2)
    cfg = RasterConfig(tile=32, dup_side=3, backend="pallas")
    fb = R.freeze_binning(t["means"], t["q"], t["ls"], t["op"], t["col"],
                          torch.eye(4, device=cuda_device), CAM, cfg)
    w2c = torch.eye(4, device=cuda_device)
    w2c[:3, 3] = torch.tensor([0.01, -0.008, 0.02], device=cuda_device)
    rows = R._reproject_rows(fb.e3d, w2c, CAM, cfg)
    entries = torch.cat([torch.stack(rows[:10]), torch.zeros(
        (6, fb.e3d.shape[1]), device=cuda_device)]).contiguous()
    tx = -(-CAM.width // 32)
    _check_entries(entries, fb.pstart, fb.count, 32, tx, cuda_device)

    def pose_grad(dev):
        fbd = R.FrozenBinning(*(x.to(dev) for x in fb))
        w = w2c.to(dev).clone().requires_grad_(True)
        o = R.render_frozen(fbd, w, CAM, cfg)
        loss = (o.color ** 2).mean() + 0.1 * o.depth.mean() + o.alpha.mean()
        return torch.autograd.grad(loss, w)[0].cpu()

    gk, gt = pose_grad(cuda_device), pose_grad("cpu")
    assert float((gk - gt).abs().max()) <= 1e-3 * float(gt.abs().max())


# Wider than CAM so that the 1/8 tile subset holds several tiles.
CAM2 = Camera(fx=180.0, fy=180.0, cx=127.5, cy=95.5, width=256, height=192)


def _hazard_proj(tile, seg_cap, n, device, seed=0):
    """The cull's hazards, built as projected gaussians: a third large
    enough that `_v2_radius_cap` clips their radius; opacity uniform, at
    1/255 and just above it, or within 1e-6-1e-2 of 1; axis ratios up to
    1e3 at random angles, some conics within float32 of singular; means on
    patch borders (multiples of 4 and 8), half a pixel off them, or 1e-3 px
    outside them; and a stack of near-opaque gaussians that drives T far
    below 2^-64, where the kernels rescale it. Returns (proj, colours)."""
    rng = np.random.default_rng(seed)
    cfg = RasterConfig(tile=tile, dup_side=3, seg_cap=seg_cap, bands=3)
    cap = _v2_radius_cap(cfg)
    s1 = np.where(rng.uniform(size=n) < 1 / 3, rng.uniform(12.0, 40.0, n),
                  rng.uniform(0.4, 6.0, n))
    s2 = s1 / np.exp(rng.uniform(0.0, np.log(1e3), n))
    th = rng.uniform(0.0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    cxx = c * c * s1 ** 2 + s * s * s2 ** 2
    cyy = s * s * s1 ** 2 + c * c * s2 ** 2
    cxy = c * s * (s1 ** 2 - s2 ** 2)
    det = cxx * cyy - cxy * cxy
    conic = np.stack([cyy / det, -cxy / det, cxx / det], 1)
    sing = rng.uniform(size=n) < 0.1          # b^2 within float32 of a c
    conic[sing, 1] = np.sign(conic[sing, 1] + 1e-30) * np.sqrt(
        conic[sing, 0] * conic[sing, 2]) * (1.0 - 1e-7)
    lo = np.float32(1.0 / 255.0)
    kind = rng.integers(0, 4, n)
    op = np.where(kind == 0, rng.uniform(0.0, 1.0, n), np.where(
        kind == 1, lo * (1.0 + 10.0 ** rng.uniform(-7, -2, n)), np.where(
            kind == 2, 1.0 - 10.0 ** rng.uniform(-6, -2, n), lo)))
    mu = rng.uniform(-20.0, CAM2.width + 20.0, n)
    mv = rng.uniform(-20.0, CAM2.height + 20.0, n)
    snap = rng.integers(0, 4, n)
    off = np.choose(snap, [np.zeros(n), np.full(n, 0.5), np.full(n, 1e-3),
                           np.full(n, -1e-3)])
    mu = np.where(snap > 0, np.round(mu / 8.0) * 8.0 - 0.5 + off, mu)
    mv = np.where(snap > 0, np.round(mv / 4.0) * 4.0 - 0.5 + off, mv)
    stack = rng.uniform(size=n) < 0.1
    mu = np.where(stack, 100.0 + rng.uniform(-10.0, 10.0, n), mu)
    mv = np.where(stack, 80.0 + rng.uniform(-10.0, 10.0, n), mv)
    op = np.where(stack, 0.999, op)
    radius = np.minimum(np.ceil(3.0 * s1), cap)
    radius[rng.uniform(size=n) < 0.05] = 0.0
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    proj = _Projected(mean2d=f32(np.stack([mu, mv], 1)), conic=f32(conic),
                      depth=f32(rng.uniform(1.0, 3.0, n)), radius=f32(radius),
                      opacity=f32(op))
    assert bool((radius == cap).any()) and bool((op == lo).any())
    return proj, f32(rng.uniform(0, 1, (n, 3)))


def _hazard_inputs(tile, seg_cap, n, device, seed=0):
    """The hazard scene of `_hazard_proj` in the sorted layout."""
    proj, colors = _hazard_proj(tile, seg_cap, n, device, seed)
    cfg = RasterConfig(tile=tile, dup_side=3, seg_cap=seg_cap, bands=3)
    attrs, ss, sc = _sorted_attrs(proj, colors, CAM2, cfg)
    tiles_x = -(-CAM2.width // tile)
    return attrs.contiguous(), ss, sc, tiles_x, tiles_x * -(
        -CAM2.height // tile)


# More tiles at tile 32 (300) than an H100 has SMs (132): K1's wide grid.
CAM3 = Camera(fx=450.0, fy=450.0, cx=319.5, cy=239.5, width=640, height=480)


def _scene_inputs(tile, seg_cap, n, device, seed=0, cam=CAM2):
    t = _scene(n, device, seed)
    cfg = RasterConfig(tile=tile, dup_side=3, seg_cap=seg_cap, bands=3)
    proj = project_gaussians(t["means"], t["q"], t["ls"], t["op"],
                             torch.eye(4, device=device), cam, cfg,
                             radius_cap=_v2_radius_cap(cfg))
    attrs, ss, sc = _sorted_attrs(proj, t["col"], cam, cfg)
    tiles_x = -(-cam.width // tile)
    return attrs.contiguous(), ss, sc, tiles_x, tiles_x * -(
        -cam.height // tile)


def _fwd_close(out_k, cols_k, out_t, cols_t):
    """chip_smoke.py's K1 check: rgb / alpha 1e-3, depth 1e-3 + 1e-4 |d|,
    log T 1e-3 + 1e-4 |log T| where the twin's log T > -11.5, survivor
    counts, columns and chunks used exact."""
    for ch in range(6):
        d = (out_k[:, ch] - out_t[:, ch]).abs()
        ref = out_t[:, ch].abs()
        if ch == 3:
            bad = d > 1e-3 + 1e-4 * ref
        elif ch == 5:
            bad = (d > 1e-3 + 1e-4 * ref) & (out_t[:, 5] > -11.5)
        else:
            bad = d > 1e-3
        assert not bool(bad.any()), ch
    assert torch.equal(out_k[:, 6:], out_t[:, 6:])
    n_surv = out_t[:, 7, 0].long()
    lane = torch.arange(cols_k.shape[1], device=cols_k.device)
    m = lane[None, :] < n_surv[:, None]
    assert torch.equal(cols_k[m], cols_t[m])
    assert int(n_surv.max()) > 0


# (scene, tile, seg_cap, gaussians, tile ids): ids "full", or "eighth" (a
# shuffled 1/8 of the tiles with two of them repeated, the tracker's subset)
K12_CASES = {
    "t16_full": ("scene", 16, 256, 2400, "full"),
    "t32_eighth_repeated": ("scene", 32, 1024, 6000, "eighth"),
    "t32_wide_full": ("wide", 32, 1024, 30000, "full"),
    "t64_full": ("scene", 64, 1024, 6000, "full"),
    "hazard_t16": ("hazard", 16, 256, 2000, "full"),
    "hazard_t32": ("hazard", 32, 1024, 5000, "full"),
    "hazard_t32_eighth": ("hazard", 32, 1024, 5000, "eighth"),
    "hazard_t64": ("hazard", 64, 1024, 5000, "full"),
}


@pytest.mark.parametrize("case", list(K12_CASES))
def test_culling_kernels_match_twins(case, cuda_device):
    """K1 against its twin (survivors, columns, outputs, chunks used), K2
    against its twin (1e-3 of each row's max), and K3 (against K2's twin)
    and K4 (against its twin, with a random jacobian) on the new K1's
    residuals."""
    kind, tile, seg_cap, n, ids_kind = K12_CASES[case]
    if kind == "hazard":
        inputs = _hazard_inputs(tile, seg_cap, n, cuda_device)
    else:
        inputs = _scene_inputs(tile, seg_cap, n, cuda_device,
                               cam=CAM3 if kind == "wide" else CAM2)
    attrs, ss, sc, tx, num_tiles = inputs
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    ids = torch.arange(num_tiles, dtype=torch.int32, device=cuda_device)
    if ids_kind == "eighth":
        p = torch.randperm(num_tiles, generator=gen, device=cuda_device)[
            : max(2, round(num_tiles / 8))]
        ids = torch.cat([p, p[:2]])[torch.randperm(
            p.shape[0] + 2, generator=gen, device=cuda_device)].to(
                torch.int32)
    args = (attrs, ss, sc, ids, tile, tx, 3, seg_cap)
    out_k, cols_k = cs.composite_sorted_fwd(*args)
    out_t, cols_t = cs.composite_sorted_fwd_plain(*args)
    torch.cuda.synchronize()
    _fwd_close(out_k, cols_k, out_t, cols_t)
    dout = torch.randn(out_t.shape, generator=gen, device=cuda_device)
    dout[:, 5:] = 0
    g_t = cs.composite_sorted_bwd_plain(attrs, ids, out_t, cols_t, dout,
                                        tile, tx)
    assert float(g_t[:10].abs().max()) > 0
    _grads_close(cs.composite_sorted_bwd(attrs, ids, out_k, cols_k, dout,
                                         tile, tx), g_t)
    _grads_close(cs.composite_sorted_bwd_window(attrs, ss, ids, out_k,
                                                cols_k, dout, tile, tx, 3,
                                                seg_cap, 4), g_t)
    jac = torch.randn((cs.P_MAX * cs.PJ, attrs.shape[1]), generator=gen,
                      device=cuda_device)
    d_k = cs.pose_grad_sorted(attrs, jac, ids, out_k, cols_k, dout, tile, tx)
    d_t = cs.pose_grad_sorted_plain(attrs, jac, ids, out_t, cols_t, dout,
                                    tile, tx)
    torch.cuda.synchronize()
    assert float((d_k - d_t).abs().max()) <= 1e-3 * float(d_t.abs().max())


def _case_inputs(case, device):
    """(tile, seg_cap, inputs) of a WINDOW_CASES or K12_CASES entry."""
    if case in WINDOW_CASES:
        tile, seg_cap, n, _, _ = WINDOW_CASES[case]
        return tile, seg_cap, _inputs(tile, seg_cap, n, device)
    kind, tile, seg_cap, n, _ = K12_CASES[case]
    if kind == "hazard":
        return tile, seg_cap, _hazard_inputs(tile, seg_cap, n, device)
    return tile, seg_cap, _scene_inputs(tile, seg_cap, n, device,
                                        cam=CAM3 if kind == "wide" else CAM2)


@pytest.mark.parametrize("order", ["ascending", "shuffled"])
@pytest.mark.parametrize("case", list(WINDOW_CASES) + list(K12_CASES))
def test_window_kernel_at_run_lengths(case, order, cuda_device,
                                      monkeypatch):
    """K3 against K2's twin with runs of 1, 4 and 8 tiles a block (set
    through `window_run`), on the window hazard scenes and the cull cases:
    every grid but the 300-tile one has fewer tiles than an H100 has SMs;
    ids ascending, or shuffled with two of them repeated (the tracker's
    score order, every tile a backward jump)."""
    tile, seg_cap, (attrs, ss, sc, tx, num_tiles) = _case_inputs(
        case, cuda_device)
    ids = torch.arange(num_tiles, dtype=torch.int32, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    if order == "shuffled":
        p = torch.randperm(num_tiles, generator=gen, device=cuda_device)
        ids = torch.cat([p, p[:2]])[torch.randperm(
            num_tiles + 2, generator=gen, device=cuda_device)].to(torch.int32)
    out, cols = cs.composite_sorted_fwd(attrs, ss, sc, ids, tile, tx, 3,
                                        seg_cap)
    dout = torch.randn(out.shape, generator=gen, device=cuda_device)
    dout[:, 5:] = 0
    g_t = cs.composite_sorted_bwd_plain(attrs, ids, out, cols, dout, tile,
                                        tx)
    assert float(g_t[:10].abs().max()) > 0
    for run in (1, 4, 8):
        monkeypatch.setattr(cs, "window_run", lambda *_, r=run: r)
        cs.reset_counts()
        g3 = cs.composite_sorted_bwd_window(attrs, ss, ids, out, cols, dout,
                                            tile, tx, 3, seg_cap, 8)
        torch.cuda.synchronize()
        assert cs.counts()["window_launches"] == 1
        assert cs.last_window_run == run
        _grads_close(g3, g_t)


@pytest.mark.parametrize("kind,tile", [("hazard", 16), ("hazard", 32),
                                       ("hazard", 64), ("wide", 32)])
def test_entry_kernels_on_hazard_layouts(kind, tile, cuda_device):
    """K5 / K6 on the cull hazard scene binned as entries (tiles 16 / 32 /
    64), and on a 300-tile grid (more tiles than SMs: K6's 512-thread
    blocks): K6 against its twin, twice bit for bit, zero in every column K5
    did not composite."""
    cfg = RasterConfig(tile=tile, dup_side=3, max_per_tile=8192,
                       backend="pallas")
    if kind == "hazard":
        cam = CAM2
        proj, colors = _hazard_proj(tile, 1024, 5000, cuda_device)
    else:
        cam = CAM3
        t = _scene(30000, cuda_device, 4)
        colors = t["col"]
        proj = project_gaussians(t["means"], t["q"], t["ls"], t["op"],
                                 torch.eye(4, device=cuda_device), cam, cfg)
    slot, pstart, count = R._build_slots(proj, cam, cfg)
    entries = R._gather_entries(R._with_sentinel(R._stack_attrs(
        proj, colors)), slot).contiguous()
    tx = -(-cam.width // tile)
    assert pstart.shape[0] == tx * -(-cam.height // tile)
    _check_entries(entries, pstart, count, tile, tx, cuda_device)


# (tile, camera, gaussians) of K4 on K2's grid: one block a tile at tile
# 16, quadrants at 32 and 64; at tile 32 the 256-thread quadrants when the
# grid has no more tiles than SMs (CAM2: 48 tiles, and every 1/3 subset
# below 132 tiles) and the 128-thread ones above (CAM3: 300 tiles).
K4_GRID_CASES = {
    "t16_wide": (16, 256, CAM3, 20000),
    "t32_narrow": (32, 1024, CAM2, 6000),
    "t32_wide": (32, 1024, CAM3, 20000),
    "t64_narrow": (64, 1024, CAM2, 6000),
    "t64_wide": (64, 1024, CAM3, 20000),
}


@pytest.mark.parametrize("case", list(K4_GRID_CASES))
def test_pose_kernel_on_k2_grid(case, cuda_device):
    """K4 at tiles 16, 32 and 64 on both of K2's block sizes: against its
    twin, twice bit for bit, and its path against the K2 + autograd
    chain."""
    tile, seg_cap, cam, n = K4_GRID_CASES[case]
    _check_pose_kernel(tile, seg_cap, n, cam, cuda_device)


def _opaque_entries(tile, cam, device, seed=0):
    """Entries of a scene dense with near-opaque gaussians (sigma 4-8 px,
    opacity 0.6-0.95, ~0.25 a pixel), so that many tiles stop at the
    log T <= -11.5 threshold before their last chunk and others run to it."""
    rng = np.random.default_rng(seed)
    n = int(0.25 * cam.width * cam.height)
    sig = rng.uniform(4.0, 8.0, n)
    aniso = rng.uniform(0.7, 1.0, n)
    th = rng.uniform(0.0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    s2 = sig * aniso
    cxx = c * c * sig ** 2 + s * s * s2 ** 2
    cyy = s * s * sig ** 2 + c * c * s2 ** 2
    cxy = c * s * (sig ** 2 - s2 ** 2)
    det = cxx * cyy - cxy * cxy
    # Sparser on the right third of the frame: those tiles do not stop.
    mu = rng.uniform(-8.0, cam.width + 8.0, n)
    keep = (mu < 2 * cam.width / 3) | (rng.uniform(size=n) < 0.15)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)[keep],
                                    device=device)
    proj = _Projected(
        mean2d=f32(np.stack([mu, rng.uniform(-8.0, cam.height + 8.0, n)],
                            1)),
        conic=f32(np.stack([cyy / det, -cxy / det, cxx / det], 1)),
        depth=f32(rng.uniform(1.0, 3.0, n)),
        radius=f32(np.ceil(3.0 * sig)),
        opacity=f32(rng.uniform(0.6, 0.95, n)))
    cfg = RasterConfig(tile=tile, dup_side=3, max_per_tile=8192,
                       backend="pallas")
    slot, pstart, count = R._build_slots(proj, cam, cfg)
    entries = R._gather_entries(R._with_sentinel(R._stack_attrs(
        proj, f32(rng.uniform(0, 1, (n, 3))))), slot).contiguous()
    return entries, pstart, count, -(-cam.width // tile)


# (tile, camera): K5's block sizes, one block a tile of 256 threads at
# tile 16, 1024 at tile 32 when the grid has no more tiles than SMs (CAM2:
# 48 tiles), 512 above (CAM3: 300 tiles), 512 at tile 64.
K5_STOP_CASES = {
    "t16_wide": (16, CAM2),
    "t32_narrow": (32, CAM2),
    "t32_wide": (32, CAM3),
    "t64_narrow": (64, CAM2),
    "t64_wide": (64, CAM3),
}


@pytest.mark.parametrize("case", list(K5_STOP_CASES))
def test_entry_forward_at_the_stop_threshold(case, cuda_device):
    """K5 on a scene where some tiles stop at the -11.5 threshold before
    their last chunk and others composite every chunk: against its twin
    (colour / alpha 1e-3, counts exact, chunks used on at most 0.5% of
    tiles), and K6 on K5's outputs against its twin, twice bit for bit."""
    tile, cam = K5_STOP_CASES[case]
    entries, pstart, count, tx = _opaque_entries(tile, cam, cuda_device)
    out_k = _check_entries(entries, pstart, count, tile, tx, cuda_device)
    chunks = (count.long() + 127) // 128
    eff = out_k[:, 6, 0].long()
    assert bool((eff < chunks).any()) and bool(((eff == chunks)
                                                & (chunks > 1)).any())
    live = out_k[:, 5].amax(1)
    assert float(live[eff < chunks].max()) <= -11.5 + 1e-4


# The loop closer's registration renders: the bench camera at pyramid level
# 1 (600x340), tile 16 (38 x 22 = 836 tiles), a 65,536-gaussian subsample.
CAM_LC = Camera(fx=300.0, fy=300.0, cx=299.5, cy=169.5, width=600,
                height=340)


@pytest.mark.parametrize("ids_kind", ["full", "quarter"])
def test_kernels_at_the_closers_shape(ids_kind, cuda_device):
    """K1 against its twin (survivors, columns, outputs, chunks used) and K2
    against its twin (1e-3 of each row's max) on the full grid and on the
    tile subset of a localisation segment."""
    attrs, ss, sc, tx, num_tiles = _scene_inputs(16, 1024, 65536,
                                                 cuda_device, seed=3,
                                                 cam=CAM_LC)
    assert num_tiles == 836
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    ids = torch.arange(num_tiles, dtype=torch.int32, device=cuda_device)
    if ids_kind == "quarter":
        ids = torch.randperm(num_tiles, generator=gen, device=cuda_device)[
            :209].to(torch.int32)
    args = (attrs, ss, sc, ids, 16, tx, 3, 1024)
    ok, ck = cs.composite_sorted_fwd(*args)
    ot, ct = cs.composite_sorted_fwd_plain(*args)
    torch.cuda.synchronize()
    _fwd_close(ok, ck, ot, ct)
    dout = torch.randn(ot.shape, generator=gen, device=cuda_device)
    dout[:, 5:] = 0
    gk = cs.composite_sorted_bwd(attrs, ids, ok, ck, dout, 16, tx)
    gt = cs.composite_sorted_bwd_plain(attrs, ids, ot, ct, dout, 16, tx)
    torch.cuda.synchronize()
    _grads_close(gk, gt)


# The TUM RGB-D map camera: configs/TUM_RGBD/tum_rgbd.yaml's calibration
# cropped by its crop_edge of 50 (540 x 380), the SLAM loop's tile 32
# (17 x 12 = 204 tiles), a map of the config's new-submap seed count.
CAM_TUM = Camera(fx=517.306408, fy=516.469215, cx=268.643040,
                 cy=205.313989, width=540, height=380)


@pytest.mark.parametrize("ids_kind", ["full", "quarter"])
def test_kernels_at_the_tum_shape(ids_kind, cuda_device):
    """K1 against its twin (survivors, columns, outputs, chunks used) and K2
    against its twin (1e-3 of each row's max) on the full 204-tile grid and
    on a shuffled 51-tile quarter (the tracker's subset)."""
    attrs, ss, sc, tx, num_tiles = _scene_inputs(32, 1024, 50000,
                                                 cuda_device, seed=5,
                                                 cam=CAM_TUM)
    assert num_tiles == 204
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    ids = torch.arange(num_tiles, dtype=torch.int32, device=cuda_device)
    if ids_kind == "quarter":
        ids = torch.randperm(num_tiles, generator=gen, device=cuda_device)[
            :51].to(torch.int32)
    args = (attrs, ss, sc, ids, 32, tx, 3, 1024)
    ok, ck = cs.composite_sorted_fwd(*args)
    ot, ct = cs.composite_sorted_fwd_plain(*args)
    torch.cuda.synchronize()
    _fwd_close(ok, ck, ot, ct)
    dout = torch.randn(ot.shape, generator=gen, device=cuda_device)
    dout[:, 5:] = 0
    gk = cs.composite_sorted_bwd(attrs, ids, ok, ck, dout, 32, tx)
    gt = cs.composite_sorted_bwd_plain(attrs, ids, ot, ct, dout, 32, tx)
    torch.cuda.synchronize()
    _grads_close(gk, gt)


# The global refine's renders (the evaluator's raster settings): the bench
# camera at full size, tile 16 (75 x 43 = 3225 tiles), on maps the size of
# bench.py's merged map and beyond it (many bands clipped at seg_cap 1024).
CAM_GLOBAL = Camera(fx=600.0, fy=600.0, cx=599.5, cy=339.5, width=1200,
                    height=680)


@pytest.mark.parametrize("n", [300_000, 1_200_000])
def test_kernels_at_the_global_shape(n, cuda_device):
    """K1 against its twin (survivors, columns, outputs, chunks used) and K2
    against its twin (1e-3 of each row's max) on the full 3225-tile grid,
    and one render of the merged-map size through the autograd path."""
    attrs, ss, sc, tx, num_tiles = _scene_inputs(16, 1024, n, cuda_device,
                                                 seed=11, cam=CAM_GLOBAL)
    assert num_tiles == 3225
    ids = torch.arange(num_tiles, dtype=torch.int32, device=cuda_device)
    args = (attrs, ss, sc, ids, 16, tx, 3, 1024)
    ok, ck = cs.composite_sorted_fwd(*args)
    ot, ct = cs.composite_sorted_fwd_plain(*args)
    torch.cuda.synchronize()
    _fwd_close(ok, ck, ot, ct)
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    dout = torch.randn(ot.shape, generator=gen, device=cuda_device)
    dout[:, 5:] = 0
    gk = cs.composite_sorted_bwd(attrs, ids, ok, ck, dout, 16, tx)
    gt = cs.composite_sorted_bwd_plain(attrs, ids, ot, ct, dout, 16, tx)
    torch.cuda.synchronize()
    _grads_close(gk, gt)
    t = _scene(n, cuda_device, 11)
    means = t["means"].clone().requires_grad_(True)
    out = R.render(means, t["q"], t["ls"], t["op"], t["col"],
                   torch.eye(4, device=cuda_device), CAM_GLOBAL,
                   RasterConfig(tile=16, dup_side=4))
    out.color.sum().backward()
    torch.cuda.synchronize()
    assert out.color.shape == (680, 1200, 3)
    assert bool(torch.isfinite(means.grad).all())
    assert float(means.grad.abs().max()) > 0


def test_tagged_stream_counts_apart(cuda_device):
    """A K1 + K2 render issued on a stream under `counting_as` counts under
    its tag (the backward too, which the autograd engine runs in its own
    thread on the forward's stream); the main path's counts stay 0."""
    attrs, ss, sc, tx, num_tiles = _inputs(32, 1024, 800, cuda_device)
    ids = torch.arange(num_tiles, dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    cs.reset_counts()
    with torch.cuda.stream(stream), cs.counting_as("lc", stream):
        a = attrs.clone().requires_grad_(True)
        out = cs.composite_sorted(a, ss, sc, ids, 32, tx, 3, 1024)
        out[:, :5].sum().backward()
    stream.synchronize()
    lc = cs.counts("lc")
    assert lc["fwd_launches"] == 1 and lc["bwd_launches"] == 1
    assert all(v == 0 for v in cs.counts().values())
    assert float(a.grad.abs().max()) > 0


VARIANT_CASES = ("t16_full", "t32_eighth_repeated", "t32_wide_full",
                 "t64_full", "hazard_t16", "hazard_t32_eighth", "hazard_t64")


@pytest.mark.parametrize("variant", ["quadform", "bf16", "quadform_bf16"])
@pytest.mark.parametrize("case", VARIANT_CASES)
def test_kernel_variants_match_twins(case, variant, cuda_device):
    """K1-K4 under kernel_quadform, kernel_bf16 and both against their
    twins under the same option (the bf16 variants read the bf16 layout
    of the same attrs): K1's outputs, survivors and columns as in the
    default check, K2 / K3 grads 1e-3 of each row's max, K4 1e-3 of the
    largest |dpose| and twice bit for bit; every launch counts under its
    variant and none under the default."""
    quad, bf16 = "quadform" in variant, "bf16" in variant
    tile, seg_cap, inputs = _case_inputs(case, cuda_device)
    attrs, ss, sc, tx, num_tiles = inputs
    if bf16:
        attrs = cs.to_bf16_layout(attrs)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    ids = torch.arange(num_tiles, dtype=torch.int32, device=cuda_device)
    if K12_CASES[case][4] == "eighth":
        p = torch.randperm(num_tiles, generator=gen, device=cuda_device)[
            : max(2, round(num_tiles / 8))]
        ids = torch.cat([p, p[:2]]).to(torch.int32)
    args = (attrs, ss, sc, ids, tile, tx, 3, seg_cap)
    cs.reset_counts()
    out_k, cols_k = cs.composite_sorted_fwd(*args, quadform=quad)
    out_t, cols_t = cs.composite_sorted_fwd_plain(*args, quadform=quad)
    torch.cuda.synchronize()
    _fwd_close(out_k, cols_k, out_t, cols_t)
    dout = torch.randn(out_t.shape, generator=gen, device=cuda_device)
    dout[:, 5:] = 0
    g_t = cs.composite_sorted_bwd_plain(attrs, ids, out_t, cols_t, dout,
                                        tile, tx, quad)
    assert float(g_t[:10].abs().max()) > 0
    _grads_close(cs.composite_sorted_bwd(attrs, ids, out_k, cols_k, dout,
                                         tile, tx, quad), g_t)
    _grads_close(cs.composite_sorted_bwd_window(attrs, ss, ids, out_k,
                                                cols_k, dout, tile, tx, 3,
                                                seg_cap, 4, quad), g_t)
    jac = torch.randn((cs.P_MAX * cs.PJ, attrs.shape[1]), generator=gen,
                      device=cuda_device)
    d_k = cs.pose_grad_sorted(attrs, jac, ids, out_k, cols_k, dout, tile, tx,
                              quad)
    d_k2 = cs.pose_grad_sorted(attrs, jac, ids, out_k, cols_k, dout, tile,
                               tx, quad)
    d_t = cs.pose_grad_sorted_plain(attrs, jac, ids, out_t, cols_t, dout,
                                    tile, tx, quad)
    torch.cuda.synchronize()
    assert float((d_k - d_t).abs().max()) <= 1e-3 * float(d_t.abs().max())
    assert torch.equal(d_k, d_k2)
    vc = cs.variant_counts()
    for kid, n in (("K1", 1), ("K2", 1), ("K3", 1), ("K4", 2)):
        assert vc[kid][variant] == n and vc[kid]["default"] == 0, (kid, vc)


@pytest.mark.parametrize("variant", ["quadform", "bf16", "quadform_bf16"])
def test_variant_paths_launch_their_kernels(variant, cuda_device):
    """The autograd Function (K1 + K2, and K3 with rmw_window) and the
    frozen-sorted K4 path under an option launch that variant only, with
    the twins' grads."""
    quad, bf16 = "quadform" in variant, "bf16" in variant
    attrs, ss, sc, tx, num_tiles = _inputs(32, 1024, 1500, cuda_device)
    ids = torch.arange(num_tiles, dtype=torch.int32, device=cuda_device)
    lay = cs.to_bf16_layout(attrs) if bf16 else attrs
    out_t, cols_t = cs.composite_sorted_fwd_plain(lay, ss, sc, ids, 32, tx,
                                                  3, 1024, quad)
    dout = torch.zeros_like(out_t)
    dout[:, :5] = torch.randn(out_t[:, :5].shape, device=cuda_device,
                              generator=torch.Generator(
                                  device=cuda_device).manual_seed(3))
    g_t = cs.composite_sorted_bwd_plain(lay, ids, out_t, cols_t, dout, 32,
                                        tx, quad)
    for window in (False, True):
        a = attrs.clone().requires_grad_(True)
        cs.reset_counts()
        out = cs.composite_sorted(a, ss, sc, ids, 32, tx, 3, 1024, 4,
                                  rmw_window=window, quadform=quad,
                                  bf16=bf16)
        (out * dout).sum().backward()
        torch.cuda.synchronize()
        vc = cs.variant_counts()
        kb = "K3" if window else "K2"
        assert vc["K1"][variant] == 1 and vc[kb][variant] == 1, vc
        assert sum(v["default"] for v in vc.values()) == 0
        _grads_close(a.grad, g_t)
    t = _scene(1500, cuda_device, 1)
    cfg = RasterConfig(tile=32, dup_side=3, seg_cap=1024, bands=3,
                       kernel_quadform=quad, kernel_bf16=bf16)
    fs = R.freeze_sorted(t["means"], t["q"], t["ls"], t["op"], t["col"],
                         torch.eye(4, device=cuda_device), CAM, cfg)
    qt = torch.tensor([0.999, 0.01, -0.02, 0.015, 0.01, -0.02, 0.03],
                      device=cuda_device, requires_grad=True)
    cs.reset_counts()
    o = R.render_frozen_sorted_pose(fs, qt, torch.eye(4, device=cuda_device),
                                    CAM, cfg)
    (d4,) = torch.autograd.grad(o.color.sum() + 0.3 * o.depth.sum(), qt)
    torch.cuda.synchronize()
    vc = cs.variant_counts()
    assert vc["K1"][variant] == 1 and vc["K4"][variant] == 1, vc
    assert bool(torch.isfinite(d4).all()) and float(d4.abs().max()) > 0
