"""The alpha box that every kernel culls with (`composite_sorted.alpha_box`,
the mirror of csrc/alpha_box.cuh), against the twin's `_chunk_alpha`.

    python -m pytest tests/test_torch_alpha_box.py -q
    EAGS_BOX_EXAMPLES=5000 python -m pytest tests/test_torch_alpha_box.py -q

The box must never remove a pair the twin counts: no (pixel, gaussian) pair
outside the box may have nonzero alpha, for any conic, opacity or offset,
including the hazards of the cull (near-singular and strongly elongated
conics, opacity just above 1/255 and near 1, radius-capped gaussians, means
on and just outside patch borders). The seeded test on a map with the chip
smoke's kernels-map statistics counts the pairs the box keeps; the same map
binned as entries (dup_side 3, K5 / K6's layout) holds the box on entries
that sit in tiles other than their centre's.

The property test draws a fixed set of 60 examples (derandomized, so a
failure reproduces); EAGS_BOX_EXAMPLES=N explores N fresh random ones.
"""
import math
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops import composite_entries as ce
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.ops import rasterizer as R
from eags_slam_torch.ops.rasterizer import (RasterConfig, _sorted_attrs,
                                            _v2_radius_cap, project_gaussians)


def _conics(rng, n, aniso_max, log_s):
    """(a, b, c) float32 conics of covariances with major sigma
    exp(log_s +- 1) px and axis ratio up to aniso_max, at random angles."""
    s1 = np.exp(log_s + rng.uniform(-1.0, 1.0, n))
    s2 = s1 / np.exp(rng.uniform(0.0, math.log(aniso_max), n))
    th = rng.uniform(0.0, math.pi, n)
    c, s = np.cos(th), np.sin(th)
    cxx = c * c * s1 ** 2 + s * s * s2 ** 2
    cyy = s * s * s1 ** 2 + c * c * s2 ** 2
    cxy = c * s * (s1 ** 2 - s2 ** 2)
    det = cxx * cyy - cxy * cxy
    return (np.stack([cyy / det, -cxy / det, cxx / det]).astype(np.float32))


def _opacities(rng, n):
    """Uniform, just above / at / below 1/255, and near 1."""
    lo = np.float32(1.0 / 255.0)
    kind = rng.integers(0, 4, n)
    op = np.where(kind == 0, rng.uniform(0.0, 1.0, n),
                  np.where(kind == 1, lo * (1.0 + 10.0 ** rng.uniform(
                      -7, -1, n)), np.where(kind == 2, 1.0 - 10.0 ** rng.uniform(
                          -7, -1, n), lo)))
    return op.astype(np.float32)


def _edge_points(box, mu, mv, a, b, c, rng):
    """Pixel positions just outside each edge of each box, where alpha along
    that edge peaks (dv = -b du / c on a u edge, du = -b dv / a on a v
    edge), nudged by a few ulps and by up to a pixel."""
    pts = []
    np.seterr(all="ignore")
    for side in range(4):
        edge = box[side].numpy().astype(np.float32)
        out = np.nextafter(edge, np.float32(np.inf if side % 2 else -np.inf))
        for jitter in (0.0, 1.0):
            step = rng.uniform(0.0, jitter, edge.shape).astype(np.float32)
            pos = out + (step if side % 2 else -step)
            if side < 2:
                du = pos - mu
                pv = mv - b * du / c + rng.normal(0, 0.1 * jitter, du.shape)
                pts.append((pos, pv.astype(np.float32)))
            else:
                dv = pos - mv
                pu = mu - b * dv / a + rng.normal(0, 0.1 * jitter, dv.shape)
                pts.append((pu.astype(np.float32), pos))
    pu = np.concatenate([p[0] for p in pts])
    pv = np.concatenate([p[1] for p in pts])
    ok = np.isfinite(pu) & np.isfinite(pv)
    return pu[ok], pv[ok]


EXPLORE = int(os.environ.get("EAGS_BOX_EXAMPLES", "0"))


@settings(max_examples=EXPLORE or 60, derandomize=not EXPLORE,
          deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1),
       aniso_max=st.sampled_from([1.0 + 1e-6, 4.0, 100.0, 1e3, 1e4]),
       log_s=st.floats(-1.5, 4.5))
def test_no_pair_outside_the_box_has_alpha(seed, aniso_max, log_s):
    rng = np.random.default_rng(seed)
    n = cs.CHUNK
    a, b, c = _conics(rng, n, aniso_max, log_s)
    op = _opacities(rng, n)
    mu = rng.uniform(-40.0, 1240.0, n).astype(np.float32)
    mv = rng.uniform(-40.0, 720.0, n).astype(np.float32)
    # Means on pixel centres and half-pixel borders (patch edges).
    mu[: n // 4] = np.round(mu[: n // 4]) + np.float32(0.5) * (
        np.arange(n // 4) % 2)
    t = {k: torch.as_tensor(v) for k, v in
         dict(mu=mu, mv=mv, a=a, b=b, c=c, op=op).items()}
    box = cs.alpha_box(t["mu"], t["mv"], t["a"], t["b"], t["c"], t["op"])
    pu, pv = _edge_points(box, mu, mv, a, b, c, rng)
    e = torch.zeros((10, 1, n), dtype=torch.float32)
    e[0, 0], e[1, 0], e[2, 0], e[3, 0], e[4, 0], e[5, 0] = (
        t["mu"], t["mv"], t["a"], t["b"], t["c"], t["op"])
    pu_t = torch.as_tensor(pu)[None]
    pv_t = torch.as_tensor(pv)[None]
    alpha = cs._chunk_alpha(e, pu_t, pv_t, torch.tensor([n]))[0][0]
    inside = ((box[0][None] <= pu_t[0][:, None])
              & (pu_t[0][:, None] <= box[1][None])
              & (box[2][None] <= pv_t[0][:, None])
              & (pv_t[0][:, None] <= box[3][None]))
    assert not bool((alpha[~inside] > 0).any())
    # Not vacuous: the points hug the boxes (on a PD conic with opacity
    # above 1.1/255 and a condition below 1e4, where float32 still resolves
    # the ellipse, its extreme point, pulled 1% inside, lies inside the box
    # and has nonzero alpha).
    a64, b64, c64 = (x.astype(np.float64) for x in (a, b, c))
    det = a64 * c64 - b64 * b64
    with np.errstate(all="ignore"):
        hu = np.sqrt(2.0 * np.log(255.0 * op.astype(np.float64)) * c64
                     / det) * 0.99
        qu = (mu + hu).astype(np.float32)
        qv = (mv - b64 * hu / c64).astype(np.float32)
        ok = ((det > 0) & (a64 > 0) & ((a64 + c64) ** 2 < 1e4 * det)
              & (op > 1.1 / 255.0) & (hu > 0.5)
              & (hu < 1e4) & np.isfinite(qv))
    ai = cs._chunk_alpha(e, torch.as_tensor(qu)[None], torch.as_tensor(qv)[
        None], torch.tensor([n]))[0][0]
    diag = ai[torch.arange(n), torch.arange(n)].numpy()
    assert np.all(diag[ok] > 0)
    assert np.all((box[1].numpy() >= qu)[ok])


def test_box_edge_cases():
    """Empty for op < 1/255, unbounded for a conic that is not positive
    definite, for a near-singular one and for a NaN opacity."""
    f = torch.tensor
    lo = float(np.float32(1.0 / 255.0))
    cases = [  # (a, b, c, op, expect): expect "empty", "all", "finite"
        (1.0, 0.0, 1.0, float(np.nextafter(np.float32(lo), np.float32(0))),
         "empty"),
        (1.0, 0.0, 1.0, lo, "finite"),
        (1.0, 2.0, 1.0, 0.5, "all"),                # indefinite
        (-1.0, 0.0, -1.0, 0.5, "all"),
        (1.0, 1.0 - 1e-7, 1.0, 0.5, "all"),         # near-singular
        (1.0, 0.0, 1.0, float("nan"), "all"),
        (0.0, 0.0, 0.0, 0.9, "all"),
    ]
    for a, b, c, op, expect in cases:
        box = cs.alpha_box(f([10.0]), f([20.0]), f([a]), f([b]), f([c]),
                           f([op]))[:, 0]
        if expect == "empty":
            assert box[0] > box[1] and box[2] > box[3]
        elif expect == "all":
            assert torch.equal(box, f([-math.inf, math.inf, -math.inf,
                                       math.inf]))
        else:
            assert torch.isfinite(box).all() and box[0] < 10.0 < box[1]


# The chip smoke's kernels map: 4-20 mm gaussians at opacity 0.5 seen at
# f = 600 px from 1.5-4 m, ~0.18 gaussians a pixel, tile 32, bands 3,
# seg_cap 1024, radius capped at 31 px. Cut to a 256 x 128 window.
CAM = Camera(fx=600.0, fy=600.0, cx=127.5, cy=63.5, width=256, height=128)


def _map_proj(cfg, seed=0, n=6000, **kw):
    """The kernels map's gaussians projected under `cfg`; returns (proj,
    colours)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.5, 4.0, n)
    x = (rng.uniform(-10.0, CAM.width + 10.0, n) - CAM.cx) * z / CAM.fx
    y = (rng.uniform(-10.0, CAM.height + 10.0, n) - CAM.cy) * z / CAM.fy
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    proj = project_gaussians(
        torch.as_tensor(np.stack([x, y, z], 1), dtype=torch.float32),
        torch.as_tensor(q, dtype=torch.float32),
        torch.log(torch.as_tensor(rng.uniform(0.004, 0.02, (n, 3)),
                                  dtype=torch.float32)),
        torch.zeros((n, 1)), torch.eye(4), CAM, cfg, **kw)
    colors = torch.as_tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32)
    return proj, colors


def _kernels_map(seed=0, n=6000):
    cfg = RasterConfig(tile=32, dup_side=3, seg_cap=1024, bands=3)
    proj, colors = _map_proj(cfg, seed, n, radius_cap=_v2_radius_cap(cfg))
    attrs, ss, sc = _sorted_attrs(proj, colors, CAM, cfg)
    return attrs.contiguous(), ss, sc, cfg


def _patch_keep(box, pu, pv, ph, pw):
    """Pairs kept when a (ph x pw)-pixel patch is skipped as a whole:
    (S, PX, K) mask from box (4, S, K) and the tile's pixel centres."""
    pu0 = torch.div(pu, pw, rounding_mode="floor") * pw      # patch corner
    pv0 = torch.div(pv, ph, rounding_mode="floor") * ph
    return ((box[0][:, None] <= (pu0 + pw - 1)[:, :, None])
            & (box[1][:, None] >= pu0[:, :, None])
            & (box[2][:, None] <= (pv0 + ph - 1)[:, :, None])
            & (box[3][:, None] >= pv0[:, :, None]))


@pytest.fixture(scope="module")
def kernels_map_run():
    """The twin's forward over every tile of the kernels map, and its
    residual with the columns past each survivor count zeroed."""
    attrs, ss, sc, cfg = _kernels_map()
    tiles_x = -(-CAM.width // cfg.tile)
    ids = torch.arange(tiles_x * -(-CAM.height // cfg.tile),
                       dtype=torch.int32)
    out, cols = cs.composite_sorted_fwd_plain(attrs, ss, sc, ids, cfg.tile,
                                              tiles_x, cfg.bands, cfg.seg_cap)
    lane = torch.arange(cols.shape[1])
    cols = torch.where(lane[None] < out[:, 7, 0].long()[:, None], cols,
                       torch.zeros_like(cols))
    return attrs, ids, out, cols, cfg, tiles_x


def _count_pairs(run):
    """Pairs of the processed chunks: all, contributing, inside the box per
    pixel and per 8 x 4 / 8 x 8 patch; asserts that every contributing
    pair is kept at each granularity."""
    attrs, ids, out, cols, cfg, tiles_x = run
    eff, n_surv = out[:, 6, 0].long(), out[:, 7, 0].long()
    pu, pv = cs._pixel_coords(ids, cfg.tile, tiles_x)
    n = dict(pairs=0, contrib=0, pixel=0, patch_8x4=0, patch_8x8=0)
    for ci in range(int(eff.max())):
        n_valid = torch.where(ci < eff, n_surv - ci * cs.CHUNK,
                              torch.zeros_like(n_surv))
        e = cs._chunk_attrs(attrs, cols, ci)
        alpha = cs._chunk_alpha(e, pu, pv, n_valid)[0]
        valid = (torch.arange(cs.CHUNK)[None] < n_valid[:, None])[:, None]
        box = cs.alpha_box(e[0], e[1], e[2], e[3], e[4], e[5])
        pix = ((box[0][:, None] <= pu[:, :, None])
               & (box[1][:, None] >= pu[:, :, None])
               & (box[2][:, None] <= pv[:, :, None])
               & (box[3][:, None] >= pv[:, :, None]))
        p84 = _patch_keep(box, pu, pv, 4, 8)
        p88 = _patch_keep(box, pu, pv, 8, 8)
        live = alpha > 0
        for m in (pix, p84, p88):
            assert not bool((live & ~m).any())
        n["pairs"] += int(valid.expand_as(alpha).sum())
        n["contrib"] += int(live.sum())
        n["pixel"] += int((pix & valid).sum())
        n["patch_8x4"] += int((p84 & valid).sum())
        n["patch_8x8"] += int((p88 & valid).sum())
    return n


def test_box_keeps_every_contributing_pair_on_kernels_map(kernels_map_run):
    """On the kernels-map statistics, every contributing pair of the chunks
    K1 processes lies in its survivor's box, also at the granularity of the
    warp patches (8 x 4 pixels at one pixel a thread, 8 x 8 at two), and
    the box removes a large share of the pairs (measured: see PERF.md)."""
    n = _count_pairs(kernels_map_run)
    share = {k: n[k] / n["pairs"] for k in n}
    print("alpha box keeps (share of processed pairs):", share)
    assert n["contrib"] > 0.05 * n["pairs"]
    assert share["contrib"] <= share["pixel"] <= share["patch_8x4"] \
        <= share["patch_8x8"] < 0.8


def test_smoke_bound_counts_the_boxed_pairs(kernels_map_run):
    """chip_smoke.py's bound charges the Gaussian test only to the pairs
    inside their survivor's box, plus the box once a replayed survivor:
    its counts are the box's on the same run, and K1's operations follow
    from them."""
    import chip_smoke

    attrs, ids, out, cols, cfg, tiles_x = kernels_map_run
    w = chip_smoke._work(attrs, ids, out, cols, cfg.tile, tiles_x)
    n = _count_pairs(kernels_map_run)
    assert (w["pairs"], w["boxed"], w["contrib"]) == (
        n["pairs"], n["pixel"], n["contrib"])
    assert w["replayed"] * cfg.tile * cfg.tile == w["pairs"]
    assert chip_smoke._ops("K1", w) == (
        chip_smoke.OPS_BOX * w["replayed"] + chip_smoke.OPS_TEST * w["boxed"]
        + chip_smoke.OPS_CONTRIB["K1"] * w["contrib"])


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_box_keeps_every_contributing_pair_on_entry_layout(tile):
    """K5 / K6 cull with the same box on the entry layout (dup_side 3, the
    smoke's entries settings): every (pixel, entry) pair of the chunks the
    twin composites with nonzero alpha lies inside its entry's box, also
    for the entries a gaussian's radius box duplicated into tiles other
    than its centre's, which must be among the contributing ones."""
    cfg = RasterConfig(tile=tile, dup_side=3, entry_cap_factor=4,
                       max_per_tile=8192, backend="pallas")
    proj, colors = _map_proj(cfg)
    slot, pstart, count = R._build_slots(proj, CAM, cfg)
    entries = R._gather_entries(R._with_sentinel(R._stack_attrs(
        proj, colors)), slot).contiguous()
    tiles_x = -(-CAM.width // tile)
    out = ce.composite_entries_fwd_plain(entries, pstart, count, tile,
                                         tiles_x)
    cols, ids = ce._segments(pstart, count)
    eff = out[:, 6, 0].long()
    cnt = count.long()
    pu, pv = cs._pixel_coords(ids, tile, tiles_x)
    n_contrib = n_dup = 0
    for ci in range(int(eff.max())):
        n_valid = torch.where(ci < eff, cnt - ci * cs.CHUNK,
                              torch.zeros_like(cnt))
        e = cs._chunk_attrs(entries, cols, ci)
        alpha = cs._chunk_alpha(e, pu, pv, n_valid)[0]
        box = cs.alpha_box(e[0], e[1], e[2], e[3], e[4], e[5])
        inside = ((box[0][:, None] <= pu[:, :, None])
                  & (box[1][:, None] >= pu[:, :, None])
                  & (box[2][:, None] <= pv[:, :, None])
                  & (box[3][:, None] >= pv[:, :, None]))
        live = alpha > 0
        assert not bool((live & ~inside).any())
        # Entries whose mean lies in another tile than the one they sit in.
        dup = ((torch.div(e[0], tile, rounding_mode="floor")
                != (ids.long() % tiles_x)[:, None])
               | (torch.div(e[1], tile, rounding_mode="floor")
                  != (ids.long() // tiles_x)[:, None]))
        n_contrib += int(live.sum())
        n_dup += int((live & dup[:, None, :]).sum())
    assert n_contrib > 0 and n_dup > 0


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_quad_box_keeps_every_quadform_pair(tile):
    """The quadform variant culls with `quad_alpha_box`: the box widened by
    the bound on the expanded form's float32 error. Over every pixel of a
    tile far from the origin (where the global coordinates are large),
    no pair of the twin's quadform alpha outside the widened box is
    nonzero, for the property test's conic, opacity and mean hazards with
    means up to a tile outside the tile. (-s prints the largest widening
    of t where the projection can put a conic: its 0.3 px^2 low-pass keeps
    a and c <= 1 / 0.3.)"""
    rng = np.random.default_rng(tile)
    n = cs.CHUNK
    tx0, ty0 = float(1184 // tile * tile), float(672 // tile * tile)
    basis = cs._basis(tile, "cpu")
    lu, lv = basis[3], basis[4]
    n_live, widest = 0, 0.0
    for k in range(12):
        a, b, c = _conics(rng, n, [1.0 + 1e-6, 4.0, 100.0, 1e3][k % 4],
                          rng.uniform(-1.0, np.log(tile / 3.0)))
        e = torch.zeros((10, 1, n), dtype=torch.float32)
        e[0, 0] = torch.as_tensor(
            tx0 + rng.uniform(-tile, 2 * tile, n)).float()
        e[1, 0] = torch.as_tensor(
            ty0 + rng.uniform(-tile, 2 * tile, n)).float()
        e[0, 0, : n // 4] = torch.round(e[0, 0, : n // 4]) + 0.5
        e[2, 0], e[3, 0], e[4, 0] = (torch.as_tensor(x) for x in (a, b, c))
        e[5, 0] = torch.as_tensor(_opacities(rng, n))
        ox, oy = torch.tensor([tx0]), torch.tensor([ty0])
        alpha, _, u_, v_ = cs._chunk_alpha_quad(e, basis, ox, oy,
                                                torch.tensor([n]))
        box = cs.quad_alpha_box(e[0, 0], e[1, 0], e[2, 0], e[3, 0], e[4, 0],
                                e[5, 0], u_[0], v_[0], tile)
        pu, pv = (lu + tx0)[:, None], (lv + ty0)[:, None]
        inside = ((box[0][None] <= pu) & (pu <= box[1][None])
                  & (box[2][None] <= pv) & (pv <= box[3][None]))
        live = alpha[0] > 0
        assert not bool((live & ~inside).any())
        n_live += int(live.sum())
        au, av = tile + u_[0].abs(), tile + v_[0].abs()
        s = (0.5 * (e[2, 0].abs() * au * au + e[4, 0].abs() * av * av)
             + e[3, 0].abs() * au * av)
        real = (e[2, 0] <= 1 / 0.3) & (e[4, 0] <= 1 / 0.3)
        widest = max(widest, float((cs.BOX_QUAD_EPS * s)[real].max()))
    print(f"quad box at tile {tile}: t widened by at most {widest:.4f}")
    assert n_live > 0
