"""The port gives one answer for one input, as the JAX reference does: the
sorted backward's cross-tile sums (K2's twin and K3's CPU route) are the
same bits whatever the order of tile_ids, for the same set of tiles, at
tile 16 and 32 and under quadform; the entry gather's backward sums each
column in a fixed order (against JAX's `.at[:, slot_gid].add`, and the same
bits on 1 and 4 intra-op threads); the loop closer's HOG descriptor holds
its previous value. (The CUDA kernels, twice bit for bit and under a
shuffled tile order: tests/test_torch_kernels_cuda.py, on the card.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_torch.core.camera import Camera
from eags_slam_torch.lc.descriptor import global_descriptor
from eags_slam_torch.ops import composite_entries as ce
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.ops import rasterizer as tr
from eags_slam_torch.ops.image import rgb_to_gray, sobel

CAM = Camera(90.0, 90.0, 63.5, 47.5, 128, 96)


def _sorted_inputs(seed: int, tile: int, bands: int = 3, n: int = 400):
    """A random scene centre-sorted by the port's rasterizer: (attrs, seg
    start, seg count, tiles_x, tiles)."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cfg = tr.RasterConfig(tile=tile, dup_side=3, seg_cap=256, bands=bands)
    proj = tr.project_gaussians(
        torch.as_tensor(means), torch.as_tensor(q),
        torch.as_tensor(np.log(rng.uniform(0.02, 0.08, (n, 3)))
                        .astype(np.float32)),
        torch.as_tensor(rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32)),
        torch.eye(4), CAM, cfg, radius_cap=tr._v2_radius_cap(cfg))
    attrs, ss, sc = tr._sorted_attrs(
        proj, torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
        CAM, cfg)
    tiles_x = -(-CAM.width // tile)
    return (attrs.contiguous(), ss.contiguous(), sc.contiguous(), tiles_x,
            tiles_x * -(-CAM.height // tile))


def _grads(attrs, ss, sc, ids, tile, tiles_x, bands, quadform, dout_of,
           window=False):
    out, cols = cs.composite_sorted_fwd(attrs, ss, sc, ids, tile, tiles_x,
                                        bands, 256, quadform)
    dout = dout_of(ids)
    if window:
        return cs.composite_sorted_bwd_window(attrs, ss, ids, out, cols,
                                              dout, tile, tiles_x, bands,
                                              256, 8, quadform)
    return cs.composite_sorted_bwd(attrs, ids, out, cols, dout, tile,
                                   tiles_x, bands, quadform)


def _per_tile_dout(seed, tiles, tile):
    """dout_of(ids): one seeded cotangent a tile, whatever its position."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(tiles, 8, tile * tile)).astype(np.float32)
    d[:, 5:] = 0.0
    table = torch.as_tensor(d)
    return lambda ids: table[ids.long()].contiguous()


@pytest.mark.parametrize("window", [False, True], ids=["k2", "k3"])
@pytest.mark.parametrize("tile,bands,quadform", [
    (16, 3, False), (32, 3, False), (16, 3, True), (16, 4, False)])
def test_backward_is_invariant_to_tile_order(tile, bands, quadform, window):
    """K2's twin (and K3's CPU route, `window`) on the full grid in
    ascending order, reversed and shuffled, and on a subset in ascending
    and in shuffled order: the same grads, bit for bit, and nonzero."""
    attrs, ss, sc, tx, tiles = _sorted_inputs(tile, tile, bands)
    dout_of = _per_tile_dout(tile + bands, tiles, tile)
    perm = torch.as_tensor(np.random.default_rng(7).permutation(tiles)
                           .astype(np.int32))
    full = torch.arange(tiles, dtype=torch.int32)
    ref = _grads(attrs, ss, sc, full, tile, tx, bands, quadform, dout_of,
                 window)
    assert float(ref[:10].abs().max()) > 0
    assert torch.equal(ref[10:], torch.zeros_like(ref[10:]))
    for ids in (full.flip(0), perm):
        assert torch.equal(ref, _grads(attrs, ss, sc, ids, tile, tx, bands,
                                       quadform, dout_of, window))
    sub = perm[: max(2, tiles // 3)]
    ref_sub = _grads(attrs, ss, sc, torch.sort(sub).values, tile, tx, bands,
                     quadform, dout_of, window)
    assert torch.equal(ref_sub, _grads(attrs, ss, sc, sub, tile, tx, bands,
                                       quadform, dout_of, window))


def test_k3_cpu_route_equals_k2_twin_bitwise():
    attrs, ss, sc, tx, tiles = _sorted_inputs(3, 16)
    dout_of = _per_tile_dout(3, tiles, 16)
    ids = torch.as_tensor(np.random.default_rng(3).permutation(tiles)
                          .astype(np.int32))
    assert torch.equal(
        _grads(attrs, ss, sc, ids, 16, tx, 3, False, dout_of, True),
        _grads(attrs, ss, sc, ids, 16, tx, 3, False, dout_of))


def test_backward_sums_like_chunk_order_index_add():
    """The slot-ordered sum agrees with the chunk-order index_add_ of the
    same per-tile totals (K4's twin's accumulation) to float32 rounding."""
    attrs, ss, sc, tx, tiles = _sorted_inputs(5, 16)
    ids = torch.arange(tiles, dtype=torch.int32)
    out, cols = cs.composite_sorted_fwd(attrs, ss, sc, ids, 16, tx, 3, 256)
    dout = _per_tile_dout(5, tiles, 16)(ids)
    g = cs.composite_sorted_bwd_plain(attrs, ids, out, cols, dout, 16, tx, 3)
    g0 = cs._replay_grads(attrs, ids, out, cols, dout, 16, tx)
    for row in range(10):
        scale = max(float(g0[row].abs().max()), 1e-12)
        assert float((g[row] - g0[row]).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("window", [False, True], ids=["k2", "k3"])
def test_repeated_tile_folds_into_its_first_copy(window):
    """A tile that tile_ids holds twice is replayed once, by its first
    copy, with the copies' cotangents added in row order: the same bits as
    the distinct tiles with that cotangent (the backward is linear in it)."""
    attrs, ss, sc, tx, tiles = _sorted_inputs(1, 16)
    ids = torch.tensor([2, 0, 2, 5, 2], dtype=torch.int32)
    out, cols = cs.composite_sorted_fwd(attrs, ss, sc, ids, 16, tx, 3, 256)
    dout = _per_tile_dout(1, 5, 16)(torch.arange(5))
    folded = dout[[0, 1, 3]].clone()
    folded[0] = dout[0] + dout[2] + dout[4]
    keep = torch.tensor([0, 1, 3])
    if window:
        got = cs.composite_sorted_bwd_window(attrs, ss, ids, out, cols, dout,
                                             16, tx, 3, 256, 8)
        want = cs.composite_sorted_bwd_window(
            attrs, ss, ids[keep], out[keep], cols[keep], folded, 16, tx, 3,
            256, 8)
    else:
        got = cs.composite_sorted_bwd(attrs, ids, out, cols, dout, 16, tx, 3)
        want = cs.composite_sorted_bwd(attrs, ids[keep], out[keep],
                                       cols[keep], folded, 16, tx, 3)
    assert float(want[:10].abs().max()) > 0
    assert torch.equal(got, want)


def test_table_slot_separates_a_columns_tiles():
    """Every tile within the bands window of a centre tile gets its own
    slot, at odd and even bands."""
    tiles_x = 11
    for bands in (1, 2, 3, 4, 5):
        r_n = (bands - 1) // 2
        for cy in range(3, 6):
            for cx in range(3, 6):
                ids = torch.tensor(
                    [(cy + r_n - dy) * tiles_x + cx + dx
                     for dy in range(bands) for dx in range(-r_n, r_n + 1)],
                    dtype=torch.int32)
                k = cs.table_slot(ids, tiles_x, bands)
                assert torch.unique(k).numel() == ids.numel()
                assert int(k.max()) < bands * bands


def _gather_case(seed):
    """The entry layout of a random scene: (g (16, E), slot_gid (E,),
    n_cols = N + 1)."""
    rng = np.random.default_rng(seed)
    n = 200
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    cfg = tr.RasterConfig(tile=16, dup_side=3, backend="pallas",
                          max_per_tile=256)
    proj = tr.project_gaussians(
        torch.as_tensor(means), torch.as_tensor(q),
        torch.as_tensor(np.log(rng.uniform(0.02, 0.1, (n, 3)))
                        .astype(np.float32)),
        torch.as_tensor(rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32)),
        torch.eye(4), CAM, cfg)
    slot_gid, _, _ = tr._build_slots(proj, CAM, cfg)
    g = rng.normal(size=(16, slot_gid.shape[0])).astype(np.float32)
    return torch.as_tensor(g), slot_gid, n + 1


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_backward_matches_jax_scatter_add(seed):
    g, slot_gid, n_cols = _gather_case(seed)
    counts = torch.bincount(slot_gid, minlength=n_cols)
    assert int(counts[:-1].max()) > 1      # gaussians in several tiles
    d = ce.gather_entries_bwd(g, slot_gid, n_cols)
    want = np.asarray(jnp.zeros((16, n_cols), jnp.float32)
                      .at[:, jnp.asarray(slot_gid.numpy())]
                      .add(jnp.asarray(g.numpy())))
    got = d.numpy()
    scale = np.abs(want[:, :-1]).max()
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], rtol=1e-6,
                               atol=1e-6 * scale)
    # The sentinel column (the empty slots, dropped by the caller) is 0.
    assert np.all(got[:, -1] == 0)


def test_gather_backward_same_bits_on_1_and_4_threads():
    g, slot_gid, n_cols = _gather_case(2)
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = ce.gather_entries_bwd(g, slot_gid, n_cols)
        torch.set_num_threads(4)
        four = ce.gather_entries_bwd(g, slot_gid, n_cols)
    finally:
        torch.set_num_threads(before)
    assert torch.equal(one, four)


def test_gather_autograd_takes_the_fixed_order_sum():
    g, slot_gid, n_cols = _gather_case(3)
    attrs = torch.zeros((16, n_cols), requires_grad=True)
    ce.reset_counts()
    (tr._gather_entries(attrs, slot_gid) * g).sum().backward()
    assert torch.equal(attrs.grad, ce.gather_entries_bwd(g, slot_gid,
                                                         n_cols))
    assert ce.counts()["entries_gather_twin_calls"] == 2
    assert ce.counts()["entries_gather_launches"] == 0


def _descriptor_index_add(rgb, dim: int = 1024):
    """global_descriptor as it was computed before, its HOG block with
    index_add_ (the reference for the fixed-order sum)."""
    import math

    from eags_slam_torch.lc.descriptor import _resize_linear

    small = _resize_linear(rgb, 64, 64)
    gray = rgb_to_gray(small * 255.0)
    gx, gy = sobel(gray)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    bin_idx = torch.clamp(((ang + math.pi) / (2 * math.pi) * 8).long(), 0,
                          7)
    r = torch.arange(64)
    cell_idx = (r[:, None] // 8) * 8 + (r[None, :] // 8)
    hog = torch.zeros(512)
    hog.index_add_(0, (cell_idx * 8 + bin_idx).reshape(-1), mag.reshape(-1))
    hog = hog / torch.clamp(torch.linalg.norm(hog), min=1e-6)
    parts = [hog, _resize_linear(small, 8, 8).reshape(-1),
             _resize_linear(gray, 8, 8).reshape(-1) / 255.0,
             _resize_linear(gray, 4, 4).reshape(-1) / 255.0]
    feats = torch.cat([x - x.mean() for x in parts])
    feats = torch.nn.functional.pad(feats, (0, dim - feats.shape[0]))
    return feats / torch.clamp(torch.linalg.norm(feats), min=1e-6)


@pytest.mark.parametrize("hw", [(48, 64), (120, 160)])
def test_hog_descriptor_holds_its_previous_value(hw):
    rng = np.random.default_rng(hw[0])
    rgb = torch.as_tensor(rng.uniform(0, 1, (*hw, 3)).astype(np.float32))
    np.testing.assert_allclose(global_descriptor(rgb).numpy(),
                               _descriptor_index_add(rgb).numpy(),
                               rtol=1e-6, atol=1e-6)
