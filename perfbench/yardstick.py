"""The yardstick: the card's published peaks and the operations and bytes a
compositing launch needs, counted from the launch's own inputs.

Frozen copy of the repository's counting (`chip_smoke.py` `_ops`, `_bound`,
`_nbytes`, and the alpha box, the survivor rule and the tile-wide stop of
`ops/composite_sorted.py`), for the default variant of K1 / K2 / K4
(float32 attrs, conic form). `work` takes K1's inputs (attrs, the band
segments, the tiles) and works out each tile's survivors and the chunks
its front-to-back walk runs before the tile-wide stop itself, so no
kernel's output and no output layout enters the count.
`perfbench/tests/test_perfbench_frozen.py` holds it equal to
`chip_smoke.py`'s `_work` on the K1 twin's outputs, on small inputs.

A survivor of a tile needs its alpha box (40 operations), outside of which
its alpha is zero for every pixel; a pair inside the box its Gaussian power
and the 1/255 test (10); a pair whose alpha passes, K1's exp / clip /
log1p / transmittance / colour sums (16), K2's replay and gradient terms
(55) or K4's (47); K4 adds 84 a survivor for the pose contraction. A
transcendental counts as one operation.
"""
from __future__ import annotations

import torch

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): HBM3 bandwidth
# and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

OPS_BOX = 40
OPS_TEST = 10
OPS_CONTRIB = {"K1": 16, "K2": 55, "K4": 47}
OPS_K4_CONTRACT = 84

CHUNK = 128
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
LOG_T_MIN = -11.5
INT_MAX = 2 ** 31 - 1
# Tiles whose chunks are counted at once: (tiles, pixels, CHUNK) blocks of
# at most 32 Mi elements on a 32-pixel tile.
BLOCK_TILES = 256
BOX_KAPPA_EPS = 64.0 * 2.0 ** -23
BOX_T_PAD = 1e-4
BOX_REL = 1.0001
BOX_ABS = 1e-3
BOX_POS = 4.0 * 2.0 ** -23


def _chunk_attrs(attrs, cols, ci):
    c = cols[:, ci * CHUNK:(ci + 1) * CHUNK].long()
    e = attrs[:10][:, c]
    if e.shape[-1] < CHUNK:
        e = torch.nn.functional.pad(e, (0, CHUNK - e.shape[-1]))
    return e


def _chunk_alpha(e, pu, pv, n_valid):
    du = pu[:, :, None] - e[0][:, None, :]
    dv = pv[:, :, None] - e[1][:, None, :]
    power = (-0.5 * (e[2][:, None, :] * du * du + e[4][:, None, :] * dv * dv)
             - e[3][:, None, :] * du * dv)
    g = torch.exp(torch.clamp(power, max=0.0))
    slot = torch.arange(CHUNK, device=e.device)
    slot_ok = slot[None, :] < n_valid[:, None]
    alpha = torch.where((power <= 0.0) & slot_ok[:, None, :],
                        e[5][:, None, :] * g, torch.zeros_like(g))
    alpha = torch.clamp(alpha, max=ALPHA_MAX)
    return torch.where(alpha < ALPHA_MIN, torch.zeros_like(alpha), alpha)


def alpha_box(mu, mv, ca, cb, cc, op):
    """The conservative pixel box outside of which a survivor's alpha is
    zero, (4, ...) rows u_lo, u_hi, v_lo, v_hi, in float32."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=mu.device)

    det = ca * cc - cb * cb
    tr = ca + cc
    slack = f32(BOX_KAPPA_EPS) * (tr * tr / det)
    t = torch.clamp(torch.log(f32(255.0) * op), min=0.0)
    q = f32(2.0) * (t + f32(BOX_T_PAD)) / (f32(1.0) - slack)
    hu = (torch.sqrt(q * cc / det) * f32(BOX_REL) + f32(BOX_ABS)
          + f32(BOX_POS) * mu.abs())
    hv = (torch.sqrt(q * ca / det) * f32(BOX_REL) + f32(BOX_ABS)
          + f32(BOX_POS) * mv.abs())
    box = torch.stack([mu - hu, mu + hu, mv - hv, mv + hv])
    inf = float("inf")
    unbounded = torch.tensor([-inf, inf, -inf, inf], device=mu.device)
    empty = torch.tensor([inf, -inf, inf, -inf], device=mu.device)
    shape = (4,) + (1,) * mu.dim()
    no_cull = (~(op >= ALPHA_MIN) | ~(ca > 0.0) | ~(cc > 0.0) | ~(det > 0.0)
               | ~(slack < 0.5))
    box = torch.where(no_cull[None], unbounded.view(shape), box)
    return torch.where((op < ALPHA_MIN)[None], empty.view(shape), box)


def survivors(attrs, seg_start, seg_cnt, tile_ids, tile: int, tiles_x: int,
              bands: int, seg_cap: int):
    """Each tile's survivors in composite order, from K1's inputs: (cols
    (S, bands * seg_cap) long, zero past the count; n_surv (S,) long).
    Candidates of band b are the columns [start_b, start_b + cnt_b) clipped
    to the seg_cap lanes from the 128-aligned start; a candidate survives
    if r > 0 and its u+-r, v+-r box overlaps the tile; survivors go in the
    order of (bits(max(depth, 1e-6)) & ~4095) | lane."""
    capt = bands * seg_cap
    tc = tile_ids.long()
    st = seg_start[tc].long()
    cnt = seg_cnt[tc].long()
    al = (st // CHUNK) * CHUNK
    lead = st - al
    lane = torch.arange(capt, device=attrs.device)
    band = lane // seg_cap
    lib = lane % seg_cap
    col = al[:, band] + lib[None, :]
    valid = (lib[None, :] >= lead[:, band]) & (
        lib[None, :] < lead[:, band] + cnt[:, band])
    col = torch.clamp(col, max=attrs.shape[1] - 1)
    sub = attrs[[0, 1, 9, 10]][:, col]
    u, v, depth, r = sub[0], sub[1], sub[2], sub[3]
    tx0 = ((tc % tiles_x) * tile).to(torch.float32)[:, None]
    ty0 = ((tc // tiles_x) * tile).to(torch.float32)[:, None]
    cover = (valid & (r > 0.0)
             & (u + r > tx0) & (u - r < tx0 + tile)
             & (v + r > ty0) & (v - r < ty0 + tile))
    dbits = torch.clamp(depth, min=1e-6).view(torch.int32)
    key = torch.where(cover, (dbits & ~4095) | lane.to(torch.int32),
                      INT_MAX - capt + lane.to(torch.int32))
    cols = torch.gather(col, 1, torch.argsort(key, dim=1))
    n_surv = cover.sum(1)
    keep = lane[None, :] < n_surv[:, None]
    return torch.where(keep, cols, torch.zeros_like(cols)), n_surv


def _in_range(lo, hi, start, tile: int):
    """How many integers p of [start, start + tile) have lo <= p <= hi
    (float32 rows; 0 where a bound is NaN, as a comparison with NaN is
    false)."""
    first = torch.maximum(torch.ceil(lo), start)
    last = torch.minimum(torch.floor(hi), start + (tile - 1))
    return torch.nan_to_num(torch.clamp(last - first + 1.0, min=0.0),
                            nan=0.0).long()


@torch.no_grad()
def work(attrs, seg_start, seg_cnt, tile_ids, tile: int, tiles_x: int,
         bands: int, seg_cap: int) -> dict:
    """What K1's inputs make a compositing kernel do: each tile's survivors
    (`survivors`) walked front to back in chunks of 128 until the tile-wide
    stop (before a chunk, no pixel of the tile has log T above -11.5).
    pairs, (pixel, survivor) pairs of the chunks run; boxed, those inside
    their survivor's alpha box; contrib, those whose alpha passed the
    1/255 test; replayed, the survivors of the chunks run. Each chunk is
    worked out for the tiles still running only; a survivor's boxed pixels
    are counted as the product of the pixel columns and rows of the tile
    inside its box."""
    dev = attrs.device
    replayed = torch.zeros((), dtype=torch.int64, device=dev)
    boxed = torch.zeros_like(replayed)
    contrib = torch.zeros_like(replayed)
    slot = torch.arange(CHUNK, device=dev)
    px = torch.arange(tile * tile, device=dev)
    lu = (px % tile).to(torch.float32)
    lv = (px // tile).to(torch.float32)
    for b in range(0, tile_ids.shape[0], BLOCK_TILES):
        ids = tile_ids[b:b + BLOCK_TILES]
        cols, n_surv = survivors(attrs, seg_start, seg_cnt, ids, tile,
                                 tiles_x, bands, seg_cap)
        tc = ids.long()
        tx0 = ((tc % tiles_x) * tile).to(torch.float32)
        ty0 = ((tc // tiles_x) * tile).to(torch.float32)
        n_chunks = (n_surv + CHUNK - 1) // CHUNK
        eff = torch.zeros_like(n_surv)
        run = torch.arange(ids.shape[0], device=dev)   # tiles still running
        log_t = torch.zeros((ids.shape[0], tile * tile), dtype=torch.float32,
                            device=dev)
        ci = 0
        while run.numel():
            go = (ci < n_chunks[run]) & (log_t.amax(1) > LOG_T_MIN)
            keep = go.nonzero().squeeze(1)
            if keep.numel() < run.numel():
                run, log_t = run[keep], log_t[keep]
                if not run.numel():
                    break
            eff[run] += 1
            n_valid = n_surv[run] - ci * CHUNK
            e = _chunk_attrs(attrs, cols[run], ci)
            pu = lu[None, :] + tx0[run][:, None]
            pv = lv[None, :] + ty0[run][:, None]
            alpha = _chunk_alpha(e, pu, pv, n_valid)
            log_t = log_t + torch.log1p(-alpha).sum(-1)
            contrib += (alpha > 0).sum()
            box = alpha_box(e[0], e[1], e[2], e[3], e[4], e[5])
            inside = (_in_range(box[0], box[1], tx0[run][:, None], tile)
                      * _in_range(box[2], box[3], ty0[run][:, None], tile))
            boxed += torch.where(slot[None, :] < n_valid[:, None], inside,
                                 torch.zeros_like(inside)).sum()
            ci += 1
        replayed += torch.minimum(n_surv, eff * CHUNK).sum()
    replayed, boxed, contrib = int(replayed), int(boxed), int(contrib)
    return {"pairs": replayed * tile * tile, "boxed": boxed,
            "contrib": contrib, "replayed": replayed}


def ops(kernel: str, w: dict) -> int:
    """FP32 operations `kernel` (K1, K2 or K4) needs on the work `w`."""
    n = (OPS_BOX * w["replayed"] + OPS_TEST * w["boxed"]
         + OPS_CONTRIB[kernel] * w["contrib"])
    return n + (OPS_K4_CONTRACT * w["replayed"] if kernel == "K4" else 0)


def bound_s(nbytes: int, n_ops: int) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the FP32 peak (seconds)."""
    return max(nbytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)
