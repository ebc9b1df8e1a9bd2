"""Sorted-backend compositing: the K1 (forward), K2 (backward), K3
(windowed backward) and K4 (pose-contraction backward) kernels, their plain
PyTorch twins, the autograd.Function that joins K1 with K2 or K3, and the
build of every kernel in `csrc/`.

Replaces `eags_slam_tpu.ops.rasterizer_pallas_v2.composite_sorted`
(`_fwd_kernel`, `_bwd_kernel` with window=False and window=True,
`_replay_chunks`, `_bwd_rmw_window`), `pose_grad_sorted`
(`_pose_bwd_kernel`) and the constants + `_chunk_alpha` of
`rasterizer_pallas.py`.

Semantics (identical in kernel and twin):
  - attrs (16, Npad) f32, rows 0 u, 1 v, 2-4 conic a/b/c, 5 opacity,
    6-8 rgb, 9 depth, 10 radius (coverage only), 11-15 zero; the columns are
    in (center tile, depth) order; seg_start / seg_cnt (T, bands) i32 give
    each tile's band segments; tile_ids (S,) i32 picks the tiles to render.
  - Candidates of band b are the columns [start_b, start_b + cnt_b), clipped
    to the seg_cap lanes from the 128-aligned start. A candidate survives if
    r > 0 and its u+-r, v+-r box overlaps the tile. Survivors are ordered by
    the key (bits(max(depth, 1e-6)) & ~4095) | lane, lane = b * seg_cap +
    column - aligned_start_b (unique, so the order is total).
  - Front-to-back compositing in chunks of 128 survivors, log-space
    transmittance, alpha = min(op * exp(power), 0.99), zero when power > 0
    or alpha < 1/255. Before each chunk the tile stops if no pixel has
    log T > -11.5.
  - out (S, 8, PX): 0-2 rgb, 3 depth (weighted sum), 4 alpha = 1 - T,
    5 log T, 6 chunks used, 7 survivors. The TPU kernel's (S, 16, PX) block
    with group padding is this array's channels 0-7 for its first S rows.
  - The forward also returns cols (S, bands * seg_cap) i32: each tile's
    survivor columns in depth order (entries past the survivor count are
    unused). The backward replays from it; the format is internal.
  - The backward mirrors `_replay_chunks` term by term, including dop =
    sum(d_alpha * g) with g = exp(min(power, 0)) where alpha was clipped at
    0.99, and the max(1 - alpha, 1e-6) guard. Grads land in (16, Npad).
  - Every kernel (K1-K4 here, K5 / K6 in `composite_entries`) skips the
    (pixel, survivor) pairs outside each survivor's conservative alpha box
    (`alpha_box`), where alpha is zero: the skip changes no sum.
  - K3 computes K2's grads with another accumulation (`rmw_window`): a
    thread-block cluster takes a run of consecutive entries of tile_ids
    (at most `group`; `window_run` takes one)
    and keeps, per band, a window of the band's seg_cap lanes in the
    cluster's shared memory, adding each lane to the global array once,
    when the window moves past it.
    The sums are K2's, so K2's twin is K3's plain version.
  - K4 replays as K2 does but keeps only the 6 pose-dependent rows
    (`GROWS`: u, v, conic a/b/c, depth) and contracts each survivor's
    totals with its pose jacobian jac (48, Npad), row p * 6 + ch for pose
    parameter p < 7 (quat wxyz, trans xyz; row block 7 is padding), column
    in the attrs' sorted order. It returns dpose (7,).

Two options of the JAX kernels, each a variant of K1-K4:
  - `quadform` (RasterConfig.kernel_quadform): the Gaussian power in
    tile-local pixel coordinates as the expanded quadratic form
    [lu^2, lv^2, lu lv, lu, lv, 1] . G, G the survivor's six coefficients
    (`_quad_coeffs`), summed in one fixed order with every multiply and add
    rounded (`_quad_power`), so the kernels repeat the twin's alpha
    decisions; K1's rules follow. The backward forms each survivor's five
    geometry grads from the six dpower-weighted basis moments
    (`_quad_geometry_grads`), not from per-pair offsets. The kernels cull
    with `quad_alpha_box`, the alpha box widened by a bound on the expanded
    form's float32 error.
  - `bf16` (RasterConfig.kernel_bf16): the kernels read the attrs in the
    bf16 layout of `to_bf16_layout` (u, v and depth as hi / lo pairs, the
    other rows as single bf16 values) and rebuild float32 exactly as JAX's
    `_rebuild_f32` (`rebuild_f32`); everything after the rebuild, the
    transmittance and the backward's suffix sums included, is float32. (The
    TPU kernel also rounds the inputs of its triangular prefix / suffix
    matmuls to bf16; linear T has no such matmul, so that rounding has no
    counterpart here.) A wrapper takes the bf16 option from the attrs'
    dtype: float32 attrs, or their bf16 layout.

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernel (built from `csrc/` at first use) or raises. There is no other
fallback. `counts()` holds the kernel launches (`fwd_launches`,
`bwd_launches`, `window_launches`, `pose_launches`) and the twin calls
(`fwd_twin_calls`, `bwd_twin_calls`, `window_twin_calls`,
`pose_twin_calls`; a K3 call on CPU tensors runs K2's twin and counts as
`window_twin_calls`) of the main path; `variant_counts()` splits the
launches by variant (`VARIANTS`). Work that runs beside it (the loop
closer, on its own CUDA stream and thread) counts apart under a tag
(`counting_as`, `counts(tag)`).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

NCH = 16
CHUNK = 128
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
LOG_T_MIN = -11.5
OUT_CH = 8
MAX_CAPT = 4096
INT_MAX = 2**31 - 1
PJ = 6                       # pose-dependent attr rows per pose parameter
P_MAX = 8                    # pose parameters, padded (7 used)
GROWS = (0, 1, 2, 3, 4, 9)   # attr rows matching the PJ jacobian channels

MAX_BANDS = 8

last_window_run = 0          # the run K3's last launch took

# ---------------------------------------------------------------------------
# Launch counts, kept apart by tag
# ---------------------------------------------------------------------------

MAIN = "main"
_count_lock = threading.Lock()
_stream_tags = {}            # CUDA stream handle -> tag
_local = threading.local()   # .tag: this thread's tag (CPU twins)


def count_tag(device: torch.device) -> str:
    """The tag a launch on `device` counts under: the current CUDA stream's
    (a backward runs on its forward's stream, in the autograd engine's
    thread) on the card, this thread's on the CPU, else MAIN."""
    if device.type == "cuda":
        tag = _stream_tags.get(torch.cuda.current_stream(device).cuda_stream)
    else:
        tag = getattr(_local, "tag", None)
    return MAIN if tag is None else tag


@contextlib.contextmanager
def counting_as(tag: str, stream=None):
    """Count the launches made on `stream` and the twin calls of this
    thread under `tag`, apart from the main path's counts."""
    prev = getattr(_local, "tag", None)
    _local.tag = tag
    if stream is not None:
        _stream_tags[stream.cuda_stream] = tag
    try:
        yield
    finally:
        _local.tag = prev
        if stream is not None:
            _stream_tags.pop(stream.cuda_stream, None)


class LaunchCounts:
    """Counters of `keys`, one set per tag."""

    def __init__(self, keys):
        self.keys = tuple(keys)
        self._by_tag = {}

    def reset(self) -> None:
        with _count_lock:
            self._by_tag = {}

    def bump(self, key: str, device: torch.device) -> None:
        tag = count_tag(device)
        with _count_lock:
            d = self._by_tag.setdefault(tag, dict.fromkeys(self.keys, 0))
            d[key] += 1

    def get(self, tag: str = MAIN) -> dict:
        with _count_lock:
            return dict(self._by_tag.get(tag)
                        or dict.fromkeys(self.keys, 0))


_counts = LaunchCounts((
    "fwd_launches", "bwd_launches", "window_launches", "pose_launches",
    "fwd_twin_calls", "bwd_twin_calls", "window_twin_calls",
    "pose_twin_calls"))
# Launches by variant, keys "K1.default", "K2.quadform_bf16", ...
VARIANTS = ("default", "quadform", "bf16", "quadform_bf16")
_variants = LaunchCounts(f"{k}.{v}" for k in ("K1", "K2", "K3", "K4")
                         for v in VARIANTS)


def reset_counts() -> None:
    """Zero every tag's counts."""
    _counts.reset()
    _variants.reset()


def counts(tag: str = MAIN) -> dict:
    """Kernel launches and twin calls counted under `tag`."""
    return _counts.get(tag)


def variant_counts(tag: str = MAIN) -> dict:
    """Kernel launches by variant: {"K1": {variant: n}, ..., "K4": ...}."""
    c = _variants.get(tag)
    return {kid: {v: c[f"{kid}.{v}"] for v in VARIANTS}
            for kid in ("K1", "K2", "K3", "K4")}


def _bump_launch(key: str, kid: str, attrs, quadform: bool):
    """Count a launch of kernel `kid` (`key`) and of its variant."""
    _counts.bump(key, attrs.device)
    variant = VARIANTS[int(quadform) + 2 * int(_is_bf16(attrs))]
    _variants.bump(f"{kid}.{variant}", attrs.device)


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def _pixel_coords(tile_ids, tile, tiles_x):
    """Global pixel centres (integer convention) per selected tile: (S, PX)."""
    dev = tile_ids.device
    p = torch.arange(tile * tile, device=dev)
    lu = (p % tile).to(torch.float32)
    lv = (p // tile).to(torch.float32)
    tc = tile_ids.long()
    tx0 = ((tc % tiles_x) * tile).to(torch.float32)
    ty0 = ((tc // tiles_x) * tile).to(torch.float32)
    return lu[None, :] + tx0[:, None], lv[None, :] + ty0[:, None]


def _survivors(attrs, seg_start, seg_cnt, tile_ids, tile, tiles_x, bands,
               seg_cap):
    """Covered candidates of each tile in key order: (cols (S, capt) i32,
    n_surv (S,) i64)."""
    capt = bands * seg_cap
    tc = tile_ids.long()
    st = seg_start[tc].long()                          # (S, bands)
    cnt = seg_cnt[tc].long()
    al = (st // CHUNK) * CHUNK
    lead = st - al
    lane = torch.arange(capt, device=attrs.device)
    band = lane // seg_cap
    lib = lane % seg_cap
    col = al[:, band] + lib[None, :]                   # (S, capt)
    valid = (lib[None, :] >= lead[:, band]) & (
        lib[None, :] < lead[:, band] + cnt[:, band])
    sub = attrs[[0, 1, 9, 10]][:, col]                 # (4, S, capt)
    u, v, depth, r = sub[0], sub[1], sub[2], sub[3]
    tx0 = ((tc % tiles_x) * tile).to(torch.float32)[:, None]
    ty0 = ((tc // tiles_x) * tile).to(torch.float32)[:, None]
    cover = (valid & (r > 0.0)
             & (u + r > tx0) & (u - r < tx0 + tile)
             & (v + r > ty0) & (v - r < ty0 + tile))
    dbits = torch.clamp(depth, min=1e-6).view(torch.int32)
    key = torch.where(cover, (dbits & ~4095) | lane.to(torch.int32),
                      INT_MAX - capt + lane.to(torch.int32))
    order = torch.argsort(key, dim=1)
    cols = torch.gather(col, 1, order)
    n_surv = cover.sum(1)
    keep = lane[None, :] < n_surv[:, None]
    cols = torch.where(keep, cols, torch.zeros_like(cols)).to(torch.int32)
    return cols, n_surv


def _chunk_attrs(attrs, cols, ci):
    """(10, S, CHUNK) attrs of chunk `ci` of every tile's survivor list."""
    c = cols[:, ci * CHUNK:(ci + 1) * CHUNK].long()
    e = attrs[:10][:, c]
    if e.shape[-1] < CHUNK:
        e = torch.nn.functional.pad(e, (0, CHUNK - e.shape[-1]))
    return e


def _chunk_alpha(e, pu, pv, n_valid):
    """Alphas (S, PX, CHUNK); same rules as rasterizer_pallas._chunk_alpha.
    Returns (alpha, g, du, dv)."""
    du = pu[:, :, None] - e[0][:, None, :]
    dv = pv[:, :, None] - e[1][:, None, :]
    power = (-0.5 * (e[2][:, None, :] * du * du + e[4][:, None, :] * dv * dv)
             - e[3][:, None, :] * du * dv)
    g = torch.exp(torch.clamp(power, max=0.0))
    slot = torch.arange(CHUNK, device=e.device)
    slot_ok = slot[None, :] < n_valid[:, None]         # (S, CHUNK)
    alpha = torch.where((power <= 0.0) & slot_ok[:, None, :],
                        e[5][:, None, :] * g, torch.zeros_like(g))
    alpha = torch.clamp(alpha, max=ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_MIN, torch.zeros_like(alpha), alpha)
    return alpha, g, du, dv


# ---------------------------------------------------------------------------
# The bf16 layout (kernel_bf16)
# ---------------------------------------------------------------------------


def to_bf16_layout(attrs):
    """(16, Npad) float32 attrs -> their (16, Npad) bf16 layout, as JAX's
    `to_bf16_layout`: 0 u_hi, 1 u_lo, 2 v_hi, 3 v_lo, 4-6 conic a/b/c,
    7 opacity, 8-10 rgb, 11 depth_hi, 12 depth_lo, 13 radius, 14-15 zero.
    hi is the nearest bf16, lo the nearest bf16 to the remainder."""
    bf = torch.bfloat16

    def split(x):
        hi = x.to(bf)
        return hi, (x - hi.to(torch.float32)).to(bf)

    u_hi, u_lo = split(attrs[0])
    v_hi, v_lo = split(attrs[1])
    d_hi, d_lo = split(attrs[9])
    b16 = attrs.to(bf)
    z = torch.zeros_like(u_hi)
    return torch.stack([u_hi, u_lo, v_hi, v_lo, b16[2], b16[3], b16[4],
                        b16[5], b16[6], b16[7], b16[8], d_hi, d_lo, b16[10],
                        z, z]).contiguous()


def rebuild_f32(layout):
    """The float32 attrs (16, Npad) of a bf16 layout, as JAX's
    `_rebuild_f32` and the kernels rebuild them: hi + lo for u, v and
    depth, the other rows widened, rows 11-15 zero."""
    f = layout.to(torch.float32)
    out = torch.zeros_like(f)
    out[0] = f[0] + f[1]
    out[1] = f[2] + f[3]
    out[2:9] = f[4:11]
    out[9] = f[11] + f[12]
    out[10] = f[13]
    return out


def _is_bf16(attrs) -> bool:
    return attrs.dtype == torch.bfloat16


def _as_f32(attrs):
    """The float32 attrs a twin computes on: the rebuild of a bf16
    layout, else the attrs themselves."""
    return rebuild_f32(attrs) if _is_bf16(attrs) else attrs


# ---------------------------------------------------------------------------
# The expanded quadratic form (kernel_quadform)
# ---------------------------------------------------------------------------


def _basis(tile: int, device):
    """(5, PX) tile-local basis rows lu^2, lv^2, lu lv, lu, lv (the 1 of
    JAX's `_basis` multiplies the constant coefficient). Exact integers."""
    p = torch.arange(tile * tile, device=device)
    lu = (p % tile).to(torch.float32)
    lv = (p // tile).to(torch.float32)
    return torch.stack([lu * lu, lv * lv, lu * lv, lu, lv])


def _quad_coeffs(e, tx0, ty0):
    """Each survivor's coefficients (6, S, CHUNK) and tile-local mean u_, v_
    (S, CHUNK), as JAX's `_gmat_chunk`: [-a/2, -c/2, -b, a u_ + b v_,
    c v_ + b u_, -(a u_^2 + c v_^2) / 2 - b u_ v_], each operation rounded
    in this order (csrc/alpha_box.cuh `quad_coeffs` repeats it)."""
    u_ = e[0] - tx0[:, None]
    v_ = e[1] - ty0[:, None]
    a, b, c = e[2], e[3], e[4]
    g3 = a * u_ + b * v_
    g4 = c * v_ + b * u_
    g5 = -0.5 * (a * u_ * u_ + c * v_ * v_) - b * u_ * v_
    return torch.stack([-0.5 * a, -0.5 * c, -b, g3, g4, g5]), u_, v_


def _quad_power(G, basis):
    """Power (S, PX, CHUNK) = ((((g0 L0 + g1 L1) + g2 L2) + g3 L3) + g4 L4)
    + g5: one fixed order, every multiply and add rounded (no FMA), the
    order of csrc/alpha_box.cuh `quad_alpha`."""
    g = G[:, :, None, :]                                 # (6, S, 1, CHUNK)
    L = basis[:, None, :, None]                          # (5, 1, PX, 1)
    power = g[0] * L[0] + g[1] * L[1]
    power = power + g[2] * L[2]
    power = power + g[3] * L[3]
    power = power + g[4] * L[4]
    return power + g[5]


def _chunk_alpha_quad(e, basis, tx0, ty0, n_valid):
    """`_chunk_alpha` under quadform (JAX `_chunk_alpha_mxu`): the power
    from the expanded form, then the same rules (power > 0, the 0.99 clip,
    the 1/255 test). Returns (alpha, g, u_, v_)."""
    G, u_, v_ = _quad_coeffs(e, tx0, ty0)
    power = _quad_power(G, basis)
    g = torch.exp(torch.clamp(power, max=0.0))
    slot = torch.arange(CHUNK, device=e.device)
    slot_ok = slot[None, :] < n_valid[:, None]
    alpha = torch.where((power <= 0.0) & slot_ok[:, None, :],
                        e[5][:, None, :] * g, torch.zeros_like(g))
    alpha = torch.clamp(alpha, max=ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_MIN, torch.zeros_like(alpha), alpha)
    return alpha, g, u_, v_


def _quad_geometry_grads(basis, dpower, u_, v_, e):
    """The five geometry grads (5, S, CHUNK) of u, v, conic a/b/c from the
    dpower-weighted basis moments S_k = sum_p dpower L_k (S5: the plain
    sum), contracted as JAX's `_replay_chunks` under quadform."""
    S = torch.einsum("kp,spc->ksc", basis, dpower)
    s5 = dpower.sum(1)
    a, b, c = e[2], e[3], e[4]
    su = S[3] - u_ * s5
    sv = S[4] - v_ * s5
    return torch.stack([
        a * su + b * sv,
        c * sv + b * su,
        -0.5 * (S[0] - 2.0 * u_ * S[3] + u_ * u_ * s5),
        -(S[2] - u_ * S[4] - v_ * S[3] + u_ * v_ * s5),
        -0.5 * (S[1] - 2.0 * v_ * S[4] + v_ * v_ * s5),
    ])


def _tile_origin(tile_ids, tile: int, tiles_x: int):
    tc = tile_ids.long()
    return (((tc % tiles_x) * tile).to(torch.float32),
            ((tc // tiles_x) * tile).to(torch.float32))


# The alpha box of csrc/alpha_box.cuh (every kernel skips a warp's patch
# that misses it). Widening: the float32 quadratic form may
# undershoot the exact one by ~12 eps kappa of itself, kappa = (a + c)^2 /
# det.
BOX_KAPPA_EPS = 64.0 * 2.0 ** -23
BOX_T_PAD = 1e-4
BOX_REL = 1.0001
BOX_ABS = 1e-3
BOX_POS = 4.0 * 2.0 ** -23
# Under quadform the power is the expanded form's, whose float32 sum is off
# the exact power by at most ~9 eps/2 of the sum of its terms' magnitudes,
# S = (|a| U^2 + |c| V^2) / 2 + |b| U V with U = tile + |u_|, V = tile +
# |v_| (tile-local |lu|, |lv| < tile): t grows by 16 eps S.
BOX_QUAD_EPS = 16.0 * 2.0 ** -23


def alpha_box(mu, mv, ca, cb, cc, op, t_pad=None):
    """Conservative pixel box per gaussian outside of which `_chunk_alpha`
    is zero, in float32 as `eags::alpha_box` computes it: (4, ...) rows
    u_lo, u_hi, v_lo, v_hi. The ellipse op * exp(power) >= 1/255 has
    half-widths sqrt(2 t c / det) in u and sqrt(2 t a / det) in v, t =
    ln(255 op); 2 t becomes 2 (t + t_pad) / (1 - 64 eps kappa), t_pad 1e-4
    (or `quad_alpha_box`'s), and the half-widths grow by 1e-4 relative,
    1e-3 px and 4 ulp of the mean. op < 1/255 gives an empty box; a conic
    that is not positive definite or has 64 eps kappa >= 0.5 gives an
    unbounded one (no cull)."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=mu.device)

    det = ca * cc - cb * cb
    tr = ca + cc
    slack = f32(BOX_KAPPA_EPS) * (tr * tr / det)
    t = torch.clamp(torch.log(f32(255.0) * op), min=0.0)
    t_pad = f32(BOX_T_PAD) if t_pad is None else t_pad
    q = f32(2.0) * (t + t_pad) / (f32(1.0) - slack)
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


def quad_alpha_box(mu, mv, ca, cb, cc, op, u_, v_, tile: int):
    """`alpha_box` for the quadform alpha of a tile whose tile-local mean
    is (u_, v_): t_pad grows by BOX_QUAD_EPS times the bound S on the
    expanded form's terms, as `eags::quad_box` computes it."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=mu.device)

    au = f32(float(tile)) + u_.abs()
    av = f32(float(tile)) + v_.abs()
    s = (f32(0.5) * (ca.abs() * au * au + cc.abs() * av * av)
         + cb.abs() * au * av)
    return alpha_box(mu, mv, ca, cb, cc, op,
                     t_pad=f32(BOX_T_PAD) + f32(BOX_QUAD_EPS) * s)


@torch.no_grad()
def composite_sorted_fwd_plain(attrs, seg_start, seg_cnt, tile_ids,
                               tile: int, tiles_x: int, bands: int,
                               seg_cap: int, quadform: bool = False):
    """Plain PyTorch twin of K1 (attrs float32, or their bf16 layout).
    Returns (out (S, 8, PX), cols (S, capt))."""
    _counts.bump("fwd_twin_calls", attrs.device)
    attrs = _as_f32(attrs)
    cols, n_surv = _survivors(attrs, seg_start, seg_cnt, tile_ids, tile,
                              tiles_x, bands, seg_cap)
    return _composite_cols(attrs, cols, n_surv, tile_ids, tile, tiles_x,
                           quadform), cols


def _alpha_of(tile_ids, tile: int, tiles_x: int, quadform: bool, device):
    """The chunk alpha of the tiles `tile_ids`: f(e, n_valid) -> (alpha,
    g, x, y), (x, y) the per-pair offsets du, dv (conic form) or the
    tile-local means u_, v_ (quadform)."""
    if quadform:
        basis = _basis(tile, device)
        tx0, ty0 = _tile_origin(tile_ids, tile, tiles_x)
        return lambda e, n: _chunk_alpha_quad(e, basis, tx0, ty0, n)
    pu, pv = _pixel_coords(tile_ids, tile, tiles_x)
    return lambda e, n: _chunk_alpha(e, pu, pv, n)


def _composite_cols(attrs, cols, n_surv, tile_ids, tile: int, tiles_x: int,
                    quadform: bool = False):
    """Front-to-back compositing of each tile's first `n_surv` columns of
    `cols` (S, L), in chunks of 128 with the tile-wide stop. Returns out
    (S, 8, PX); channel 7 holds n_surv."""
    s = tile_ids.shape[0]
    px = tile * tile
    alpha_fn = _alpha_of(tile_ids, tile, tiles_x, quadform, attrs.device)
    num_chunks = (n_surv + CHUNK - 1) // CHUNK
    log_t = torch.zeros((s, px), dtype=torch.float32, device=attrs.device)
    acc = torch.zeros((s, px, 4), dtype=torch.float32, device=attrs.device)
    eff = torch.zeros(s, dtype=torch.int64, device=attrs.device)
    active = torch.ones(s, dtype=torch.bool, device=attrs.device)
    for ci in range(int(num_chunks.max()) if s else 0):
        active = active & (ci < num_chunks) & (log_t.amax(1) > LOG_T_MIN)
        if not bool(active.any()):
            break
        e = _chunk_attrs(attrs, cols, ci)
        alpha = alpha_fn(e, n_surv - ci * CHUNK)[0]
        log1m = torch.log1p(-alpha)
        excl = torch.cumsum(log1m, -1) - log1m
        w = alpha * torch.exp(excl + log_t[:, :, None])
        contrib = torch.einsum("spk,fsk->spf", w, e[6:10])
        m = active[:, None]
        acc = torch.where(m[:, :, None], acc + contrib, acc)
        log_t = torch.where(m, log_t + log1m.sum(-1), log_t)
        eff = eff + active.long()
    return torch.cat([
        acc.permute(0, 2, 1),
        (1.0 - torch.exp(log_t))[:, None],
        log_t[:, None],
        eff.to(torch.float32)[:, None, None].expand(s, 1, px),
        n_surv.to(torch.float32)[:, None, None].expand(s, 1, px),
    ], dim=1).contiguous()


@torch.no_grad()
def composite_sorted_bwd_plain(attrs, tile_ids, out, cols, dout, tile: int,
                               tiles_x: int, quadform: bool = False):
    """Plain PyTorch twin of K2: the analytic reverse chunk replay of
    `_replay_chunks`. Returns grads (16, Npad) float32."""
    _counts.bump("bwd_twin_calls", attrs.device)
    return _replay_grads(attrs, tile_ids, out, cols, dout, tile, tiles_x,
                         quadform)


@torch.no_grad()
def pose_grad_sorted_plain(attrs, jac, tile_ids, out, cols, dout, tile: int,
                           tiles_x: int, quadform: bool = False):
    """Plain PyTorch twin of K4: K2's replay grads, rows GROWS, contracted
    with the pose jacobian. Returns dpose (7,)."""
    _counts.bump("pose_twin_calls", attrs.device)
    g = _replay_grads(attrs, tile_ids, out, cols, dout, tile, tiles_x,
                      quadform)
    gsel = g[list(GROWS)]                                # (6, Npad)
    return (jac[: 7 * PJ].reshape(7, PJ, -1) * gsel[None]).sum((1, 2))


def _replay_grads(attrs, tile_ids, out, cols, dout, tile: int,
                  tiles_x: int, quadform: bool = False):
    attrs = _as_f32(attrs)
    grads = torch.zeros_like(attrs)
    s = tile_ids.shape[0]
    if s == 0:
        return grads
    # K1 leaves the columns past each tile's survivor count unwritten.
    lane = torch.arange(cols.shape[1], device=cols.device)
    cols = torch.where(lane[None, :] < out[:, 7, :1].long(), cols,
                       torch.zeros_like(cols))
    alpha_fn = _alpha_of(tile_ids, tile, tiles_x, quadform, attrs.device)
    basis = _basis(tile, attrs.device) if quadform else None
    dout_px = dout[:, 0:4].permute(0, 2, 1)            # (S, PX, 4)
    d_alpha_map = dout[:, 4]                           # (S, PX)
    log_t_end = out[:, 5].clone()
    eff = out[:, 6, 0].long()
    n_surv = out[:, 7, 0].long()
    bvec = torch.zeros_like(log_t_end)
    for ci in range(int(eff.max()) - 1, -1, -1):
        live = ci < eff                                # (S,)
        e = _chunk_attrs(attrs, cols, ci)
        alpha, g_, x_, y_ = alpha_fn(e, n_surv - ci * CHUNK)
        log1m = torch.log1p(-alpha)
        excl = torch.cumsum(log1m, -1) - log1m
        log_t_in = log_t_end - log1m.sum(-1)
        T_i = torch.exp(excl + log_t_in[:, :, None])
        w = alpha * T_i
        q = torch.einsum("spc,csk->spk", dout_px, e[6:10]) \
            + d_alpha_map[:, :, None]
        wq = w * q
        suffix = wq.sum(-1, keepdim=True) - torch.cumsum(wq, -1)
        one_m = torch.clamp(1.0 - alpha, min=1e-6)
        d_alpha = T_i * q - (bvec[:, :, None] + suffix) / one_m
        d_alpha = torch.where(alpha > 0.0, d_alpha, torch.zeros_like(d_alpha))
        dfeat = torch.einsum("spc,spk->csk", dout_px, w)      # (4, S, CHUNK)
        dop = (d_alpha * g_).sum(1)
        dpower = d_alpha * alpha
        if quadform:
            geo = _quad_geometry_grads(basis, dpower, x_, y_, e)
        else:
            du, dv = x_, y_
            a_, b_, c_ = e[2][:, None, :], e[3][:, None, :], e[4][:, None, :]
            d_du = dpower * (-(a_ * du + b_ * dv))
            d_dv = dpower * (-(c_ * dv + b_ * du))
            geo = torch.stack([
                -d_du.sum(1), -d_dv.sum(1),
                (-0.5 * du * du * dpower).sum(1),
                (-du * dv * dpower).sum(1),
                (-0.5 * dv * dv * dpower).sum(1)])
        dG = torch.cat([geo, torch.stack([dop, dfeat[0], dfeat[1], dfeat[2],
                                          dfeat[3]])])       # (10, S, CHUNK)
        slot = torch.arange(CHUNK, device=attrs.device)
        ok = live[:, None] & (slot[None, :] < (n_surv - ci * CHUNK)[:, None])
        dG = torch.where(ok[None], dG, torch.zeros_like(dG))
        c = cols[:, ci * CHUNK:(ci + 1) * CHUNK].long()
        if c.shape[1] < CHUNK:
            c = torch.nn.functional.pad(c, (0, CHUNK - c.shape[1]))
        grads[:10].index_add_(1, c.reshape(-1), dG.reshape(10, -1))
        m = live[:, None]
        bvec = torch.where(m, bvec + wq.sum(-1), bvec)
        log_t_end = torch.where(m, log_t_in, log_t_end)
    return grads


# ---------------------------------------------------------------------------
# CUDA kernels: build (nvcc, plain C interface) and bind (ctypes)
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("composite_sorted_fwd.cu", "composite_sorted_bwd.cu",
           "composite_sorted_bwd_window.cu", "pose_grad_sorted.cu",
           "composite_entries_fwd.cu", "composite_entries_bwd.cu")
HEADERS = ("alpha_box.cuh", "warp_patch.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "eags_kernels"
# Every kernel rounds its alpha decisions as the twin does with explicit
# intrinsics (`twin_alpha`, alpha_box.cuh) and uses FMA elsewhere.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]


_LIB = None
build_seconds = None
build_log = ""        # nvcc's output of the last build (-Xptxas -v lines)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit at first use")
    return path


def _run_all(cmds, what: str, verbose: bool) -> str:
    """Start every command at once, wait for all; raise if one failed.
    Returns what they printed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    log = ""
    for p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{what} failed ({p.returncode}):\n{out}\n"
                               f"{err}")
        if verbose:
            print(out + err, flush=True)
        log += out + err
    return log


def build_kernels(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into one shared library (cached by source hash):
    one nvcc per source, all started together, then one link. `verbose`
    adds -Xptxas -v and prints nvcc's output (kept in `build_log`)."""
    global build_seconds, build_log
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libeags_composite_{h.hexdigest()[:16]}.so"
    if lib.exists():
        build_seconds = 0.0
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(n).stem + ".o") for n in SOURCES]
        build_log = _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(o),
                               str(CSRC / n)] for n, o in zip(SOURCES, objs)],
                             "nvcc", verbose)
        tmp_lib = Path(tmp) / lib.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
                   *map(str, objs)]], "nvcc link", verbose)
        os.replace(tmp_lib, lib)
    build_seconds = time.perf_counter() - t0
    return lib


_load_lock = threading.Lock()


def load_kernels(verbose: bool = False):
    """Build (first use) and bind the kernels, once across threads. Raises
    without a CUDA device."""
    if _LIB is not None:
        return _LIB
    with _load_lock:
        return _load_kernels(verbose)


def _load_kernels(verbose: bool):
    global _LIB
    if _LIB is not None:
        return _LIB
    if not torch.cuda.is_available():
        raise RuntimeError("the compositing kernels need a CUDA device; CPU "
                           "tensors take the plain twins")
    lib = ctypes.CDLL(str(build_kernels(verbose)))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # Each of K1-K4 takes its variant (`_opts`) before the stream.
    lib.eags_composite_sorted_fwd.argtypes = [P, L, P, P, P, I, I, I, I, I,
                                              P, P, I, P]
    lib.eags_composite_sorted_fwd.restype = I
    lib.eags_composite_sorted_bwd.argtypes = [P, L, P, I, I, I, I, P, P, P,
                                              P, I, P]
    lib.eags_composite_sorted_bwd.restype = I
    lib.eags_composite_sorted_bwd_window.argtypes = [
        P, L, P, I, I, P, I, I, I, I, I, P, P, P, P, I, P]
    lib.eags_composite_sorted_bwd_window.restype = I
    lib.eags_pose_grad_sorted.argtypes = [P, P, L, P, I, I, I, I, P, P, P,
                                          P, I, P]
    lib.eags_pose_grad_sorted.restype = I
    lib.eags_composite_entries_fwd.argtypes = [P, L, P, P, I, I, I, P, P]
    lib.eags_composite_entries_fwd.restype = I
    lib.eags_composite_entries_bwd.argtypes = [P, L, P, I, I, I, P, P, P, P]
    lib.eags_composite_entries_bwd.restype = I
    _LIB = lib
    return lib


def _check(t, name, dtype, dim):
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dim}-d {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _check_attrs(attrs):
    """attrs: float32, or the bf16 layout (the kernel_bf16 variant)."""
    _check(attrs, "attrs", torch.bfloat16 if _is_bf16(attrs)
           else torch.float32, 2)
    if attrs.shape[0] != NCH:
        raise ValueError(f"attrs must be ({NCH}, Npad), got "
                         f"{tuple(attrs.shape)}")


def _opts(attrs, quadform: bool) -> int:
    """The variant argument of K1-K4: bit 0 quadform, bit 1 bf16."""
    return int(bool(quadform)) | (2 if _is_bf16(attrs) else 0)


def _cuda_check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def composite_sorted_fwd(attrs, seg_start, seg_cnt, tile_ids, tile: int,
                         tiles_x: int, bands: int, seg_cap: int,
                         quadform: bool = False):
    """K1 on CUDA tensors, the plain twin on CPU tensors. `attrs`: float32,
    or their bf16 layout (`to_bf16_layout`) for the bf16 variant.
    Returns (out (S, 8, PX) f32, cols (S, bands * seg_cap) i32)."""
    if attrs.device.type == "cpu":
        return composite_sorted_fwd_plain(attrs, seg_start, seg_cnt,
                                          tile_ids, tile, tiles_x, bands,
                                          seg_cap, quadform)
    if attrs.device.type != "cuda":
        raise RuntimeError(f"composite_sorted: no kernel for device "
                           f"{attrs.device}")
    lib = load_kernels()
    capt = bands * seg_cap
    if capt > MAX_CAPT or tile not in (16, 32, 64):
        raise ValueError(f"K1 takes bands*seg_cap <= {MAX_CAPT} and tile in "
                         f"(16, 32, 64); got {capt}, {tile}")
    _check_attrs(attrs)
    _check(seg_start, "seg_start", torch.int32, 2)
    _check(seg_cnt, "seg_cnt", torch.int32, 2)
    _check(tile_ids, "tile_ids", torch.int32, 1)
    if seg_start.shape[1] != bands:
        raise ValueError("the seg tables must be (T, bands)")
    s = tile_ids.shape[0]
    out = torch.empty((s, OUT_CH, tile * tile), dtype=torch.float32,
                      device=attrs.device)
    cols = torch.empty((s, capt), dtype=torch.int32, device=attrs.device)
    if s == 0:
        return out, cols
    err = lib.eags_composite_sorted_fwd(
        attrs.data_ptr(), attrs.shape[1], seg_start.data_ptr(),
        seg_cnt.data_ptr(), tile_ids.data_ptr(), s, tile, tiles_x, bands,
        seg_cap, out.data_ptr(), cols.data_ptr(), _opts(attrs, quadform),
        torch.cuda.current_stream(attrs.device).cuda_stream)
    _cuda_check(err, "K1 launch")
    _bump_launch("fwd_launches", "K1", attrs, quadform)
    return out, cols


def composite_sorted_bwd(attrs, tile_ids, out, cols, dout, tile: int,
                         tiles_x: int, quadform: bool = False):
    """K2 on CUDA tensors, the plain twin on CPU tensors (attrs as K1's).
    Returns grads (16, Npad) f32 in the float32 attrs' rows (cross-tile
    sums via atomicAdd: the summation order, and so the last bits, vary
    from run to run)."""
    if attrs.device.type == "cpu":
        return composite_sorted_bwd_plain(attrs, tile_ids, out, cols, dout,
                                          tile, tiles_x, quadform)
    if attrs.device.type != "cuda":
        raise RuntimeError(f"composite_sorted: no kernel for device "
                           f"{attrs.device}")
    lib = load_kernels()
    _check_attrs(attrs)
    for t, name, dt, dim in ((tile_ids, "tile_ids", torch.int32, 1),
                             (out, "out", torch.float32, 3),
                             (cols, "cols", torch.int32, 2),
                             (dout, "dout", torch.float32, 3)):
        _check(t, name, dt, dim)
    grads = torch.zeros(attrs.shape, dtype=torch.float32,
                        device=attrs.device)
    s = tile_ids.shape[0]
    if s == 0:
        return grads
    err = lib.eags_composite_sorted_bwd(
        attrs.data_ptr(), attrs.shape[1], tile_ids.data_ptr(), s, tile,
        tiles_x, cols.shape[1], out.data_ptr(), cols.data_ptr(),
        dout.data_ptr(), grads.data_ptr(), _opts(attrs, quadform),
        torch.cuda.current_stream(attrs.device).cuda_stream)
    _cuda_check(err, "K2 launch")
    _bump_launch("bwd_launches", "K2", attrs, quadform)
    return grads


def window_run() -> int:
    """The tiles one K3 cluster replays: 1. The kernel takes any run up to
    `group`, but on the 836-tile grid runs of 2 and 6 measured slower than
    runs of 1 for every K3 design tried (PERF.md)."""
    return 1


def composite_sorted_bwd_window(attrs, seg_start, tile_ids, out, cols, dout,
                                tile: int, tiles_x: int, bands: int,
                                seg_cap: int, group: int,
                                quadform: bool = False):
    """K3 on CUDA tensors; on CPU tensors K2's twin, which is K3's plain
    version (the same sums). `seg_start` (T, bands) gives each tile's band
    windows; a cluster takes `window_run` consecutive entries of tile_ids
    (at most `group`), and `last_window_run` records the run it launched.
    attrs as K1's. Returns grads (16, Npad) f32 (lanes leave a cluster
    through global atomicAdd: the last bits vary from run to run)."""
    if attrs.device.type == "cpu":
        _counts.bump("window_twin_calls", attrs.device)
        return _replay_grads(attrs, tile_ids, out, cols, dout, tile, tiles_x,
                             quadform)
    if attrs.device.type != "cuda":
        raise RuntimeError(f"composite_sorted: no kernel for device "
                           f"{attrs.device}")
    lib = load_kernels()
    _check_attrs(attrs)
    for t, name, dt, dim in ((seg_start, "seg_start", torch.int32, 2),
                             (tile_ids, "tile_ids", torch.int32, 1),
                             (out, "out", torch.float32, 3),
                             (cols, "cols", torch.int32, 2),
                             (dout, "dout", torch.float32, 3)):
        _check(t, name, dt, dim)
    if (bands * seg_cap > MAX_CAPT or bands > MAX_BANDS or seg_cap % CHUNK
            or group < 1 or seg_start.shape[1] != bands):
        raise ValueError(f"K3 takes bands <= {MAX_BANDS}, bands*seg_cap <= "
                         f"{MAX_CAPT}, seg_cap a multiple of {CHUNK}, "
                         f"group >= 1; got {bands}, {seg_cap}, {group}")
    grads = torch.zeros(attrs.shape, dtype=torch.float32,
                        device=attrs.device)
    s = tile_ids.shape[0]
    if s == 0:
        return grads
    global last_window_run
    run = last_window_run = min(group, window_run())
    err = lib.eags_composite_sorted_bwd_window(
        attrs.data_ptr(), attrs.shape[1], seg_start.data_ptr(), bands,
        seg_cap, tile_ids.data_ptr(), s, run, tile, tiles_x, cols.shape[1],
        out.data_ptr(), cols.data_ptr(), dout.data_ptr(), grads.data_ptr(),
        _opts(attrs, quadform),
        torch.cuda.current_stream(attrs.device).cuda_stream)
    _cuda_check(err, "K3 launch")
    _bump_launch("window_launches", "K3", attrs, quadform)
    return grads


def regions(tile: int) -> int:
    """Blocks a tile takes in K2's grid (K2, K4): the whole tile at 16,
    four quadrants at 32 and 64 (`region` in csrc/warp_patch.cuh)."""
    return 1 if tile <= 16 else 4


def pose_grad_sorted(attrs, jac, tile_ids, out, cols, dout, tile: int,
                     tiles_x: int, quadform: bool = False):
    """K4 on CUDA tensors, the plain twin on CPU tensors. `attrs` (as K1's),
    `out`, `cols` are K1's input and residuals, `dout` the (S, 8, PX)
    cotangent, `jac` (48, Npad) the pose jacobian. Returns dpose (7,) f32:
    each block (a tile's region, K2's grid) writes its 7 sums in a fixed
    order and the (S * regions, 8) partials are summed here, so the result
    does not change from run to run."""
    if attrs.device.type == "cpu":
        return pose_grad_sorted_plain(attrs, jac, tile_ids, out, cols, dout,
                                      tile, tiles_x, quadform)
    if attrs.device.type != "cuda":
        raise RuntimeError(f"pose_grad_sorted: no kernel for device "
                           f"{attrs.device}")
    lib = load_kernels()
    _check_attrs(attrs)
    for t, name, dt, dim in ((jac, "jac", torch.float32, 2),
                             (tile_ids, "tile_ids", torch.int32, 1),
                             (out, "out", torch.float32, 3),
                             (cols, "cols", torch.int32, 2),
                             (dout, "dout", torch.float32, 3)):
        _check(t, name, dt, dim)
    if jac.shape != (P_MAX * PJ, attrs.shape[1]):
        raise ValueError(f"jac must be ({P_MAX * PJ}, Npad), got "
                         f"{tuple(jac.shape)}")
    if tile not in (16, 32, 64):
        raise ValueError(f"K4 takes tile in (16, 32, 64); got {tile}")
    s = tile_ids.shape[0]
    part = torch.empty((s * regions(tile), P_MAX), dtype=torch.float32,
                       device=attrs.device)
    if s == 0:
        return part.new_zeros(7)
    err = lib.eags_pose_grad_sorted(
        attrs.data_ptr(), jac.data_ptr(), attrs.shape[1], tile_ids.data_ptr(),
        s, tile, tiles_x, cols.shape[1], out.data_ptr(), cols.data_ptr(),
        dout.data_ptr(), part.data_ptr(), _opts(attrs, quadform),
        torch.cuda.current_stream(attrs.device).cuda_stream)
    _cuda_check(err, "K4 launch")
    _bump_launch("pose_launches", "K4", attrs, quadform)
    return part.sum(0)[:7]


class CompositeSorted(torch.autograd.Function):
    """Differentiable w.r.t. attrs rows 0-9 (row 10, the radius, only
    gates coverage and gets no gradient, as in the JAX version). The
    backward is K2, or K3 with `rmw_window`. With `bf16` the float32 attrs
    go to their bf16 layout once, inside the Function, and both kernels
    read it; the grads come back in the float32 attrs' rows."""

    @staticmethod
    def forward(ctx, attrs, seg_start, seg_cnt, tile_ids, tile, tiles_x,
                bands, seg_cap, group, rmw_window, quadform, bf16):
        attrs = attrs.contiguous()
        if bf16:
            attrs = to_bf16_layout(attrs)
        out, cols = composite_sorted_fwd(attrs, seg_start, seg_cnt,
                                         tile_ids, tile, tiles_x, bands,
                                         seg_cap, quadform)
        ctx.save_for_backward(attrs, seg_start, tile_ids, out, cols)
        ctx.geom = (tile, tiles_x, bands, seg_cap, group, rmw_window,
                    quadform)
        return out

    @staticmethod
    def backward(ctx, dout):
        attrs, seg_start, tile_ids, out, cols = ctx.saved_tensors
        tile, tiles_x, bands, seg_cap, group, rmw_window, quadform = ctx.geom
        if rmw_window:
            grads = composite_sorted_bwd_window(
                attrs, seg_start, tile_ids, out, cols, dout.contiguous(),
                tile, tiles_x, bands, seg_cap, group, quadform)
        else:
            grads = composite_sorted_bwd(attrs, tile_ids, out, cols,
                                         dout.contiguous(), tile, tiles_x,
                                         quadform)
        return (grads,) + (None,) * 11


def composite_sorted(attrs_sorted, seg_start, seg_cnt, tile_ids, tile: int,
                     tiles_x: int, bands: int, seg_cap: int, group: int = 16,
                     rmw_window: bool = False, quadform: bool = False,
                     bf16: bool = False):
    """attrs_sorted (16, Npad) float32 centre-tile sorted; tile_ids (S,)
    selects the tiles. Returns (S, 8, PX) tile images (channels: see module
    doc). The backward is K3 with `rmw_window` (runs of `group` tiles),
    else K2; `quadform` and `bf16` pick the kernels' variant."""
    return CompositeSorted.apply(attrs_sorted, seg_start.to(torch.int32)
                                 .contiguous(),
                                 seg_cnt.to(torch.int32).contiguous(),
                                 tile_ids.to(torch.int32).contiguous(),
                                 tile, tiles_x, bands, seg_cap, group,
                                 rmw_window, quadform, bf16)
