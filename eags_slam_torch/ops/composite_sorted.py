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

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernel (built from `csrc/` at first use) or raises. There is no other
fallback. `fwd_launches` / `bwd_launches` / `window_launches` /
`pose_launches` count kernel launches; `fwd_twin_calls` / `bwd_twin_calls`
/ `window_twin_calls` / `pose_twin_calls` count twin calls (a K3 call on
CPU tensors runs K2's twin and counts as `window_twin_calls`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
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

fwd_launches = 0
bwd_launches = 0
window_launches = 0
pose_launches = 0
last_window_run = 0          # the run K3's last launch took
fwd_twin_calls = 0
bwd_twin_calls = 0
window_twin_calls = 0
pose_twin_calls = 0


def reset_counts() -> None:
    global fwd_launches, bwd_launches, window_launches, pose_launches
    global fwd_twin_calls, bwd_twin_calls, window_twin_calls, pose_twin_calls
    fwd_launches = bwd_launches = window_launches = pose_launches = 0
    fwd_twin_calls = bwd_twin_calls = window_twin_calls = 0
    pose_twin_calls = 0


def counts() -> dict:
    return {"fwd_launches": fwd_launches, "bwd_launches": bwd_launches,
            "window_launches": window_launches,
            "pose_launches": pose_launches,
            "fwd_twin_calls": fwd_twin_calls,
            "bwd_twin_calls": bwd_twin_calls,
            "window_twin_calls": window_twin_calls,
            "pose_twin_calls": pose_twin_calls}


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


# The alpha box of csrc/alpha_box.cuh (every kernel skips a warp's patch
# that misses it). Widening: the float32 quadratic form may
# undershoot the exact one by ~12 eps kappa of itself, kappa = (a + c)^2 /
# det.
BOX_KAPPA_EPS = 64.0 * 2.0 ** -23
BOX_T_PAD = 1e-4
BOX_REL = 1.0001
BOX_ABS = 1e-3
BOX_POS = 4.0 * 2.0 ** -23


def alpha_box(mu, mv, ca, cb, cc, op):
    """Conservative pixel box per gaussian outside of which `_chunk_alpha`
    is zero, in float32 as `eags::alpha_box` computes it: (4, ...) rows
    u_lo, u_hi, v_lo, v_hi. The ellipse op * exp(power) >= 1/255 has
    half-widths sqrt(2 t c / det) in u and sqrt(2 t a / det) in v, t =
    ln(255 op); 2 t becomes 2 (t + 1e-4) / (1 - 64 eps kappa), and the
    half-widths grow by 1e-4 relative, 1e-3 px and 4 ulp of the mean.
    op < 1/255 gives an empty box; a conic that is not positive definite or
    has 64 eps kappa >= 0.5 gives an unbounded one (no cull)."""
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


@torch.no_grad()
def composite_sorted_fwd_plain(attrs, seg_start, seg_cnt, tile_ids,
                               tile: int, tiles_x: int, bands: int,
                               seg_cap: int):
    """Plain PyTorch twin of K1. Returns (out (S, 8, PX), cols (S, capt))."""
    global fwd_twin_calls
    fwd_twin_calls += 1
    cols, n_surv = _survivors(attrs, seg_start, seg_cnt, tile_ids, tile,
                              tiles_x, bands, seg_cap)
    return _composite_cols(attrs, cols, n_surv, tile_ids, tile,
                           tiles_x), cols


def _composite_cols(attrs, cols, n_surv, tile_ids, tile: int, tiles_x: int):
    """Front-to-back compositing of each tile's first `n_surv` columns of
    `cols` (S, L), in chunks of 128 with the tile-wide stop. Returns out
    (S, 8, PX); channel 7 holds n_surv."""
    s = tile_ids.shape[0]
    px = tile * tile
    pu, pv = _pixel_coords(tile_ids, tile, tiles_x)
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
        alpha, _, _, _ = _chunk_alpha(e, pu, pv, n_surv - ci * CHUNK)
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
                               tiles_x: int):
    """Plain PyTorch twin of K2: the analytic reverse chunk replay of
    `_replay_chunks`. Returns grads (16, Npad)."""
    global bwd_twin_calls
    bwd_twin_calls += 1
    return _replay_grads(attrs, tile_ids, out, cols, dout, tile, tiles_x)


@torch.no_grad()
def pose_grad_sorted_plain(attrs, jac, tile_ids, out, cols, dout, tile: int,
                           tiles_x: int):
    """Plain PyTorch twin of K4: K2's replay grads, rows GROWS, contracted
    with the pose jacobian. Returns dpose (7,)."""
    global pose_twin_calls
    pose_twin_calls += 1
    g = _replay_grads(attrs, tile_ids, out, cols, dout, tile, tiles_x)
    gsel = g[list(GROWS)]                                # (6, Npad)
    return (jac[: 7 * PJ].reshape(7, PJ, -1) * gsel[None]).sum((1, 2))


def _replay_grads(attrs, tile_ids, out, cols, dout, tile: int,
                  tiles_x: int):
    grads = torch.zeros_like(attrs)
    s = tile_ids.shape[0]
    if s == 0:
        return grads
    # K1 leaves the columns past each tile's survivor count unwritten.
    lane = torch.arange(cols.shape[1], device=cols.device)
    cols = torch.where(lane[None, :] < out[:, 7, :1].long(), cols,
                       torch.zeros_like(cols))
    pu, pv = _pixel_coords(tile_ids, tile, tiles_x)
    dout_px = dout[:, 0:4].permute(0, 2, 1)            # (S, PX, 4)
    d_alpha_map = dout[:, 4]                           # (S, PX)
    log_t_end = out[:, 5].clone()
    eff = out[:, 6, 0].long()
    n_surv = out[:, 7, 0].long()
    bvec = torch.zeros_like(log_t_end)
    for ci in range(int(eff.max()) - 1, -1, -1):
        live = ci < eff                                # (S,)
        e = _chunk_attrs(attrs, cols, ci)
        alpha, g_, du, dv = _chunk_alpha(e, pu, pv, n_surv - ci * CHUNK)
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
        a_, b_, c_ = e[2][:, None, :], e[3][:, None, :], e[4][:, None, :]
        d_du = dpower * (-(a_ * du + b_ * dv))
        d_dv = dpower * (-(c_ * dv + b_ * du))
        dG = torch.stack([
            -d_du.sum(1), -d_dv.sum(1),
            (-0.5 * du * du * dpower).sum(1),
            (-du * dv * dpower).sum(1),
            (-0.5 * dv * dv * dpower).sum(1),
            dop, dfeat[0], dfeat[1], dfeat[2], dfeat[3],
        ])                                                    # (10, S, CHUNK)
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


def load_kernels(verbose: bool = False):
    """Build (first use) and bind the kernels. Raises without a CUDA device."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if not torch.cuda.is_available():
        raise RuntimeError("the compositing kernels need a CUDA device; CPU "
                           "tensors take the plain twins")
    lib = ctypes.CDLL(str(build_kernels(verbose)))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.eags_composite_sorted_fwd.argtypes = [P, L, P, P, P, I, I, I, I, I,
                                              P, P, P]
    lib.eags_composite_sorted_fwd.restype = I
    lib.eags_composite_sorted_bwd.argtypes = [P, L, P, I, I, I, I, P, P, P,
                                              P, P]
    lib.eags_composite_sorted_bwd.restype = I
    lib.eags_composite_sorted_bwd_window.argtypes = [
        P, L, P, I, I, P, I, I, I, I, I, P, P, P, P, P]
    lib.eags_composite_sorted_bwd_window.restype = I
    lib.eags_pose_grad_sorted.argtypes = [P, P, L, P, I, I, I, I, P, P, P,
                                          P, P]
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


def _cuda_check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def composite_sorted_fwd(attrs, seg_start, seg_cnt, tile_ids, tile: int,
                         tiles_x: int, bands: int, seg_cap: int):
    """K1 on CUDA tensors, the plain twin on CPU tensors.
    Returns (out (S, 8, PX) f32, cols (S, bands * seg_cap) i32)."""
    if attrs.device.type == "cpu":
        return composite_sorted_fwd_plain(attrs, seg_start, seg_cnt,
                                          tile_ids, tile, tiles_x, bands,
                                          seg_cap)
    if attrs.device.type != "cuda":
        raise RuntimeError(f"composite_sorted: no kernel for device "
                           f"{attrs.device}")
    global fwd_launches
    lib = load_kernels()
    capt = bands * seg_cap
    if capt > MAX_CAPT or tile not in (16, 32, 64):
        raise ValueError(f"K1 takes bands*seg_cap <= {MAX_CAPT} and tile in "
                         f"(16, 32, 64); got {capt}, {tile}")
    _check(attrs, "attrs", torch.float32, 2)
    _check(seg_start, "seg_start", torch.int32, 2)
    _check(seg_cnt, "seg_cnt", torch.int32, 2)
    _check(tile_ids, "tile_ids", torch.int32, 1)
    if attrs.shape[0] != NCH or seg_start.shape[1] != bands:
        raise ValueError("attrs must be (16, Npad), seg tables (T, bands)")
    s = tile_ids.shape[0]
    out = torch.empty((s, OUT_CH, tile * tile), dtype=torch.float32,
                      device=attrs.device)
    cols = torch.empty((s, capt), dtype=torch.int32, device=attrs.device)
    if s == 0:
        return out, cols
    err = lib.eags_composite_sorted_fwd(
        attrs.data_ptr(), attrs.shape[1], seg_start.data_ptr(),
        seg_cnt.data_ptr(), tile_ids.data_ptr(), s, tile, tiles_x, bands,
        seg_cap, out.data_ptr(), cols.data_ptr(),
        torch.cuda.current_stream(attrs.device).cuda_stream)
    _cuda_check(err, "K1 launch")
    fwd_launches += 1
    return out, cols


def composite_sorted_bwd(attrs, tile_ids, out, cols, dout, tile: int,
                         tiles_x: int):
    """K2 on CUDA tensors, the plain twin on CPU tensors. Returns grads
    (16, Npad) f32 (cross-tile sums via atomicAdd: the summation order, and
    so the last bits, vary from run to run)."""
    if attrs.device.type == "cpu":
        return composite_sorted_bwd_plain(attrs, tile_ids, out, cols, dout,
                                          tile, tiles_x)
    if attrs.device.type != "cuda":
        raise RuntimeError(f"composite_sorted: no kernel for device "
                           f"{attrs.device}")
    global bwd_launches
    lib = load_kernels()
    for t, name, dt, dim in ((attrs, "attrs", torch.float32, 2),
                             (tile_ids, "tile_ids", torch.int32, 1),
                             (out, "out", torch.float32, 3),
                             (cols, "cols", torch.int32, 2),
                             (dout, "dout", torch.float32, 3)):
        _check(t, name, dt, dim)
    grads = torch.zeros_like(attrs)
    s = tile_ids.shape[0]
    if s == 0:
        return grads
    err = lib.eags_composite_sorted_bwd(
        attrs.data_ptr(), attrs.shape[1], tile_ids.data_ptr(), s, tile,
        tiles_x, cols.shape[1], out.data_ptr(), cols.data_ptr(),
        dout.data_ptr(), grads.data_ptr(),
        torch.cuda.current_stream(attrs.device).cuda_stream)
    _cuda_check(err, "K2 launch")
    bwd_launches += 1
    return grads


def window_run() -> int:
    """The tiles one K3 cluster replays: 1. The kernel takes any run up to
    `group`, but on the 836-tile grid runs of 2 and 6 measured slower than
    runs of 1 for every K3 design tried (PERF.md)."""
    return 1


def composite_sorted_bwd_window(attrs, seg_start, tile_ids, out, cols, dout,
                                tile: int, tiles_x: int, bands: int,
                                seg_cap: int, group: int):
    """K3 on CUDA tensors; on CPU tensors K2's twin, which is K3's plain
    version (the same sums). `seg_start` (T, bands) gives each tile's band
    windows; a cluster takes `window_run` consecutive entries of tile_ids
    (at most `group`), and `last_window_run` records the run it launched.
    Returns grads (16, Npad) f32 (lanes leave a cluster through global
    atomicAdd: the last bits vary from run to run)."""
    if attrs.device.type == "cpu":
        global window_twin_calls
        window_twin_calls += 1
        return _replay_grads(attrs, tile_ids, out, cols, dout, tile, tiles_x)
    if attrs.device.type != "cuda":
        raise RuntimeError(f"composite_sorted: no kernel for device "
                           f"{attrs.device}")
    global window_launches
    lib = load_kernels()
    for t, name, dt, dim in ((attrs, "attrs", torch.float32, 2),
                             (seg_start, "seg_start", torch.int32, 2),
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
    grads = torch.zeros_like(attrs)
    s = tile_ids.shape[0]
    if s == 0:
        return grads
    global last_window_run
    run = last_window_run = min(group, window_run())
    err = lib.eags_composite_sorted_bwd_window(
        attrs.data_ptr(), attrs.shape[1], seg_start.data_ptr(), bands,
        seg_cap, tile_ids.data_ptr(), s, run, tile, tiles_x, cols.shape[1],
        out.data_ptr(), cols.data_ptr(), dout.data_ptr(), grads.data_ptr(),
        torch.cuda.current_stream(attrs.device).cuda_stream)
    _cuda_check(err, "K3 launch")
    window_launches += 1
    return grads


def regions(tile: int) -> int:
    """Blocks a tile takes in K2's grid (K2, K4): the whole tile at 16,
    four quadrants at 32 and 64 (`region` in csrc/warp_patch.cuh)."""
    return 1 if tile <= 16 else 4


def pose_grad_sorted(attrs, jac, tile_ids, out, cols, dout, tile: int,
                     tiles_x: int):
    """K4 on CUDA tensors, the plain twin on CPU tensors. `attrs`, `out`,
    `cols` are K1's input and residuals, `dout` the (S, 8, PX) cotangent,
    `jac` (48, Npad) the pose jacobian. Returns dpose (7,) f32: each block
    (a tile's region, K2's grid) writes its 7 sums in a fixed order and the
    (S * regions, 8) partials are summed here, so the result does not
    change from run to run."""
    if attrs.device.type == "cpu":
        return pose_grad_sorted_plain(attrs, jac, tile_ids, out, cols, dout,
                                      tile, tiles_x)
    if attrs.device.type != "cuda":
        raise RuntimeError(f"pose_grad_sorted: no kernel for device "
                           f"{attrs.device}")
    global pose_launches
    lib = load_kernels()
    for t, name, dt, dim in ((attrs, "attrs", torch.float32, 2),
                             (jac, "jac", torch.float32, 2),
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
        dout.data_ptr(), part.data_ptr(),
        torch.cuda.current_stream(attrs.device).cuda_stream)
    _cuda_check(err, "K4 launch")
    pose_launches += 1
    return part.sum(0)[:7]


class CompositeSorted(torch.autograd.Function):
    """Differentiable w.r.t. attrs rows 0-9 (row 10, the radius, only
    gates coverage and gets no gradient, as in the JAX version). The
    backward is K2, or K3 with `rmw_window`."""

    @staticmethod
    def forward(ctx, attrs, seg_start, seg_cnt, tile_ids, tile, tiles_x,
                bands, seg_cap, group, rmw_window):
        attrs = attrs.contiguous()
        out, cols = composite_sorted_fwd(attrs, seg_start, seg_cnt,
                                         tile_ids, tile, tiles_x, bands,
                                         seg_cap)
        ctx.save_for_backward(attrs, seg_start, tile_ids, out, cols)
        ctx.geom = (tile, tiles_x, bands, seg_cap, group, rmw_window)
        return out

    @staticmethod
    def backward(ctx, dout):
        attrs, seg_start, tile_ids, out, cols = ctx.saved_tensors
        tile, tiles_x, bands, seg_cap, group, rmw_window = ctx.geom
        if rmw_window:
            grads = composite_sorted_bwd_window(
                attrs, seg_start, tile_ids, out, cols, dout.contiguous(),
                tile, tiles_x, bands, seg_cap, group)
        else:
            grads = composite_sorted_bwd(attrs, tile_ids, out, cols,
                                         dout.contiguous(), tile, tiles_x)
        return (grads,) + (None,) * 9


def composite_sorted(attrs_sorted, seg_start, seg_cnt, tile_ids, tile: int,
                     tiles_x: int, bands: int, seg_cap: int, group: int = 16,
                     rmw_window: bool = False):
    """attrs_sorted (16, Npad) centre-tile sorted; tile_ids (S,) selects the
    tiles. Returns (S, 8, PX) tile images (channels: see module doc). The
    backward is K3 with `rmw_window` (runs of `group` tiles), else K2."""
    return CompositeSorted.apply(attrs_sorted, seg_start.to(torch.int32)
                                 .contiguous(),
                                 seg_cnt.to(torch.int32).contiguous(),
                                 tile_ids.to(torch.int32).contiguous(),
                                 tile, tiles_x, bands, seg_cap, group,
                                 rmw_window)
