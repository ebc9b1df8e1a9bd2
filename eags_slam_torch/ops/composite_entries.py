"""Entry-binned compositing (the `pallas` backend): the K5 (forward) and K6
(backward) kernels, their plain PyTorch twins, and the autograd.Function
that joins them.

Replaces `eags_slam_tpu.ops.rasterizer_pallas.composite_entries`
(`_fwd_kernel`, `_bwd_kernel`, and the zeroing of unvisited columns in
`_composite_bwd`).

Semantics (identical in kernel and twin):
  - entries (16, Epad) f32, rows 0 u, 1 v, 2-4 conic a/b/c, 5 opacity,
    6-8 rgb, 9 depth, 10-15 ignored; tile t owns the columns
    [start[t], start[t] + count[t]), depth-sorted front to back, with
    start[t] a multiple of 128 (start, count (T,) i32).
  - Front-to-back compositing in chunks of 128 entries, `_chunk_alpha`'s
    rules: alpha = opacity * exp(power) where power <= 0 and the slot is
    < count, clipped at 0.99, zero below 1/255; log-space transmittance.
    Before each chunk the tile stops if no pixel has log T > -11.5.
  - out (T, 8, PX): 0-2 rgb, 3 depth, 4 alpha = 1 - T, 5 log T, 6 chunks
    used, 7 count. The TPU kernel's (T_pad, 16, PX) block is this array's
    channels 0-6 for its first T rows.
  - The backward replays the chunks the forward used, in reverse, with
    d_alpha = T q - (b + suffix) / max(1 - alpha, 1e-6), and returns grads
    (16, Epad) that are zero in every column K5 did not composite
    (early-stopped chunks, alignment gaps, the padded tail). Every entry
    column belongs to one tile, so K6 writes each column once: no atomics,
    the same result from run to run. K5 and K6 skip the pairs outside
    each entry's alpha box (`composite_sorted.alpha_box`), where alpha is
    zero.

The twins are the sorted backend's chunk loop and replay
(`composite_sorted._composite_cols`, `_replay_grads`) on each tile's
contiguous column range.

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernel (built from `csrc/` with the other kernels, at first use) or raises.
`entries_fwd_launches` / `entries_bwd_launches` count kernel launches,
`entries_fwd_twin_calls` / `entries_bwd_twin_calls` twin calls;
`layout_counts` splits the launches by the layout the caller names (the
render binning, or the tracker's frozen binning).
"""
from __future__ import annotations

import torch

from .composite_sorted import (NCH, OUT_CH, _check, _composite_cols,
                               _cuda_check, _replay_grads, load_kernels)

entries_fwd_launches = 0
entries_bwd_launches = 0
entries_fwd_twin_calls = 0
entries_bwd_twin_calls = 0
LAYOUTS = ("render", "frozen")
# Launches by layout: {layout: [K5, K6]}.
layout_launches = {k: [0, 0] for k in LAYOUTS}


def reset_counts() -> None:
    global entries_fwd_launches, entries_bwd_launches
    global entries_fwd_twin_calls, entries_bwd_twin_calls
    entries_fwd_launches = entries_bwd_launches = 0
    entries_fwd_twin_calls = entries_bwd_twin_calls = 0
    for v in layout_launches.values():
        v[:] = [0, 0]


def layout_counts() -> dict:
    """Kernel launches by layout: {"K5": {layout: n}, "K6": {layout: n}}."""
    return {kid: {k: v[i] for k, v in layout_launches.items()}
            for i, kid in enumerate(("K5", "K6"))}


def counts() -> dict:
    return {"entries_fwd_launches": entries_fwd_launches,
            "entries_bwd_launches": entries_bwd_launches,
            "entries_fwd_twin_calls": entries_fwd_twin_calls,
            "entries_bwd_twin_calls": entries_bwd_twin_calls}


def _segments(start, count):
    """Each tile's entry columns (T, max count) and the tile ids."""
    n = int(count.max()) if count.numel() else 0
    lane = torch.arange(n, device=start.device)
    cols = torch.where(lane[None, :] < count[:, None].long(),
                       start[:, None].long() + lane[None, :],
                       torch.zeros((), dtype=torch.long, device=start.device))
    tile_ids = torch.arange(start.shape[0], dtype=torch.int32,
                            device=start.device)
    return cols, tile_ids


@torch.no_grad()
def composite_entries_fwd_plain(entries, start, count, tile: int,
                                tiles_x: int):
    """Plain PyTorch twin of K5. Returns out (T, 8, PX)."""
    global entries_fwd_twin_calls
    entries_fwd_twin_calls += 1
    cols, tile_ids = _segments(start, count)
    return _composite_cols(entries, cols, count.long(), tile_ids, tile,
                           tiles_x)


@torch.no_grad()
def composite_entries_bwd_plain(entries, start, count, out, dout, tile: int,
                                tiles_x: int):
    """Plain PyTorch twin of K6: the reverse replay of the chunks K5 used.
    Returns grads (16, Epad), zero in the columns K5 did not composite."""
    global entries_bwd_twin_calls
    entries_bwd_twin_calls += 1
    cols, tile_ids = _segments(start, count)
    return _replay_grads(entries, tile_ids, out, cols, dout, tile, tiles_x)


def _check_args(entries, start, count, layout):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    _check(entries, "entries", torch.float32, 2)
    _check(start, "start", torch.int32, 1)
    _check(count, "count", torch.int32, 1)
    if entries.shape[0] != NCH or start.shape != count.shape:
        raise ValueError("entries must be (16, Epad), start / count (T,)")


def composite_entries_fwd(entries, start, count, tile: int, tiles_x: int,
                          layout: str = "render"):
    """K5 on CUDA tensors, the plain twin on CPU tensors. Returns out
    (T, 8, PX) f32. `layout` (render or frozen) only tags the launch
    count."""
    if entries.device.type == "cpu":
        return composite_entries_fwd_plain(entries, start, count, tile,
                                           tiles_x)
    if entries.device.type != "cuda":
        raise RuntimeError(f"composite_entries: no kernel for device "
                           f"{entries.device}")
    global entries_fwd_launches
    lib = load_kernels()
    _check_args(entries, start, count, layout)
    if tile not in (16, 32, 64):
        raise ValueError(f"K5 takes tile in (16, 32, 64); got {tile}")
    t = start.shape[0]
    out = torch.empty((t, OUT_CH, tile * tile), dtype=torch.float32,
                      device=entries.device)
    if t == 0:
        return out
    err = lib.eags_composite_entries_fwd(
        entries.data_ptr(), entries.shape[1], start.data_ptr(),
        count.data_ptr(), t, tile, tiles_x, out.data_ptr(),
        torch.cuda.current_stream(entries.device).cuda_stream)
    _cuda_check(err, "K5 launch")
    entries_fwd_launches += 1
    layout_launches[layout][0] += 1
    return out


def composite_entries_bwd(entries, start, count, out, dout, tile: int,
                          tiles_x: int, layout: str = "render"):
    """K6 on CUDA tensors, the plain twin on CPU tensors. Returns grads
    (16, Epad) f32, zero in the columns K5 did not composite. `layout` only
    tags the launch count."""
    if entries.device.type == "cpu":
        return composite_entries_bwd_plain(entries, start, count, out, dout,
                                           tile, tiles_x)
    if entries.device.type != "cuda":
        raise RuntimeError(f"composite_entries: no kernel for device "
                           f"{entries.device}")
    global entries_bwd_launches
    lib = load_kernels()
    _check_args(entries, start, count, layout)
    _check(out, "out", torch.float32, 3)
    _check(dout, "dout", torch.float32, 3)
    t = start.shape[0]
    grads = torch.zeros_like(entries)
    if t == 0:
        return grads
    err = lib.eags_composite_entries_bwd(
        entries.data_ptr(), entries.shape[1], start.data_ptr(), t, tile,
        tiles_x, out.data_ptr(), dout.data_ptr(), grads.data_ptr(),
        torch.cuda.current_stream(entries.device).cuda_stream)
    _cuda_check(err, "K6 launch")
    entries_bwd_launches += 1
    layout_launches[layout][1] += 1
    return grads


class CompositeEntries(torch.autograd.Function):
    """Differentiable w.r.t. entries rows 0-9."""

    @staticmethod
    def forward(ctx, entries, start, count, tile, tiles_x, layout):
        entries = entries.contiguous()
        out = composite_entries_fwd(entries, start, count, tile, tiles_x,
                                    layout)
        ctx.save_for_backward(entries, start, count, out)
        ctx.geom = (tile, tiles_x, layout)
        return out

    @staticmethod
    def backward(ctx, dout):
        entries, start, count, out = ctx.saved_tensors
        tile, tiles_x, layout = ctx.geom
        grads = composite_entries_bwd(entries, start, count, out,
                                      dout.contiguous(), tile, tiles_x,
                                      layout)
        return grads, None, None, None, None, None


def composite_entries(entries, start, count, tile: int, tiles_x: int,
                      layout: str = "render"):
    """entries (16, Epad) with 128-aligned, depth-sorted tile segments
    [start, start + count). Returns (T, 8, PX) tile images (channels: see
    module doc). `layout` names the binning for the launch counts: the
    render's, or the tracker's frozen one."""
    return CompositeEntries.apply(entries, start.to(torch.int32).contiguous(),
                                  count.to(torch.int32).contiguous(), tile,
                                  tiles_x, layout)
