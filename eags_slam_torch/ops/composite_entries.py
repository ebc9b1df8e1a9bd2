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

The entries are gathered from the gaussian columns (`rasterizer.
_gather_entries`); `gather_entries_bwd` sums their grads back into the
columns, each column's entries in ascending entry order (a stable sort of
the gathered column ids), with a CUDA kernel beside K6 on the card and
plain PyTorch on the CPU: the same bits on every run, where an index_add_
would add with atomics in the blocks' order.

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernel (built from `csrc/` with the other kernels, at first use) or raises.
`counts()` holds the kernel launches (`entries_fwd_launches`,
`entries_bwd_launches`, `entries_gather_launches`) and twin calls
(`entries_fwd_twin_calls`, `entries_bwd_twin_calls`,
`entries_gather_twin_calls`); `layout_counts` splits the launches by the
layout the caller names (the render binning, or the tracker's frozen
binning). Both keep work tagged by `composite_sorted.counting_as` apart.
"""
from __future__ import annotations

import torch

from .composite_sorted import (MAIN, NCH, OUT_CH, LaunchCounts, _check,
                               _composite_cols, _cuda_check, _replay_grads,
                               load_kernels)

LAYOUTS = ("render", "frozen")
_counts = LaunchCounts(("entries_fwd_launches", "entries_bwd_launches",
                        "entries_gather_launches", "entries_fwd_twin_calls",
                        "entries_bwd_twin_calls", "entries_gather_twin_calls"))
# Launches by layout, keys "K5.render", "K6.frozen", ...
_layouts = LaunchCounts(f"{k}.{lay}" for k in ("K5", "K6")
                        for lay in LAYOUTS)


def reset_counts() -> None:
    _counts.reset()
    _layouts.reset()


def counts(tag: str = MAIN) -> dict:
    """Kernel launches and twin calls counted under `tag`."""
    return _counts.get(tag)


def layout_counts(tag: str = MAIN) -> dict:
    """Kernel launches by layout: {"K5": {layout: n}, "K6": {layout: n}}."""
    c = _layouts.get(tag)
    return {kid: {lay: c[f"{kid}.{lay}"] for lay in LAYOUTS}
            for kid in ("K5", "K6")}


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
    _counts.bump("entries_fwd_twin_calls", entries.device)
    cols, tile_ids = _segments(start, count)
    return _composite_cols(entries, cols, count.long(), tile_ids, tile,
                           tiles_x)


@torch.no_grad()
def composite_entries_bwd_plain(entries, start, count, out, dout, tile: int,
                                tiles_x: int):
    """Plain PyTorch twin of K6: the reverse replay of the chunks K5 used.
    Returns grads (16, Epad), zero in the columns K5 did not composite."""
    _counts.bump("entries_bwd_twin_calls", entries.device)
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
    _counts.bump("entries_fwd_launches", entries.device)
    _layouts.bump(f"K5.{layout}", entries.device)
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
    _counts.bump("entries_bwd_launches", entries.device)
    _layouts.bump(f"K6.{layout}", entries.device)
    return grads


def _gather_segments(slot_gid, n_cols: int):
    """Each column's entries in ascending entry order: (order (E,) i64, the
    entries stably sorted by column; bounds (n_cols + 1,) i64, column n's
    entries order[bounds[n]:bounds[n + 1]])."""
    sg, order = torch.sort(slot_gid, stable=True)
    bounds = torch.searchsorted(
        sg, torch.arange(n_cols + 1, device=slot_gid.device))
    return order, bounds


@torch.no_grad()
def gather_entries_bwd_plain(g, slot_gid, n_cols: int):
    """Plain PyTorch version of the gather's backward: (C, n_cols), column
    n < n_cols - 1 the sum of g's entries gathered from it, added in
    ascending entry order; the last column (the sentinel the empty slots
    gather, which the caller drops) zero. One pass a position in the
    columns' entry lists, each adding one entry to distinct columns."""
    _counts.bump("entries_gather_twin_calls", g.device)
    order, bounds = _gather_segments(slot_gid, n_cols)
    start = bounds[:-1]
    cnt = bounds[1:] - start
    cnt[-1] = 0
    d = g.new_zeros((g.shape[0], n_cols))
    cols = torch.arange(n_cols, device=g.device)
    for pos in range(int(cnt.max()) if n_cols else 0):
        has = cnt > pos
        c = cols[has]
        d[:, c] = d[:, c] + g[:, order[start[has] + pos]]
    return d


def gather_entries_bwd(g, slot_gid, n_cols: int):
    """The entry gather's backward, `gather_entries_bwd_plain`'s function:
    the kernel beside K6 on CUDA tensors, the plain version on CPU tensors.
    g (16, E) float32, slot_gid (E,) int64 in [0, n_cols). Returns (16,
    n_cols) float32."""
    if g.device.type == "cpu":
        return gather_entries_bwd_plain(g, slot_gid, n_cols)
    if g.device.type != "cuda":
        raise RuntimeError(f"gather_entries_bwd: no kernel for device "
                           f"{g.device}")
    lib = load_kernels()
    g = g.contiguous()
    _check(g, "g", torch.float32, 2)
    _check(slot_gid, "slot_gid", torch.int64, 1)
    if g.shape[0] != NCH or slot_gid.shape[0] != g.shape[1]:
        raise ValueError("g must be (16, E) and slot_gid (E,)")
    order, bounds = _gather_segments(slot_gid, n_cols)
    d = torch.empty((NCH, n_cols), dtype=torch.float32, device=g.device)
    err = lib.eags_gather_entries_bwd(
        g.data_ptr(), g.shape[1], order.data_ptr(), bounds.data_ptr(),
        n_cols - 1, n_cols, d.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream)
    _cuda_check(err, "gather backward launch")
    _counts.bump("entries_gather_launches", g.device)
    return d


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
