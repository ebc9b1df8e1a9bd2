"""The traced run's instruments: the program's compositing launches and the
profiler's device timeline over a fixed run of frames.

  - `Launches` wraps the entry points of K1, K2 and K4
    (`ops/composite_sorted.py`, and the names `ops/rasterizer.py` took of
    them) while recording: each main-path K1 launch keeps references to
    its inputs (no copy, no device work), and each K2 / K4 launch the K1
    launch whose output it takes, so that `yardstick.work` counts their
    operations from K1's inputs at the next frame boundary (`count`). The
    loop closer's launches (on its own stream, under its own count tag)
    are not kept.
  - `Profile` runs `torch.profiler` (CUDA activity) over the
    profiled frames and reduces its events to the device's busy time (the
    union of every device operation's interval), the kernels by name, the
    idle gaps attributed to the benchmark's host span that covers them,
    and the device time of the K1 / K2 / K4 kernels on the main stream.
    The intervals in `pauses` (the counting at frame boundaries, the
    device idle before and after it) are cut out of the window.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

from . import yardstick

# Device kernel names of the compositing kernels (csrc/): K2's call also
# launches the slot-table reduction and the repeated-tile fold.
KERNEL_NAMES = {"K1": ("fwd_kernel<",), "K2": ("bwd_kernel<",
                                               "table_reduce_kernel<",
                                               "fold_repeats_kernel<"),
                "K4": ("pose_kernel<",)}
EXCLUDE = ("entries_", "bwd_window_kernel")


def kernel_of(name: str):
    if any(x in name for x in EXCLUDE):
        return None
    for kid, keys in KERNEL_NAMES.items():
        if any(name.startswith(k) or (" " + k) in name or ("::" + k) in name
               for k in keys):
            return kid
    return None


class Launches:
    def __init__(self):
        self.on = False
        self.k1 = []            # dicts of K1's inputs and bytes
        self.k2 = []            # (index into k1, bytes)
        self.k4 = []
        self._by_out = {}       # data_ptr of a K1 output -> index into k1
        self._undo = []

    def install(self):
        from eags_slam_torch.ops import composite_sorted as cs
        from eags_slam_torch.ops import rasterizer as rz

        fwd, bwd, pose = (cs.composite_sorted_fwd, cs.composite_sorted_bwd,
                          cs.pose_grad_sorted)

        def main_path(attrs):
            return self.on and cs.count_tag(attrs.device) == cs.MAIN

        def k1(attrs, seg_start, seg_cnt, tile_ids, tile, tiles_x, bands,
               seg_cap, quadform=False):
            out, cols = fwd(attrs, seg_start, seg_cnt, tile_ids, tile,
                            tiles_x, bands, seg_cap, quadform)
            if main_path(attrs) and tile_ids.shape[0]:
                # An output's address is its K1's while the output lives,
                # and a K2 / K4 launch that takes it finds that K1.
                self._by_out[out.data_ptr()] = len(self.k1)
                self.k1.append({
                    "inputs": (attrs, seg_start, seg_cnt, tile_ids),
                    "shape": (tile, tiles_x, bands, seg_cap),
                    "plain": attrs.dtype == torch.float32 and not quadform,
                    "bytes": yardstick.nbytes(attrs, seg_start, seg_cnt,
                                              tile_ids, out, cols)})
            return out, cols

        def k2(attrs, tile_ids, out, cols, dout, tile, tiles_x, bands,
               quadform=False):
            grads = bwd(attrs, tile_ids, out, cols, dout, tile, tiles_x,
                        bands, quadform)
            if main_path(attrs) and tile_ids.shape[0]:
                self.k2.append((self._by_out.get(out.data_ptr()),
                                yardstick.nbytes(attrs, tile_ids, out, cols,
                                                 dout, grads)))
            return grads

        def k4(attrs, jac, tile_ids, out, cols, dout, tile, tiles_x,
               quadform=False):
            dpose = pose(attrs, jac, tile_ids, out, cols, dout, tile,
                         tiles_x, quadform)
            if main_path(attrs) and tile_ids.shape[0]:
                self.k4.append((self._by_out.get(out.data_ptr()), 0))
            return dpose

        for mod, name, new in ((cs, "composite_sorted_fwd", k1),
                               (cs, "composite_sorted_bwd", k2),
                               (cs, "pose_grad_sorted", k4),
                               (rz, "composite_sorted_fwd", k1),
                               (rz, "pose_grad_sorted", k4)):
            self._undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, new)

    def uninstall(self):
        for mod, name, old in reversed(self._undo):
            setattr(mod, name, old)
        self._undo = []

    def count(self) -> dict:
        """Operations and least times of the kept launches, by kernel, and
        the launches let go: {kid: {"launches", "ops", "bound_s"}}; {} when
        a launch is of a variant the frozen count does not cover (bf16,
        quadform) or a K2 / K4 launch has no K1 launch kept."""
        k1, k2, k4 = self.k1, self.k2, self.k4
        self.clear()
        if not all(r["plain"] for r in k1):
            return {}
        res = {k: {"launches": 0, "ops": 0, "bound_s": 0.0}
               for k in ("K1", "K2", "K4")}
        works = []
        for r in k1:
            w = yardstick.work(*r["inputs"], *r["shape"])
            works.append(w)
            n = yardstick.ops("K1", w)
            res["K1"]["launches"] += 1
            res["K1"]["ops"] += n
            res["K1"]["bound_s"] += yardstick.bound_s(r["bytes"], n)
        for kid, recs in (("K2", k2), ("K4", k4)):
            for i, nb in recs:
                if i is None:
                    return {}
                n = yardstick.ops(kid, works[i])
                res[kid]["launches"] += 1
                res[kid]["ops"] += n
                res[kid]["bound_s"] += yardstick.bound_s(nb, n)
        return res

    def clear(self):
        self.k1, self.k2, self.k4, self._by_out = [], [], [], {}


def add_counts(total, part):
    """The sum of two `Launches.count` results ({} stays {})."""
    if total is None:
        return part
    if not total or not part:
        return {}
    return {k: {f: total[k][f] + part[k][f] for f in total[k]}
            for k in total}


class Profile:
    def __init__(self):
        self.prof = None
        self.t0_ns = self.t1_ns = None
        self.pauses = []        # (t0_ns, t1_ns) cut out of the window

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        # The device's activity only: recording every host op as well
        # slows the host-bound loop several times over.
        acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                else [ProfilerActivity.CPU])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0_ns = time.time_ns()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.__exit__(None, None, None)

    def kept(self):
        """The profiled window without its pauses: [(t0_ns, t1_ns)]."""
        out, a = [], self.t0_ns
        for p0, p1 in sorted(self.pauses):
            if p0 > a:
                out.append((a, min(p0, self.t1_ns)))
            a = max(a, p1)
        if a < self.t1_ns:
            out.append((a, self.t1_ns))
        return out

    def reduce(self, spans) -> dict:
        """Busy and window seconds, kernel events by name, the compositing
        kernels' main-stream device seconds, idle seconds by host span,
        each over the window without its pauses. `spans`: (name, t0_ns,
        t1_ns) of the benchmark's host spans."""
        evs = self.prof.profiler.kineto_results.events()
        dev = []
        for e in evs:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name(), e.device_resource_id()))
        dev.sort()
        kept = self.kept()
        busy, gaps = 0, []
        inside = defaultdict(int)     # event index -> ns inside the window
        for t0, t1 in kept:
            cur_s = cur_e = None
            for i, (s, e, *_) in enumerate(dev):
                if e <= t0 or s >= t1:
                    continue
                s, e = max(s, t0), min(e, t1)
                inside[i] += e - s
                if cur_e is None or s > cur_e:
                    if cur_e is not None:
                        busy += cur_e - cur_s
                        gaps.append((cur_e, s))
                    else:
                        gaps.append((t0, s))
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, t1))
            else:
                gaps.append((t0, t1))
        by_name = defaultdict(float)
        kernels = 0
        streams = defaultdict(lambda: defaultdict(float))
        stream_k1 = defaultdict(int)
        for i, ns in inside.items():
            _, _, name, stream = dev[i]
            by_name[name] += ns / 1e9
            if not name.startswith(("Memcpy", "Memset")):
                kernels += 1
            kid = kernel_of(name)
            if kid is not None:
                streams[stream][kid] += ns / 1e9
                if kid == "K1":
                    stream_k1[stream] += 1
        # The host spans do not nest: the one that starts last before a
        # gap's middle and has not ended covers it.
        spans = sorted(spans, key=lambda sp: sp[1])
        starts = [sp[1] for sp in spans]
        idle = defaultdict(float)
        for a, b in gaps:
            if b <= a:
                continue
            i = bisect.bisect_right(starts, 0.5 * (a + b)) - 1
            name = (spans[i][0] if i >= 0 and spans[i][2] >= 0.5 * (a + b)
                    else "loop")
            idle[name] += (b - a) / 1e9
        return {"busy_s": busy / 1e9,
                "window_s": sum(b - a for a, b in kept) / 1e9,
                "paused_s": (self.t1_ns - self.t0_ns
                             - sum(b - a for a, b in kept)) / 1e9,
                "kernels": kernels,
                "by_name": dict(by_name), "idle_by_span": dict(idle),
                "kernel_s_by_stream": {k: dict(v) for k, v in streams.items()},
                "k1_by_stream": dict(stream_k1)}
