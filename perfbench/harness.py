"""One run of a cell: set-up, the measured window, the readings, the check.

Set-up loads the program's kernels, writes the cell's frames from the seed
(`traffic.generate`) under `$TMPDIR`, builds the configuration's reader
(`eags_slam_torch.datasets.get_dataset`) inside `Stream`, the benchmark's
thin wrapper, and `GaussianSLAM` over it, and runs the warm frames 0-3
(the initial map, a mapping frame, a tracked frame with the odometer's
candidate) inside `GaussianSLAM.run`. The window opens when the loop asks
for frame 4; once `seconds` have passed, `Stream.frame` raises `Closed`
at the next frame boundary and the run stops there, its map, poses and
optimiser state left on the object for the check.

Spans (host clock, `time.perf_counter`, around calls of the built objects'
instance methods, each synchronous or ending in the loop's own sync): the
reader's `frame` (data_wait), `odometer.step` (vo), `tracker.track`
(track), `map_frame` (map), and `save_current_submap` to
`start_new_submap` (boundary). With `trace`, `torch.profiler` covers
`PROFILE_FRAMES` window frames from the window's `PROFILE_AFTER`-th (the
window stays open until they are done). The compositing launches of each
profiled frame are kept (`trace.Launches`) and counted at the frame's end,
the device idle, in a pause that the profile's reduction cuts out; the
`STASH_WARM` frames before them keep their launches too and let them go
uncounted, so that the allocator holds the blocks a frame's launches
take before the profile starts. These instrumented frames are left out of
the spans, and the traced run's memory peak is the peak outside them.
"""
from __future__ import annotations

import copy
import gc
import os
import random
import shutil
import tempfile
import time

import numpy as np
import torch

from . import check, layouts, reference, trace, traffic

WARM_FRAMES = 4
PROFILE_AFTER = 8
PROFILE_FRAMES = 4
STASH_WARM = 2
KEEP_FRAMES = 3


class Closed(Exception):
    """The window's time is up: raised from the reader at a frame
    boundary."""


def boot_s() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start_s() -> float:
    """This process's start, on CLOCK_BOOTTIME (from /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


class Stream:
    """The configuration's reader, delegated to, with the window's clock in
    `frame`: the request time of every frame, the data wait, a seeded
    sample of the frames the window's loop received, the profiler's start
    and stop, and `Closed` once the window's time is up."""

    def __init__(self, reader, run):
        self._reader = reader
        self._run = run

    def __getattr__(self, name):
        return getattr(self._reader, name)

    def __len__(self):
        return len(self._reader)

    def __getitem__(self, idx):
        return self._reader[idx]

    def frame(self, idx: int):
        return self._run.on_frame(idx, self._reader.frame)


class Run:
    """The state of one run: clocks, spans, samples, the tracer."""

    def __init__(self, seconds: float, seed: int, trace_on: bool, n: int,
                 device):
        self.seconds = seconds
        self.n = n
        self.device = device
        self.rng = random.Random(seed)
        self.t_request = {}
        self.t_window = self.t_end = None
        self.first = WARM_FRAMES
        self.current = -1
        self.completed = 0
        self.ended_by = None
        self.spans = []            # (name, frame, t0, t1) perf_counter
        self.spans_ns = []         # (name, t0_ns, t1_ns) for the trace
        self.pose_ms = {}
        self.kept = {}
        self.seen = 0
        self.trace_on = trace_on
        self.launches = trace.Launches() if trace_on else None
        self.profile = trace.Profile() if trace_on else None
        self.profiled = []
        self.instrumented = set()
        self.profile_wall = None
        self.counted = None
        self.peak_outside = None   # the peak before the instrumented frames
        self.peak_inside = None    # the peak up to their end, stash and all
        self._boundary_t0 = None

    # -- the window's clock -------------------------------------------------
    def on_frame(self, idx: int, read):
        if idx == self.first:
            # Set-up's garbage collected and its objects left out of the
            # window's collections, so that no pause of set-up lands there.
            gc.collect()
            gc.freeze()
            self.t_window = time.perf_counter()
            self.t_window_boot = boot_s()
        now = time.perf_counter()
        self.current = idx
        if self.t_window is not None and idx > self.first:
            self.completed = idx - self.first
            if now - self.t_window >= self.seconds and not self._profiling():
                self.t_end = now
                self.ended_by = "time"
                self._stop_profile(idx)
                raise Closed()
        if self.trace_on:
            self._profile_boundary(idx)
            now = time.perf_counter()
        self.t_request[idx] = now
        t0 = time.perf_counter()
        t0_ns = time.time_ns()
        color, depth = read(idx)
        t1 = time.perf_counter()
        self._span("data_wait", idx, t0, t1, t0_ns)
        if self.t_window is not None and idx not in self.profiled:
            # Reservoir sample of the window's frames, drawn from the seed.
            self.seen += 1
            if len(self.kept) < KEEP_FRAMES:
                self.kept[idx] = (color.clone(), depth.clone())
            else:
                j = self.rng.randrange(self.seen)
                if j < KEEP_FRAMES:
                    del self.kept[sorted(self.kept)[j]]
                    self.kept[idx] = (color.clone(), depth.clone())
        return color, depth

    def end_of_sequence(self):
        """The loop finished the last frame before the window's time."""
        if self.t_end is None and self.t_window is not None:
            self.t_end = time.perf_counter()
            self.completed = self.n - self.first
            self.ended_by = "sequence"
            self._stop_profile(self.n)

    # -- profiling ---------------------------------------------------------
    def _profiling(self) -> bool:
        """The profiled frames have started and not yet ended: the traced
        run's window stays open until they have."""
        return (self.trace_on and self.profile_wall is not None
                and self.profile_wall[1] is None)

    def _profile_boundary(self, idx: int):
        p0 = self.first + PROFILE_AFTER
        cuda = self.device.type == "cuda"
        if idx == p0 - STASH_WARM:
            if cuda:
                torch.cuda.synchronize()
                self.peak_outside = torch.cuda.max_memory_allocated(
                    self.device)
            self.launches.on = True
        if p0 - STASH_WARM <= idx < p0 + PROFILE_FRAMES:
            self.instrumented.add(idx)
        if idx == p0:
            # The warm frames' launches go uncounted: their blocks stay
            # with the allocator for the profiled frames' launches.
            if cuda:
                torch.cuda.synchronize()
            self.launches.clear()
            self.profile.start()
            self.profile_wall = [time.perf_counter(), None]
        elif p0 < idx < p0 + PROFILE_FRAMES and self._profiling():
            self._count(pause=True)
        if p0 <= idx < p0 + PROFILE_FRAMES:
            self.profiled.append(idx)
        if idx == p0 + PROFILE_FRAMES:
            self._stop_profile(idx)

    def _count(self, pause: bool):
        """Count the launches kept since the last count, and let them go;
        with `pause`, inside the profile, the count and the device idle
        around it are cut out of the profile's window."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t0_ns = time.time_ns()
        self.counted = trace.add_counts(self.counted, self.launches.count())
        if cuda:
            torch.cuda.synchronize()
        if pause:
            self.profile.pauses.append((t0_ns, time.time_ns()))

    def _stop_profile(self, idx: int):
        if not self.trace_on or self.profile_wall is None \
                or self.profile_wall[1] is not None:
            return
        self.profile.stop()
        self.profile_wall[1] = time.perf_counter()
        self.launches.on = False
        self._count(pause=False)
        if self.device.type == "cuda":
            self.peak_inside = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.profiled = [f for f in self.profiled if f < idx]

    # -- spans -------------------------------------------------------------
    def _span(self, name, idx, t0, t1, t0_ns):
        self.spans.append((name, idx, t0, t1))
        if self.trace_on:
            self.spans_ns.append((name, t0_ns,
                                  t0_ns + int(1e9 * (t1 - t0))))

    def wrap(self, name, fn, after=None):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            t0_ns = time.time_ns()
            out = fn(*args, **kw)
            t1 = time.perf_counter()
            self._span(name, self.current, t0, t1, t0_ns)
            if after is not None:
                after(t1)
            return out
        return timed

    def on_tracked(self, t1: float):
        idx = self.current
        if idx in self.t_request:
            self.pose_ms[idx] = 1e3 * (t1 - self.t_request[idx])

    def install(self, slam):
        slam.tracker.track = self.wrap("track", slam.tracker.track,
                                       self.on_tracked)
        if slam.odometer is not None:
            slam.odometer.step = self.wrap("vo", slam.odometer.step)
        slam.map_frame = self.wrap("map", slam.map_frame)
        save, start = slam.save_current_submap, slam.start_new_submap

        def save_submap():
            if self.spans[-1][:2] == ("map", self.n - 1):
                # After the last frame's mapping, the loop is over: the
                # window ends with the sequence.
                self.end_of_sequence()
                raise Closed()
            self._boundary_t0 = (time.perf_counter(), time.time_ns())
            return save()

        def start_submap(frame_id):
            out = start(frame_id)
            if self._boundary_t0 is not None:
                t0, t0_ns = self._boundary_t0
                self._span("boundary", self.current, t0, time.perf_counter(),
                           t0_ns)
                self._boundary_t0 = None
            return out

        slam.save_current_submap = save_submap
        slam.start_new_submap = start_submap
        if self.trace_on:
            self.launches.install()

    # -- readings ------------------------------------------------------------
    def window_spans(self, name):
        """Durations (ms) of span `name` in the window's completed frames,
        the instrumented frames left out."""
        last = self.first + self.completed
        return [1e3 * (t1 - t0) for n, f, t0, t1 in self.spans
                if n == name and self.first <= f < last
                and f not in self.instrumented]


def run_cell(cell: dict, config_file: dict, traffic_mix: dict, seed: int,
             seconds: float, trace_on: bool, device="cuda",
             overrides=None, control: bool = False, log=print) -> dict:
    """Run one cell; returns the readings, the numbers compared and what the
    earlier lines print. `overrides`: (section, key, value) changes of the
    configuration (the CPU tests' small sizes). `control`: the program's
    bf16 kernels and the reference's frames rounded to bfloat16 in the
    program's place."""
    from eags_slam_torch.datasets import get_dataset
    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.ops.rasterizer import render
    from eags_slam_torch.slam.gaussian_slam import GaussianSLAM

    device = torch.device(device)
    work = os.path.join(tempfile.gettempdir(), "perfbench", cell["name"])
    data_dir = os.path.join(work, "frames")
    if device.type == "cuda":
        cs.load_kernels()
    stream = copy.deepcopy(config_file["stream"])
    config = copy.deepcopy(config_file["config"])
    for section, key, value in overrides or ():
        config[section][key] = value
        if section == "cam" and key in stream["cam"]:
            stream["cam"][key] = value
    if control:
        config["mapping"]["kernel_bf16"] = True
    gen = traffic.generate(stream, traffic_mix, seed, data_dir, device)
    log({"phase": "data", "frames": gen["n"], "seconds": gen["seconds"],
         "bytes": gen["bytes"], "layout": stream["layout"]["kind"]})
    config["device"] = device.type
    config["seed"] = int(seed)
    config["data"]["input_path"] = data_dir
    config["data"]["output_path"] = os.path.join(work, "out")
    run = Run(seconds, seed, trace_on, gen["n"], device)
    reader = get_dataset(config["data"]["dataset_name"])(config,
                                                         device=device)
    slam = GaussianSLAM(config, dataset=Stream(reader, run))
    run.install(slam)
    try:
        slam.run()
    except Closed:
        pass
    if run.t_end is None:
        raise RuntimeError("the run ended before its window opened")
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        if run.peak_outside is not None:
            # The traced run: the peak before and after the instrumented
            # frames, whose kept launches hold memory the program does not.
            peak = max(peak, run.peak_outside)
    else:
        peak = 0
    res = {"run": run, "peak_bytes": peak, "frames": run.completed,
           "peak_instrumented_bytes": run.peak_inside,
           "window_s": run.t_end - run.t_window,
           "ended_by": run.ended_by, "gen": gen}
    last = run.first + run.completed - 1
    res["last_frame"] = last
    res["data_report"] = reader.report()

    # The program's render and gradient on the map and pose the window
    # reached (K1 / K2 on the card), and what the reference needs.
    if trace_on:
        run.launches.uninstall()
    p = slam.state.params
    params = {"xyz": p.xyz, "quats": p.quats, "log_scales": p.log_scales,
              "opacity_logits": p.opacity_logits, "f_dc": p.f_dc}
    params = {k: v.detach().clone() for k, v in params.items()}
    alive = slam.state.alive.clone()
    est = np.array(slam.estimated_c2ws[: last + 1])
    # The pose of the last mapped frame: the map was last optimised on it.
    kf = max(f for n, f, _, _ in run.spans if n == "map" and f <= last)
    res["keyframe"] = kf
    w2c = torch.as_tensor(np.linalg.inv(est[kf]), dtype=torch.float32,
                          device=device)
    cam = slam.cam
    cam_d = {"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy,
             "W": cam.width, "H": cam.height}
    rc = slam.rcfg
    rast = {"tile": rc.tile, "bands": rc.bands, "seg_cap": rc.seg_cap,
            "near": rc.near, "low_pass": rc.low_pass,
            "sigma_clip": rc.sigma_clip, "alpha_min": rc.alpha_min}
    cot = check.cotangent(cam.height, cam.width, seed, device)
    leaf = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = render(leaf["xyz"], leaf["quats"], leaf["log_scales"],
                 leaf["opacity_logits"], leaf["f_dc"] * reference.SH_C0 + 0.5,
                 w2c, cam, rc, alive=alive)
    loss = (torch.cat([out.color, out.depth[..., None], out.alpha[..., None]],
                      -1) * cot).sum()
    loss.backward()
    prog = {"color": out.color.detach(), "depth": out.depth.detach(),
            "alpha": out.alpha.detach(),
            "grads": {k: v.grad.detach() for k, v in leaf.items()}}
    del out, loss, leaf
    slam.cleanup()
    if trace_on:
        res["profile"] = (run.profile.reduce(run.spans_ns)
                          if run.profile_wall and run.profile_wall[1]
                          else None)
        run.launches.clear()
    res["counted"] = run.counted
    del slam, reader
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # The check, after the window, the peak and the program's state.
    t_check = time.perf_counter()
    rcam = {**stream["cam"], "depth_scale": config["cam"]["depth_scale"],
            "crop_edge": int(config["cam"].get("crop_edge", 0))}
    read = layouts.entry(stream["layout"]).read_reference
    kept = run.kept
    if control:
        kept = {}
        for i in run.kept:
            c, d = read(*gen["paths"][i], rcam)
            kept[i] = (torch.as_tensor(c, device=device).bfloat16().float(),
                       torch.as_tensor(d, device=device).bfloat16().float())
    numbers = check.frames(kept, gen["paths"], rcam, read, device)
    ref = reference.render(params, w2c, cam_d, rast, alive=alive,
                           cotangent=cot)
    numbers.update(check.render_numbers(prog, ref))
    numbers["ate_cm"] = check.ate_cm(est, gen["poses"][: last + 1])
    res["numbers"] = numbers
    res["check_s"] = time.perf_counter() - t_check
    res["kept_frames"] = sorted(run.kept)
    shutil.rmtree(work, ignore_errors=True)
    return res


def summarize(res: dict) -> dict:
    """Span means and the e2e readings the metric readers take."""
    run = res["run"]
    pose = [v for f, v in run.pose_ms.items()
            if run.first <= f < run.first + run.completed]
    return {"pose_ms": pose,
            "spans": {k: run.window_spans(k) for k in
                      ("data_wait", "vo", "track", "map", "boundary")}}
