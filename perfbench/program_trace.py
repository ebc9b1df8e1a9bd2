"""The program's own spans and counters (`eags_slam_torch/utils/tracing.py`)
against the traced run's profile.

The program's tracer records while a `torch.profiler` profile does, so a
`--trace 1` run holds its spans and counters for the profiled frames; the
first reader that asks drains them (`records`) and reduces them once
(`reduced`), both kept on the run's readings.

`reduce` takes the loop thread's spans (the thread that opened the `track`
stages, its tag the main path's), the profile's CUDA runtime calls (host
side, on the spans' clock) and its device events, and the profiled window
without its pauses. It returns, by span name and by stage (the nearest
enclosing span among `STAGES`, so that the VO's inline step inside `track`
is the VO's):

  - `launches`: kernel launch calls whose host interval starts inside the
    innermost open span, the launch's kernel on one of the loop's streams
    (so that the closer's backward, launched from the autograd engine's
    thread on the closer's stream, stays out);
  - `syncs`: the loop thread's host blocks, each a synchronize call or a
    copy to or from pageable host memory that no synchronize call follows
    at once (a `.cpu()` is one block, not two);
  - `blocked_s`: the seconds the host spent in those blocks;
  - `idle_s`: device idle seconds, each gap put down to the innermost span
    open at its middle (self time: a child's gap is not its parent's).

The stage totals feed the launch and sync counts a frame; the totals by
span feed the idle and blocked time of the spans inside the stages
(`by_span`).
"""
from __future__ import annotations

import bisect
from collections import Counter, defaultdict

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
COPIES = ("cudaMemcpy", "cudaMemcpyAsync")
RUNTIME = LAUNCHES + SYNCS + COPIES
STAGES = ("data_wait", "vo", "vo.wait", "track", "boundary", "map",
          "lc_drain")
LOOP = "loop"             # time inside no program span


def records(r):
    """The program's records of the traced run, drained once: {"spans",
    "counters"}, or None where the program has no tracer."""
    if "program_trace" not in r.res:
        try:
            from eags_slam_torch.utils import tracing
        except ImportError:
            r.res["program_trace"] = None
        else:
            r.res["program_trace"] = tracing.drain()
    return r.res["program_trace"]


def profile_events(prof):
    """(runtime, device) of a torch.profiler profile: runtime calls as
    (t0, t1, name, thread, correlation), device events as (t0, t1, name,
    stream, correlation)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    runtime, device = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        row = (s, s + e.duration_ns(), e.name())
        if e.device_type() == cuda:
            device.append(row + (e.device_resource_id(),
                                 e.correlation_id()))
        elif e.name() in RUNTIME:
            runtime.append(row + (e.start_thread_id(), e.correlation_id()))
    return runtime, device


def loop_spans(spans):
    """The main path's spans of the loop's thread (the one that opened the
    `track` stages)."""
    tids = Counter(s["tid"] for s in spans
                   if s["name"] == "track" and s["tag"] == "main")
    if not tids:
        return []
    loop = tids.most_common(1)[0][0]
    return [s for s in spans if s["tid"] == loop and s["tag"] == "main"
            and s["t1_ns"] is not None]


class _Innermost:
    """The innermost of properly nested spans open at a time."""

    def __init__(self, spans):
        self.by_id = {s["id"]: s for s in spans}
        starts, owner, stack = [], [], []
        for s in sorted(spans, key=lambda s: (s["t0_ns"], -s["t1_ns"])):
            while stack and stack[-1]["t1_ns"] <= s["t0_ns"]:
                starts.append(stack.pop()["t1_ns"])
                owner.append(stack[-1] if stack else None)
            stack.append(s)
            starts.append(s["t0_ns"])
            owner.append(s)
        while stack:
            starts.append(stack.pop()["t1_ns"])
            owner.append(stack[-1] if stack else None)
        self.starts, self.owner = starts, owner

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        return self.owner[i] if i >= 0 else None

    def stage(self, rec):
        while rec is not None and rec["name"] not in STAGES:
            rec = self.by_id.get(rec["parent"])
        return rec["name"] if rec is not None else LOOP


def _inside(kept, t):
    i = bisect.bisect_right(kept, (t, float("inf"))) - 1
    return i >= 0 and kept[i][0] <= t < kept[i][1]


def reduce(spans, runtime, device, kept) -> dict:
    """`spans`: the program's span records; `runtime` / `device`: as
    `profile_events` gives them; `kept`: the profiled window without its
    pauses, [(t0_ns, t1_ns)]. Counts and seconds by span name and by
    stage."""
    mine = loop_spans(spans)
    kept = sorted(kept)
    inner = _Innermost(mine)
    out = {k: {"by_span": defaultdict(float), "by_stage": defaultdict(float)}
           for k in ("launches", "syncs", "blocked_s", "idle_s")}

    def add(kind, t, v):
        rec = inner.at(t)
        out[kind]["by_span"][rec["name"] if rec else LOOP] += v
        out[kind]["by_stage"][inner.stage(rec)] += v

    stream_of = {c: st for _, _, _, st, c in device}
    copy_of = {c: n for _, _, n, _, c in device if n.startswith("Memcpy")}
    calls = sorted(ev for ev in runtime if _inside(kept, ev[0]))
    # The profiler numbers threads its own way: the loop's is the one that
    # makes most calls inside the loop's spans.
    loop_tid = Counter(ev[3] for ev in calls
                       if inner.at(ev[0]) is not None).most_common(1)
    loop_tid = loop_tid[0][0] if loop_tid else None
    streams = Counter(stream_of.get(c) for _, _, n, tid, c in calls
                      if n in LAUNCHES and tid == loop_tid)
    streams.pop(None, None)
    by_thread = defaultdict(list)
    for ev in calls:
        by_thread[ev[3]].append(ev)
    for tid, evs in by_thread.items():
        for i, (t0, t1, name, _, corr) in enumerate(evs):
            if name in LAUNCHES:
                if stream_of.get(corr) in streams:
                    add("launches", t0, 1)
            elif tid != loop_tid:
                continue
            elif name in SYNCS:
                add("syncs", t0, 1)
                add("blocked_s", t0, (t1 - t0) / 1e9)
            elif "Pageable" in copy_of.get(corr, ""):
                nxt = evs[i + 1] if i + 1 < len(evs) else None
                follows = nxt is not None and nxt[2] in SYNCS
                if not follows:
                    add("syncs", t0, 1)
                add("blocked_s", t0, (t1 - t0) / 1e9)
    for a, b in idle_gaps(device, kept):
        add("idle_s", 0.5 * (a + b), (b - a) / 1e9)
    return {k: {g: dict(v) for g, v in d.items()} for k, d in out.items()}


def idle_gaps(device, kept):
    """The device's idle gaps inside the kept window: [(t0_ns, t1_ns)]."""
    ivs = sorted((s, e) for s, e, *_ in device)
    gaps = []
    for a, b in kept:
        cur = a
        for s, e in ivs:
            if e <= cur or s >= b:
                continue
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, min(e, b))
        if cur < b:
            gaps.append((cur, b))
    return gaps


def reduced(r):
    """The reduction of the traced run's profile against the program's
    spans, once per run; None without both."""
    if "program_reduced" in r.res:
        return r.res["program_reduced"]
    rec = records(r)
    run = r.res.get("run")
    prof = getattr(getattr(run, "profile", None), "prof", None)
    red = None
    if rec and rec["spans"] and prof is not None:
        runtime, device = profile_events(prof)
        if runtime:       # none on the CPU: no device trace to read
            red = reduce(rec["spans"], runtime, device, run.profile.kept())
    r.res["program_reduced"] = red
    return red


def frames_with(r, name: str) -> list:
    """The profiled frames in which the program opened a `name` span."""
    rec = records(r)
    profiled = set(getattr(r.res.get("run"), "profiled", ()))
    if not rec:
        return []
    return sorted({s["frame"] for s in rec["spans"]
                   if s["name"] == name and s["frame"] in profiled})


def per_frame(r, kind: str, stage: str, frames_of: str = "track"):
    """`kind` (launches, syncs) of `stage` a profiled frame that opened a
    `frames_of` span; None without a reading."""
    red = reduced(r)
    n = len(frames_with(r, frames_of))
    if red is None or not n:
        return None
    return red[kind]["by_stage"].get(stage, 0) / n


def by_span_ms(r, kind: str, span: str, frames_of: str):
    """`kind` (idle_s, blocked_s) put down to span `span` (its self time),
    in ms a profiled frame that opened a `frames_of` span; None without a
    reading."""
    red = reduced(r)
    n = len(frames_with(r, frames_of))
    if red is None or not n:
        return None
    return 1e3 * red[kind]["by_span"].get(span, 0) / n


def counter_mean(r, name: str):
    """The mean of counter `name` over the profiled frames that count it."""
    rec = records(r)
    if not rec:
        return None
    run = r.res.get("run")
    frames = set(getattr(run, "profiled", ()))
    v = [c["n"] for c in rec["counters"] if c["name"] == name
         and c["tag"] == "main" and c["frame"] in frames]
    return sum(v) / len(v) if v else None
