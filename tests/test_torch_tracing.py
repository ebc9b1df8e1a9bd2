"""The port's tracer (`eags_slam_torch/utils/tracing.py`) on the CPU: off,
a span is the shared null context and nothing is recorded; on (enabled, or
while a torch.profiler profile records), spans carry their parent, frame id,
thread tag and times on the profiler's clock, and counters add up by frame
and tag. A tiny `GaussianSLAM.run` traced gives the poses and the map of the
untraced run bit for bit; its counters equal the tracker's and the mapper's
own iteration counts, and its report and logs come from the stage spans.
The benchmark's reduction of the program's spans against a profile's
runtime calls (`perfbench/program_trace.py`) on made-up event lists:
launches and host blocks land in the innermost span, idle gaps by their
middle, the closer's thread and streams stay out."""
import json
import threading

import numpy as np
import pytest
import torch

from eags_slam_torch.slam.gaussian_slam import GaussianSLAM
from eags_slam_torch.utils import tracing
from perfbench import program_trace as pt
from test_torch_guards import _CHEAP, _tiny


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def test_off_span_is_shared_null_and_records_nothing():
    assert not tracing.refresh()
    a, b = tracing.span("track.iter"), tracing.span("map.iter")
    assert a is b is tracing._NULL
    with a:
        tracing.count("track.iters", 5)
    with tracing.frame(3):
        pass
    assert tracing.drain() == {"spans": [], "counters": []}


def test_stages_time_with_tracing_off():
    st = tracing.Stages()
    for _ in range(2):
        with st.span("map"):
            pass
    with st.span("track"):
        pass
    assert st.count["map"] == 2 and st.count["track"] == 1
    assert st.last == st.last_s["track"] >= 0.0
    assert st.mean_ms("map") == pytest.approx(1e3 * st.total_s["map"] / 2)
    assert st.mean_ms("boundary") == 0.0
    assert tracing.drain()["spans"] == []


def test_span_store_keeps_only_the_newest_spans(monkeypatch):
    """A profile that nobody drains holds at most `MAX_SPANS` spans, the
    newest."""
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.drain()               # a store of the patched size
    tracing.enable()
    with tracing.frame(1):
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    names = [s["name"] for s in tracing.drain()["spans"]]
    assert names == ["s3", "s4", "frame"]
    monkeypatch.undo()
    tracing.drain()
    assert tracing._spans.maxlen == tracing.MAX_SPANS > 3


def test_spans_carry_parent_frame_and_tag():
    tracing.enable()
    st = tracing.Stages()
    with tracing.frame(7):
        with st.span("track"):
            with tracing.span("track.iter"):
                with tracing.span("track.readback"):
                    pass
            tracing.count("track.iters", 3)
            tracing.count("track.iters", 2)
    with tracing.frame(8):
        tracing.count("track.iters", 1)
    rec = tracing.drain()
    by = {(s["name"], s["frame"]): s for s in rec["spans"]}
    assert set(by) == {("frame", 7), ("track", 7), ("track.iter", 7),
                       ("track.readback", 7), ("frame", 8)}
    by = {name: s for (name, f), s in by.items() if f == 7}
    assert by["frame"]["parent"] is None
    assert by["track"]["parent"] == by["frame"]["id"]
    assert by["track.iter"]["parent"] == by["track"]["id"]
    assert by["track.readback"]["parent"] == by["track.iter"]["id"]
    assert {s["tag"] for s in rec["spans"]} == {tracing.MAIN}
    assert {s["tid"] for s in rec["spans"]} == {threading.get_native_id()}
    for s in rec["spans"]:
        assert s["t0_ns"] <= s["t1_ns"]
    inner, outer = by["track.readback"], by["frame"]
    assert outer["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] \
        <= outer["t1_ns"]
    assert sorted((c["frame"], c["name"], c["n"]) for c in rec["counters"]) \
        == [(7, "track.iters", 5), (8, "track.iters", 1)]
    assert tracing.drain() == {"spans": [], "counters": []}


def test_closer_thread_records_under_its_tag():
    """A span of the closer's thread (under `counting_as("lc")`) carries
    its tag and its own parents, never the loop's open span."""
    tracing.enable()
    done = threading.Event()

    def closer():
        with tracing.counting_as("lc"), tracing.span("closer"):
            with tracing.span("track.iter"):
                tracing.count("track.iters", 4)
        done.set()

    with tracing.frame(2), tracing.span("map"):
        t = threading.Thread(target=closer)
        t.start()
        t.join()
    assert done.is_set()
    rec = tracing.drain()
    by = {s["name"]: s for s in rec["spans"]}
    assert by["closer"]["tag"] == "lc" and by["closer"]["parent"] is None
    assert by["track.iter"]["tag"] == "lc"
    assert by["track.iter"]["parent"] == by["closer"]["id"]
    assert by["map"]["tag"] == tracing.MAIN
    assert by["closer"]["tid"] != by["map"]["tid"]
    assert rec["counters"] == [{"frame": 2, "tag": "lc",
                                "name": "track.iters", "n": 4}]


def test_profiler_turns_tracing_on_and_shares_its_clock():
    """While a torch.profiler profile records, a frame or stage turns the
    tracer on; an op run inside a span is an event inside the span's
    [t0_ns, t1_ns] on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.arange(4096, dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.frame(0):
            assert tracing.recording()
            with tracing.span("burst"):
                for _ in range(5):
                    x = torch.cumsum(x, 0) * 0.5
    assert not tracing.refresh()
    burst = [s for s in tracing.drain()["spans"] if s["name"] == "burst"]
    assert len(burst) == 1
    t0, t1 = burst[0]["t0_ns"], burst[0]["t1_ns"]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::cumsum"]
    assert len(ops) == 5
    for e in ops:
        assert t0 <= e.start_ns() and e.start_ns() + e.duration_ns() <= t1


def test_composite_sorted_keeps_the_tag_names():
    from eags_slam_torch.ops import composite_entries as ce
    from eags_slam_torch.ops import composite_sorted as cs

    assert cs.counting_as is tracing.counting_as
    assert cs.count_tag is tracing.count_tag
    assert cs.LaunchCounts is ce.LaunchCounts is tracing.LaunchCounts
    assert cs.MAIN == tracing.MAIN


# ---------------------------------------------------------------------------
# A tiny run, untraced and traced
# ---------------------------------------------------------------------------

def _run(tmp_path, traced: bool):
    sections = dict(_CHEAP)
    sections["tracking"] = {**_CHEAP["tracking"],
                            "odometry_type": "odometer"}
    cfg = _tiny(tmp_path, frames=5, **sections)
    if traced:
        tracing.enable()
    slam = GaussianSLAM(cfg)
    try:
        report = slam.run()
    finally:
        slam.cleanup()
        tracing.disable()
    rec = tracing.drain()
    with open(tmp_path / "out" / "log.jsonl") as f:
        log = [json.loads(line) for line in f]
    return slam, report, rec, log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tracing.disable()
    tracing.drain()
    off = _run(tmp_path_factory.mktemp("off"), False)
    on = _run(tmp_path_factory.mktemp("on"), True)
    return off, on


def test_tiny_run_untraced_records_nothing(runs):
    (_, report, rec, _), _ = runs
    assert rec == {"spans": [], "counters": []}
    assert set(report["stage_totals_s"]) == {"track", "map", "data_wait",
                                             "boundary", "lc_drain"}
    for k in ("track_ms_avg", "map_ms_avg", "data_wait_ms_avg", "map_frames",
              "fps", "vo"):
        assert k in report


def test_tiny_run_traced_is_bit_for_bit_untraced(runs):
    (s0, _, _, _), (s1, _, rec, _) = runs
    assert rec["spans"]
    np.testing.assert_array_equal(s0.estimated_c2ws, s1.estimated_c2ws)
    np.testing.assert_array_equal(s0.exposures_ab, s1.exposures_ab)
    for k, v in s0.state.params.as_dict().items():
        assert torch.equal(v, s1.state.params.as_dict()[k]), k
    assert torch.equal(s0.state.alive, s1.state.alive)


def test_tiny_run_spans_cover_the_layers(runs):
    _, (_, _, rec, _) = runs
    names = {s["name"] for s in rec["spans"]}
    assert {"frame", "data_wait", "vo", "track", "map", "track.candidates",
            "track.iter", "track.readback", "map.seed", "map.iter",
            "map.readback", "map.draw", "vo.step", "vo.pyramid", "vo.align",
            "vo.keyframe"} <= names
    by_id = {s["id"]: s for s in rec["spans"]}
    for s in rec["spans"]:
        if s["name"] != "frame":
            assert s["parent"] in by_id, s["name"]
            p = by_id[s["parent"]]
            assert p["frame"] == s["frame"]
            assert p["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= p["t1_ns"]
    frames = [s["frame"] for s in rec["spans"] if s["name"] == "frame"]
    assert frames == list(range(5))
    vo = [s for s in rec["spans"] if s["name"] == "vo"]
    assert all(by_id[s["parent"]]["name"] == "track" for s in vo)


def test_iteration_counters_equal_the_programs_counts(runs):
    _, (slam, _, rec, log) = runs
    counters = {(c["frame"], c["name"]): c["n"] for c in rec["counters"]}
    track = [n for (f, k), n in sorted(counters.items())
             if k == "track.iters"]
    assert track == slam.tracker.iter_cnt and track
    mapped = {r["frame"]: r["iterations"] for r in log
              if r.get("kind") == "mapping"}
    assert {f: n for (f, k), n in counters.items() if k == "map.iters"} \
        == mapped
    iters = [s for s in rec["spans"] if s["name"] == "track.iter"]
    assert len(iters) == sum(track)
    assert len([s for s in rec["spans"] if s["name"] == "map.iter"]) \
        == sum(mapped.values())


def test_report_is_built_from_the_stage_spans(runs):
    _, (slam, report, rec, log) = runs

    def total(name):
        return sum(s["t1_ns"] - s["t0_ns"] for s in rec["spans"]
                   if s["name"] == name) / 1e9

    def spans(name):
        return [s for s in rec["spans"] if s["name"] == name]

    for k in ("track", "map", "data_wait"):
        assert report["stage_totals_s"][k] == round(total(k), 2)
        assert slam.stages.total_s[k] == pytest.approx(total(k), abs=1e-9)
    assert report["track_ms_avg"] == pytest.approx(
        1e3 * total("track") / len(spans("track")))
    assert report["map_ms_avg"] == pytest.approx(
        1e3 * total("map") / len(spans("map")))
    assert report["map_frames"] == len(spans("map"))
    assert report["data_wait_ms_avg"] == pytest.approx(
        1e3 * total("data_wait") / 5)
    assert report["vo"]["mean_track_ms"] == pytest.approx(
        1e3 * total("vo.step") / len(spans("vo.step")))
    assert report["vo"]["mean_dt_ms"] == pytest.approx(
        1e3 * total("vo.keyframe") / len(spans("vo.keyframe")))


def test_tracking_log_times_come_from_the_spans(runs):
    _, (_, _, rec, log) = runs
    dur = {(s["frame"], s["name"]): (s["t1_ns"] - s["t0_ns"]) / 1e6
           for s in rec["spans"]}
    tracked = [r for r in log if r.get("kind") == "tracking"]
    assert [r["frame"] for r in tracked] == [2, 3, 4]
    for r in tracked:
        f = r["frame"]
        assert "track_dispatch_ms" not in r
        assert r["track_frame_ms"] == pytest.approx(dur[(f, "track")])
        assert r["vo_wait_ms"] == pytest.approx(dur[(f, "vo")])
        assert r["vo_ms"] == pytest.approx(dur[(f, "vo.step")])
        assert r["data_wait_ms"] == pytest.approx(dur[(f, "data_wait")])
    mapped = [r for r in log if r.get("kind") == "mapping"]
    for r in mapped:
        assert r["map_ms"] == pytest.approx(dur[(r["frame"], "map")])


# ---------------------------------------------------------------------------
# The benchmark's reduction, on made-up events
# ---------------------------------------------------------------------------

LOOP, CLOSER, AUTOGRAD = 11, 22, 33


def _span(sid, name, parent, t0, t1, tid=LOOP, tag="main", frame=0):
    return {"name": name, "id": sid, "parent": parent, "frame": frame,
            "tag": tag, "tid": tid, "t0_ns": t0, "t1_ns": t1}


def _spans():
    return [_span(0, "frame", None, 0, 1000),
            _span(1, "track", 0, 0, 600),
            _span(2, "vo", 1, 0, 200),
            _span(3, "track.iter", 1, 200, 400),
            _span(4, "track.readback", 3, 350, 400),
            _span(5, "track.iter", 1, 400, 600),
            _span(6, "map", 0, 600, 1000),
            _span(7, "closer", None, 100, 900, tid=CLOSER, tag="lc")]


def test_reduce_puts_launches_and_syncs_in_the_innermost_span():
    runtime = [(10, 12, "cudaLaunchKernel", LOOP, 1),         # vo
               (210, 212, "cudaLaunchKernel", LOOP, 2),       # track.iter
               (300, 302, "cudaLaunchKernel", AUTOGRAD, 3),   # backward
               (360, 390, "cudaStreamSynchronize", LOOP, 0),  # readback
               (450, 452, "cudaLaunchKernel", CLOSER, 4),     # the closer's
               (460, 462, "cudaLaunchKernel", AUTOGRAD, 5),   # its backward
               (470, 480, "cudaStreamSynchronize", CLOSER, 0),
               (700, 702, "cudaLaunchKernel", LOOP, 6)]       # map
    device = [(20, 30, "k", 7, 1), (220, 230, "k", 7, 2),
              (310, 320, "k", 7, 3), (455, 458, "k", 9, 4),
              (465, 468, "k", 9, 5), (710, 720, "k", 7, 6)]
    red = pt.reduce(_spans(), runtime, device, [(0, 1000)])
    assert red["launches"]["by_span"] == {"vo": 1, "track.iter": 2, "map": 1}
    assert red["launches"]["by_stage"] == {"vo": 1, "track": 2, "map": 1}
    assert red["syncs"]["by_span"] == {"track.readback": 1}
    assert red["blocked_s"]["by_stage"] == {"track": pytest.approx(30e-9)}


def test_reduce_counts_a_pageable_copy_and_its_sync_as_one_block():
    runtime = [(360, 370, "cudaMemcpyAsync", LOOP, 1),
               (370, 380, "cudaStreamSynchronize", LOOP, 0),
               (410, 420, "cudaMemcpyAsync", LOOP, 2),
               (430, 432, "cudaMemcpyAsync", LOOP, 3),
               (700, 720, "cudaMemcpyAsync", LOOP, 4),
               (725, 730, "cudaLaunchKernel", LOOP, 5)]
    device = [(371, 372, "Memcpy DtoH (Device -> Pageable)", 7, 1),
              (415, 416, "Memcpy HtoD (Pageable -> Device)", 7, 2),
              (431, 432, "Memcpy DtoD (Device -> Device)", 7, 3),
              (710, 712, "Memcpy DtoH (Device -> Pageable)", 7, 4),
              (740, 750, "k", 7, 5)]
    red = pt.reduce(_spans(), runtime, device, [(0, 1000)])
    assert red["syncs"]["by_span"] == {"track.readback": 1, "track.iter": 1,
                                       "map": 1}
    assert red["blocked_s"]["by_span"] == pytest.approx(
        {"track.readback": 20e-9, "track.iter": 10e-9, "map": 20e-9})


def test_reduce_puts_idle_gaps_by_their_middle_and_cuts_pauses():
    device = [(0, 100, "k", 7, 1), (390, 410, "k", 7, 2),
              (580, 900, "k", 7, 3)]
    runtime = [(1, 2, "cudaLaunchKernel", LOOP, 1)]
    # Gaps: 100-390 (middle 245: track.iter), 410-580 (495: track.iter),
    # 900-1000 (950: map); the pause 500-550 is cut out of the second.
    red = pt.reduce(_spans(), runtime, device, [(0, 500), (550, 1000)])
    assert red["idle_s"]["by_span"] == pytest.approx(
        {"track.iter": (290 + 90 + 30) * 1e-9, "map": 100e-9})
    assert red["idle_s"]["by_stage"] == pytest.approx(
        {"track": 410e-9, "map": 100e-9})
    assert pt.idle_gaps(device, [(0, 500), (550, 1000)]) == [
        (100, 390), (410, 500), (550, 580), (900, 1000)]


def test_reduce_leaves_out_calls_outside_the_window():
    runtime = [(210, 212, "cudaLaunchKernel", LOOP, 1),
               (520, 530, "cudaDeviceSynchronize", LOOP, 0),
               (1200, 1210, "cudaStreamSynchronize", LOOP, 0)]
    device = [(220, 230, "k", 7, 1)]
    red = pt.reduce(_spans(), runtime, device, [(0, 500), (550, 1000)])
    assert red["syncs"]["by_span"] == {}
    assert red["launches"]["by_span"] == {"track.iter": 1}
