"""The readers of the program's spans and counters: each returns nothing
without a trace, and a number on made-up readings (the program's records
of one profiled frame and a profile of its runtime calls and kernels)."""
from __future__ import annotations

import importlib.util
from types import SimpleNamespace

import pytest
import torch

from perfbench import run

# The idle and blocked ms of the spans inside the stages, from the made-up
# profile's gaps and blocks (in ns; a ms is 1e6 ns).
READERS = {"track_iters": 60.0, "map_iters": 100.0,
           "track_syncs_per_frame": 2.0, "map_syncs_per_frame": 2.0,
           "vo_syncs_per_frame": 1.0, "track_launches_per_frame": 3.0,
           "map_launches_per_frame": 1.0,
           "vo_pyramid_idle_ms": 10e-6, "vo_align_idle_ms": 75e-6,
           "track_candidates_idle_ms": 15e-6,
           "track_iter_idle_ms": (7 + 7 + 167 + 199) * 1e-6,
           "track_readback_blocked_ms": 10e-6,
           "map_seed_idle_ms": 100e-6, "map_iter_idle_ms": 350e-6,
           "map_readback_blocked_ms": 10e-6, "map_draw_blocked_ms": 20e-6}
LOOP = 5


class _Event:
    def __init__(self, start, end, name, corr, stream=7, cuda=True):
        self._s, self._e, self._n, self._c = start, end, name, corr
        self._st, self._cuda = stream, cuda

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def name(self):
        return self._n

    def device_resource_id(self):
        return self._st

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return LOOP


def _span(sid, name, parent, t0, t1):
    return {"name": name, "id": sid, "parent": parent, "frame": 9,
            "tag": "main", "tid": LOOP, "t0_ns": t0, "t1_ns": t1}


def _readings(traced: bool):
    if not traced:
        return SimpleNamespace(res={"run": SimpleNamespace(
            profiled=[], profile=None)}, profiled_frames=0)
    spans = [_span(0, "frame", None, 0, 1000), _span(1, "track", 0, 0, 500),
             _span(2, "vo", 1, 0, 100), _span(5, "vo.pyramid", 2, 0, 40),
             _span(6, "vo.align", 2, 40, 100),
             _span(7, "track.candidates", 1, 100, 110),
             _span(3, "track.iter", 1, 110, 500),
             _span(8, "track.readback", 3, 290, 320),
             _span(4, "map", 0, 500, 1000), _span(9, "map.seed", 4, 500, 600),
             _span(10, "map.iter", 4, 600, 1000),
             _span(11, "map.readback", 10, 650, 680),
             _span(12, "map.draw", 10, 690, 730)]
    counters = [{"frame": 9, "tag": "main", "name": "track.iters", "n": 60},
                {"frame": 9, "tag": "main", "name": "map.iters", "n": 100},
                {"frame": 9, "tag": "lc", "name": "track.iters", "n": 7}]
    host = [(10, 20, "cudaStreamSynchronize", 0),
            (110, 112, "cudaLaunchKernel", 1),
            (120, 122, "cudaLaunchKernel", 2),
            (130, 132, "cudaLaunchKernel", 3),
            (200, 210, "cudaStreamSynchronize", 0),
            (300, 310, "cudaMemcpyAsync", 4),
            (600, 602, "cudaLaunchKernel", 5),
            (660, 670, "cudaStreamSynchronize", 0),
            (700, 720, "cudaDeviceSynchronize", 0)]
    # Idle: 0-10 (vo.pyramid), 20-95 (vo.align), 100-115
    # (track.candidates), 118-125, 128-135, 138-305 and 306-505
    # (track.iter), 510-610 (map.seed), 650-1000 (map.iter).
    dev = [(10, 20, "k", 6), (95, 100, "k", 7),
           (115, 118, "k", 1), (125, 128, "k", 2), (135, 138, "k", 3),
           (305, 306, "Memcpy HtoD (Pageable -> Device)", 4),
           (505, 510, "k", 8), (610, 650, "k", 5)]
    events = ([_Event(a, b, n, c, cuda=False) for a, b, n, c in host]
              + [_Event(a, b, n, c) for a, b, n, c in dev])
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    profile = SimpleNamespace(prof=prof, kept=lambda: [(0, 1000)])
    res = {"run": SimpleNamespace(profiled=[9], profile=profile),
           "program_trace": {"spans": spans, "counters": counters}}
    return SimpleNamespace(res=res, profiled_frames=1)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_a_trace_and_a_number_with_one(name):
    from eags_slam_torch.utils import tracing

    tracing.disable()
    tracing.drain()
    read = run.metric_reader(name)
    assert read(_readings(False)) is None
    assert read(_readings(True)) == pytest.approx(READERS[name])


def test_every_reader_has_its_entry():
    man = run.manifest()
    entries = {m["name"]: m for m in man["per_layer"]}
    for name in READERS:
        assert entries[name]["workloads"] == ["replica_room0.steady",
                                              "tum_fr1_desk.steady"]
        assert importlib.util.find_spec("perfbench.program_trace")
