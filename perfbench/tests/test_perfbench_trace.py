"""The trace's reduction on a made-up device timeline: busy time is the
union of the device intervals inside the profiled window, each idle gap
goes to the host span that covers it, and the compositing kernels are
known by name."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, trace
from perfbench.tests import tiny


class _Event:
    def __init__(self, start, end, name, stream=7):
        self._s, self._e, self._n, self._st = start, end, name, stream

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def name(self):
        return self._n

    def device_resource_id(self):
        return self._st


K1 = "void (anonymous namespace)::fwd_kernel<32, 2, false, false>(x)"
K2 = "void (anonymous namespace)::bwd_kernel<32, 2, false, false>(x)"


def test_reduce_busy_idle_and_kernels():
    p = trace.Profile()
    p.t0_ns, p.t1_ns = 1000, 2000
    events = [_Event(900, 1100, K1), _Event(1050, 1200, K2),
              _Event(1500, 1600, "Memset (Device)"),
              _Event(1550, 1700, "void table_reduce_kernel<0>(x)"),
              _Event(1900, 2100, K1, stream=9),
              _Event(2500, 2600, K1)]
    p.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    spans = [("track", 1150, 1560), ("map", 1650, 1950)]
    r = p.reduce(spans)
    assert r["busy_s"] == pytest.approx((200 + 200 + 100) / 1e9)
    assert r["window_s"] == pytest.approx(1000 / 1e9)
    assert r["idle_by_span"] == pytest.approx({"track": 300 / 1e9,
                                               "map": 200 / 1e9})
    assert r["kernels"] == 4
    assert r["k1_by_stream"] == {7: 1, 9: 1}
    assert r["kernel_s_by_stream"][7]["K2"] == pytest.approx(300 / 1e9)


def test_reduce_cuts_out_pauses():
    """A pause (the counting at a frame boundary) is cut out of the window:
    its events, its length and its idle time count nowhere."""
    p = trace.Profile()
    p.t0_ns, p.t1_ns = 1000, 2000
    p.pauses = [(1300, 1600)]
    events = [_Event(1000, 1100, K1), _Event(1200, 1300, K2),
              _Event(1350, 1550, "void at::native::reduce_kernel<1>(x)"),
              _Event(1700, 1800, K1)]
    p.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    r = p.reduce([("track", 1000, 2000)])
    assert p.kept() == [(1000, 1300), (1600, 2000)]
    assert r["window_s"] == pytest.approx(700 / 1e9)
    assert r["paused_s"] == pytest.approx(300 / 1e9)
    assert r["busy_s"] == pytest.approx(300 / 1e9)
    assert r["idle_by_span"] == pytest.approx({"track": 400 / 1e9})
    assert r["kernels"] == 3
    assert r["k1_by_stream"] == {7: 2}


@pytest.mark.parametrize("name,kid", [
    (K1, "K1"), (K2, "K2"), ("void pose_kernel<32, 2, false, false>", "K4"),
    ("void entries_fwd_kernel<16, 1>(x)", None),
    ("void bwd_window_kernel<32, 1>(x)", None),
    ("void fold_repeats_kernel<0>(x)", "K2"),
    ("void at::native::reduce_kernel<512, 1>(x)", None)])
def test_kernel_of(name, kid):
    assert trace.kernel_of(name) == kid


def test_traced_run_counts_each_profiled_frame(monkeypatch, tmp_path):
    """A traced run on the CPU: the warm frames' launches go uncounted, each
    profiled frame's are counted at its end inside a pause, and the spans
    leave every instrumented frame out."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(harness, "PROFILE_AFTER", 2)
    cell, config_file, mix = tiny.load("replica_room0.steady")
    ov, n = tiny.overrides(config_file, 12)
    res = harness.run_cell(cell, config_file, tiny.mix_of(mix, n),
                           3_000_000_123, 600.0, True, device="cpu",
                           overrides=ov, log=lambda _: None)
    run = res["run"]
    first = harness.WARM_FRAMES
    assert run.profiled == [first + 2 + i for i in range(4)]
    assert run.instrumented == set(range(first, first + 6))
    counted = res["counted"]
    assert counted["K1"]["launches"] > 0 and counted["K2"]["launches"] > 0
    assert counted["K1"]["ops"] > 0 and counted["K2"]["ops"] > 0
    assert res["profile"]["paused_s"] > 0
    assert len(run.profile.pauses) == 3
    track = [f for name, f, _, _ in run.spans if name == "track"]
    assert set(track) & run.instrumented
    assert len(run.window_spans("track")) == len(
        [f for f in track if first <= f < first + res["frames"]
         and f not in run.instrumented])
    assert not run.launches.k1 and not run.launches.on
