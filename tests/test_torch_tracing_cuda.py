"""The tracer's spans on the card share the profiler's clock: a burst of K1
launches bracketed by a span, under a CUDA-only `torch.profiler` profile
(which turns the tracer on), has every runtime launch call of the burst
inside the span; and the benchmark's reduction finds the launches and the
host blocks of a small loop in the spans that made them.

These tests need a CUDA card and skip without one; like
`test_torch_kernels_cuda.py` this file imports no JAX:

    python -m pytest --noconftest -m cuda -s tests/test_torch_tracing_cuda.py

(`-s` prints the worst offset of a launch call from the span's edges.)
"""
import time

import pytest
import torch

from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.utils import tracing
from perfbench import program_trace as pt
from test_torch_kernels_cuda import _inputs

pytestmark = pytest.mark.cuda

BURST = 50


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    tracing.disable()
    tracing.drain()
    yield torch.device("cuda")
    tracing.disable()
    tracing.drain()


def _cuda_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def test_span_brackets_its_k1_launches(cuda_device):
    attrs, ss, sc, tx, num_tiles = _inputs(32, 1024, 1500, cuda_device)
    ids = torch.arange(num_tiles, dtype=torch.int32, device=cuda_device)
    cs.composite_sorted_fwd(attrs, ss, sc, ids, 32, tx, 3, 1024)
    torch.cuda.synchronize()
    with _cuda_profile() as prof:
        with tracing.frame(0):
            assert tracing.recording()
            with tracing.span("burst"):
                for _ in range(BURST):
                    cs.composite_sorted_fwd(attrs, ss, sc, ids, 32, tx, 3,
                                            1024)
        torch.cuda.synchronize()
    burst = [s for s in tracing.drain()["spans"] if s["name"] == "burst"]
    assert len(burst) == 1
    runtime, device = pt.profile_events(prof)
    k1 = {c for _, _, n, _, c in device if "fwd_kernel<" in n}
    calls = [ev for ev in runtime if ev[2] in pt.LAUNCHES and ev[4] in k1]
    assert len(calls) == BURST
    t0, t1 = burst[0]["t0_ns"], burst[0]["t1_ns"]
    worst = max(max(t0 - a, b - t1) for a, b, *_ in calls)
    first = min(a for a, *_ in calls) - t0
    last = t1 - max(b for _, b, *_ in calls)
    print(f"\nK1 burst of {BURST} launches in a {(t1 - t0) / 1e3:.1f} us "
          f"span: worst offset {worst} ns (negative: inside), first call "
          f"{first} ns after the span opens, last {last} ns before it "
          f"closes; threads {sorted({ev[3] for ev in calls})}, span "
          f"thread {burst[0]['tid']}")
    assert worst <= 0


def test_reduction_finds_a_loops_launches_and_blocks(cuda_device):
    """A span `track` with two iterations, each a few launches, a blocking
    readback (`.cpu()`, a pageable copy and its sync: one block) and a
    device constant (`torch.tensor(..., device=cuda)`, one more)."""
    x = torch.rand(1 << 16, device=cuda_device)
    torch.cuda.synchronize()
    st = tracing.Stages()
    with _cuda_profile() as prof:
        t_start = time.time_ns()
        with tracing.frame(0), st.span("track"):
            for _ in range(2):
                with tracing.span("track.iter"):
                    y = (x * 2.0 + 1.0).sum()
                    c = torch.tensor([1.0, 2.0], device=cuda_device)
                    with tracing.span("track.readback"):
                        v = (y + c.sum()).cpu()
        torch.cuda.synchronize()
        t_end = time.time_ns()
    assert float(v) > 0
    rec = tracing.drain()
    runtime, device = pt.profile_events(prof)
    red = pt.reduce(rec["spans"], runtime, device, [(t_start, t_end)])
    print(f"\nlaunches {red['launches']['by_span']}, syncs "
          f"{red['syncs']['by_span']}, blocked {red['blocked_s']['by_span']}"
          f", runtime calls {sorted({ev[2] for ev in runtime})}")
    assert red["syncs"]["by_span"].get("track.readback") == 2
    assert red["syncs"]["by_stage"]["track"] == 4
    assert red["launches"]["by_stage"]["track"] >= 6
