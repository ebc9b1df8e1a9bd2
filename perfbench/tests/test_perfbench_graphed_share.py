"""`track_graphed_share` on made-up program records: replays over refine
iterations of the profiled frames, the main path's only; nothing without a
trace, without the replay counter (a program without the graph) or where
the program counts no iterations."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import run


def _readings(counters, profiled=(9, 10)):
    res = {"run": SimpleNamespace(profiled=list(profiled), profile=None),
           "program_trace": {"spans": [], "counters": counters}}
    return SimpleNamespace(res=res, profiled_frames=len(profiled))


def _frame(f, iters, replays, tag="main"):
    return [{"frame": f, "tag": tag, "name": "track.iters", "n": iters},
            {"frame": f, "tag": tag, "name": "track.graph_captures",
             "n": 1 if replays else 0},
            {"frame": f, "tag": tag, "name": "track.graph_replays",
             "n": replays}]


def test_share_of_replayed_iterations():
    read = run.metric_reader("track_graphed_share")
    # Two profiled frames, one unprofiled and the closer's count left out.
    counters = (_frame(9, 60, 59) + _frame(10, 140, 138) + _frame(8, 5, 0)
                + _frame(9, 7, 0, tag="lc"))
    assert read(_readings(counters)) == pytest.approx((59 + 138) / 200)


@pytest.mark.parametrize("counters", [
    None,                                          # no trace
    [{"frame": 9, "tag": "main", "name": "track.iters", "n": 60}],  # parent
    _frame(9, 0, 0),                               # no iterations
    _frame(8, 60, 59),                             # no profiled frame
])
def test_nothing_to_read(counters):
    read = run.metric_reader("track_graphed_share")
    r = _readings(counters or [])
    if counters is None:
        r.res["program_trace"] = None
    assert read(r) is None
