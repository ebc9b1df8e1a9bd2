"""track_ms: the mean host-clock span (ms) of
`tracker.track`, a tracked frame, over
the window's frames outside the instrumented ones (the profiled frames
and the two before them); nothing where the span
never ran."""


def read(r):
    v = r.summary["spans"]["track"]
    return sum(v) / len(v) if v else None
