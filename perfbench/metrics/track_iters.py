"""track_iters: the tracker's refine iterations a tracked frame (the
program's `track.iters` counter, both refine phases), the mean over the
profiled frames only (4 tracked frames): the program's tracer records while
the traced run's profile does, so the window's other frames go uncounted.
Nothing where the program counts none."""
from perfbench import program_trace


def read(r):
    return program_trace.counter_mean(r, "track.iters")
