"""map_iters: the mapper's iterations a mapped frame (the program's
`map.iters` counter, half-resolution phase included), the mean over the
profiled frames that map (2 of the 4 in both cells, mapping every 2nd
frame): the program's tracer records while the traced run's profile does,
so the window's other frames go uncounted. Nothing where the program counts
none."""
from perfbench import program_trace


def read(r):
    return program_trace.counter_mean(r, "map.iters")
