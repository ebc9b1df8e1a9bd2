"""track_iter_idle_ms: the device's idle ms in the program's `track.iter` spans
outside their `track.readback` (the host dispatching a refine iteration and
its bookkeeping), a profiled tracked frame (`program_trace.reduce`, self
time); nothing without the program's spans."""
from perfbench import program_trace


def read(r):
    return program_trace.by_span_ms(r, "idle_s", "track.iter", "track")
