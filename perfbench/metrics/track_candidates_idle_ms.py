"""track_candidates_idle_ms: the device's idle ms while the loop thread is in
the program's `track.candidates` span (the candidate poses' renders and
their scores' readback), a profiled tracked frame (`program_trace.reduce`,
self time); nothing without the program's spans."""
from perfbench import program_trace


def read(r):
    return program_trace.by_span_ms(r, "idle_s", "track.candidates", "track")
