"""map_seed_idle_ms: the device's idle ms in the program's `map.seed` span (the
new gaussians' rows and the map's growth), a profiled mapped frame
(`program_trace.reduce`, self time); nothing without the program's spans."""
from perfbench import program_trace


def read(r):
    return program_trace.by_span_ms(r, "idle_s", "map.seed", "map")
