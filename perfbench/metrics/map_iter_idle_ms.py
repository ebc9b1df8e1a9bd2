"""map_iter_idle_ms: the device's idle ms in the program's `map.iter` spans
outside their `map.readback` and `map.draw` (the host dispatching a mapping
iteration and its bookkeeping), a profiled mapped frame
(`program_trace.reduce`, self time); nothing without the program's spans."""
from perfbench import program_trace


def read(r):
    return program_trace.by_span_ms(r, "idle_s", "map.iter", "map")
