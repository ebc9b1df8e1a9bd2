"""vo_pyramid_idle_ms: the device's idle ms in the program's `vo.pyramid` span
(the VO's image pyramid and edges), a profiled frame
(`program_trace.reduce`, self time); nothing without the program's spans."""
from perfbench import program_trace


def read(r):
    return program_trace.by_span_ms(r, "idle_s", "vo.pyramid", "track")
