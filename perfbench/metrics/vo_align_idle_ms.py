"""vo_align_idle_ms: the device's idle ms in the program's `vo.align` spans
(the VO's alignment against its keyframe), a profiled frame
(`program_trace.reduce`, self time); nothing without the program's spans."""
from perfbench import program_trace


def read(r):
    return program_trace.by_span_ms(r, "idle_s", "vo.align", "track")
