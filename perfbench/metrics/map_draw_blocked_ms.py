"""map_draw_blocked_ms: the host's ms blocked on the card in the program's
`map.draw` spans (the keyframe draws), a profiled mapped frame
(`program_trace.reduce`, self time); nothing without the program's spans."""
from perfbench import program_trace


def read(r):
    return program_trace.by_span_ms(r, "blocked_s", "map.draw", "map")
