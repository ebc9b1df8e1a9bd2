"""map_readback_blocked_ms: the host's ms blocked on the card in the program's
`map.readback` spans (each mapping iteration's loss read), a profiled mapped
frame (`program_trace.reduce`, self time); nothing without the program's
spans."""
from perfbench import program_trace


def read(r):
    return program_trace.by_span_ms(r, "blocked_s", "map.readback", "map")
