"""map_syncs_per_frame: the host's blocks on the card inside the
program's `map` stage, a profiled frame that mapped
(`program_trace.reduce`); nothing without the program's spans."""
from perfbench import program_trace


def read(r):
    return program_trace.per_frame(r, "syncs", "map", "map")
