"""map_launches_per_frame: the kernel launch calls on the loop's streams
inside the program's `map` stage, a profiled frame that mapped
(`program_trace.reduce`); nothing without the program's spans."""
from perfbench import program_trace


def read(r):
    return program_trace.per_frame(r, "launches", "map", "map")
