"""track_launches_per_frame: the kernel launch calls on the loop's streams
inside the program's `track` stage, its inline VO step left to the VO, a
profiled frame (`program_trace.reduce`); nothing without the program's
spans."""
from perfbench import program_trace


def read(r):
    return program_trace.per_frame(r, "launches", "track")
