"""track_syncs_per_frame: the host's blocks on the card (synchronize calls,
and copies to or from pageable memory that none follows) inside the
program's `track` stage, its inline VO step left to the VO, a profiled
frame (`program_trace.reduce`); nothing without the program's spans."""
from perfbench import program_trace


def read(r):
    return program_trace.per_frame(r, "syncs", "track")
