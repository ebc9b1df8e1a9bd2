"""vo_syncs_per_frame: the host's blocks on the card inside the program's
`vo` stage (the VO's inline step), a profiled frame
(`program_trace.reduce`); nothing without the program's spans."""
from perfbench import program_trace


def read(r):
    return program_trace.per_frame(r, "syncs", "vo")
