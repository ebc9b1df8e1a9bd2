"""track_graphed_share: the share of the tracker's refine iterations that
ran from its CUDA graphs (the capture's own included), over the profiled
frames: the program's `track.graph_replays` counter over its `track.iters`
(both counted every tracked frame). Nothing where the program counts no
replays (a program without the graph) or no iterations."""
from perfbench import program_trace


def read(r):
    replays = program_trace.counter_mean(r, "track.graph_replays")
    iters = program_trace.counter_mean(r, "track.iters")
    if replays is None or not iters:
        return None
    return replays / iters
