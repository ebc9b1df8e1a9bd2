"""launches_per_frame: the CUDA kernels the profiler saw over the profiled
frames, a frame."""


def read(r):
    p = r.profile
    if not p or not r.profiled_frames or not p["kernels"]:
        return None
    return p["kernels"] / r.profiled_frames
