"""pose_ms_p75: the 75th percentile over the window's frames of the time
from the loop's request of a frame to the return of `tracker.track` for
it (data wait, VO and tracking)."""
import statistics


def read(r):
    v = r.summary["pose_ms"]
    return statistics.quantiles(v, n=4)[2] if len(v) >= 2 else None
