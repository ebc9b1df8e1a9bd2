"""device_idle_pct: 100 x (1 - the union of the device operations'
intervals over the profiled frames' wall time, the pauses in which
the benchmark counts their launches cut out of both)."""


def read(r):
    p = r.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
