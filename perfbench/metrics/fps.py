"""fps: frames completed in the window over the time from the window's
start to the end of its last completed frame."""


def read(r):
    s = r.res["window_s"]
    return r.res["frames"] / s if s > 0 and r.res["frames"] else None
