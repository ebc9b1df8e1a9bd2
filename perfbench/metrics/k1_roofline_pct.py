"""k1_roofline_pct: the sum over the profiled frames' K1 launches of the
least time their inputs need (`yardstick.bound_s`, the operations
counted from K1's inputs) over the sum of their
device times on the main stream (the stream whose K1 launches the
benchmark counted)."""


def read(r):
    c, p = r.counted, r.profile
    if not c or not p or not c["K1"]["launches"]:
        return None
    streams = [s for s, n in p["k1_by_stream"].items()
               if n == c["K1"]["launches"]]
    if len(streams) != 1:
        return None
    t = p["kernel_s_by_stream"][streams[0]].get("K1", 0.0)
    return 100.0 * c["K1"]["bound_s"] / t if t > 0 else None
