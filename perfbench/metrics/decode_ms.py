"""decode_ms: the reader's own mean Python decode time a frame
(`dataset.report()["decode_ms_avg"]`, a program counter); nothing under
the native decode pool, which reports none."""


def read(r):
    v = r.res["data_report"].get("decode_ms_avg")
    return float(v) if v else None
