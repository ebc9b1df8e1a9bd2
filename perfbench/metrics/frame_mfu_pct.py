"""frame_mfu_pct: the FP32 operations of every K1 / K2 / K4 launch of the
main path in the profiled frames, counted from K1's inputs (a K2 / K4
launch from those of the K1 launch whose output it takes;
`yardstick.work` / `ops`), over the frames' wall seconds (the counting
pauses cut out) times the FP32 peak. It leaves out the VO, the losses,
the projection and Adam."""
from perfbench import yardstick


def read(r):
    c, p = r.counted, r.profile
    if not c or not p or p["window_s"] <= 0:
        return None
    ops = sum(c[k]["ops"] for k in ("K1", "K2", "K4"))
    if not ops:
        return None
    return 100.0 * ops / (p["window_s"] * yardstick.FP32_OPS_PER_S)
