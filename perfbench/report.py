"""A run's lines: the earlier ones (set-up, window, trace, quality, check)
and the result line, from `harness.run_cell`'s readings."""
from __future__ import annotations

import subprocess

from . import check, harness

# The kernel table's readings on the full 1200x680 grid and the TUM
# 540x380 grid (K1 / K2 ms and share of their bound; PERF.md, chip runs of
# the bring-up), printed beside the traced run's rooflines.
KERNEL_TABLE = {"K1": "0.669 ms at 7.5% (1200x680 full grid), 0.330 ms at "
                      "3.3% (TUM 540x380)",
                "K2": "1.275 ms at 9.1% (1200x680 full grid), 0.431 ms at "
                      "5.9% (TUM 540x380)"}


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else ""


class Readings:
    """What a metric reader (`perfbench/metrics/<name>.py`, `read(r)`)
    takes: `res` (the run), `summary` (window spans and pose latencies),
    `setup_s`, `profile` (the reduced trace or None), `counted` (the
    profiled launches' operations and least times, or None / {})."""

    def __init__(self, res: dict):
        self.res = res
        self.summary = harness.summarize(res)
        self.setup_s = res["setup_s"]
        self.profile = res.get("profile")
        self.counted = res.get("counted")
        self.profiled_frames = len(res["run"].profiled)


def build(man: dict, cell: dict, config_file: dict, res: dict, trace: bool,
          reader_of):
    r = Readings(res)
    gen = res["gen"]
    fps = res["frames"] / res["window_s"] if res["window_s"] > 0 else None
    lines = [
        {"phase": "card", "card": card()},
        {"phase": "setup", "setup_s": res["setup_s"],
         "data_s": gen["seconds"],
         "program_setup_s": res["setup_s"] - gen["seconds"],
         "data_bytes": gen["bytes"], "frames_written": gen["n"]},
        {"phase": "window", "frames": res["frames"],
         "window_s": res["window_s"], "ended_by": res["ended_by"],
         "fps": fps, "traced": trace,
         "pose_samples": len(r.summary["pose_ms"]),
         "reader": res["data_report"].get("reader"),
         "decode_ms_avg": res["data_report"].get("decode_ms_avg"),
         "span_ms": {k: (sum(v) / len(v) if v else None, len(v))
                     for k, v in r.summary["spans"].items()}},
    ]
    if res["ended_by"] == "sequence":
        lines.append({"phase": "note", "msg": "the generated sequence ended "
                      "before the window's time; rates are over the time "
                      "it ran"})
    if trace:
        prof = r.profile or {}
        counted = r.counted or {}
        lines.append({
            "phase": "trace", "fps_traced": fps,
            "profiled_frames": r.profiled_frames,
            "profile_window_s": prof.get("window_s"),
            "counting_paused_s": prof.get("paused_s"),
            "busy_s": prof.get("busy_s"),
            "memory_peak_bytes_outside": res["peak_bytes"],
            "memory_peak_bytes_instrumented":
                res.get("peak_instrumented_bytes"),
            "kernel_events": prof.get("kernels"),
            "k1_by_stream": prof.get("k1_by_stream"),
            "counted": counted, "kernel_table": KERNEL_TABLE})
    numbers = res["numbers"]
    limits = config_file["limits"]
    lines.append({"phase": "quality", "ate_cm": numbers["ate_cm"],
                  "last_frame": res["last_frame"],
                  "keyframe": res["keyframe"]})
    lines.append({"phase": "check", "seconds": res["check_s"],
                  "kept_frames": res["kept_frames"]})
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(check.passes(v["value"], v["limit"])
                  for v in checks.values())
    metrics = {}
    for name, unit in harness_metrics(man, cell["name"], trace):
        value = reader_of(name)(r)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}
    final = {"correct": bool(correct), "attempted": int(res["frames"]),
             "failed": 0, "metrics": metrics}
    if trace and r.profile:
        final["device"] = {"busy_s": r.profile["busy_s"],
                           "window_s": r.profile["window_s"]}
        ops = sorted(r.profile["by_name"].items(), key=lambda kv: -kv[1])
        idle = sorted(r.profile["idle_by_span"].items(),
                      key=lambda kv: -kv[1])
        final["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in idle[:10]]}
    final["checks"] = checks
    stderr_lines = [
        f"check {k}: {v['value']!r} <= {v['limit']!r} "
        f"{'ok' if check.passes(v['value'], v['limit']) else 'FAIL'}"
        for k, v in checks.items()]
    stderr_lines.append(f"correct: {correct}")
    return lines, final, stderr_lines


def harness_metrics(man: dict, cell: str, trace: bool):
    out = []
    for m in man["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        out.append((m["name"], m["unit"]))
    return out
