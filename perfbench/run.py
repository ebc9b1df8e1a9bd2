"""The benchmark of the PyTorch and CUDA port, `eags_slam_torch`.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json on the card it is started on: the cell's
configuration (`perfbench/configs/<name>.json`), its traffic mix
(`perfbench/traffic/<name>.json`), one run of `harness.run_cell`. Earlier
lines of standard output say what the set-up, the window, the trace and
the check found; the last line is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`, each read by
`perfbench/metrics/<name>.py`), `device`, with `--trace 1` `breakdown`,
and, last, `checks`: each number compared with its limit, also printed as
the last lines of standard error.

`--control 1` runs the control of the check (the program's bf16 kernels,
the reference's frames rounded to bfloat16 in the program's place); a
measured run never passes it.

Exit codes: 0 a result was printed; 2 bad arguments; 3 no CUDA card, or
fewer than the cell asks for; 4 a JAX module was loaded.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "eags_slam_tpu")
CACHE = ROOT / "build" / "perfbench_cache"


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(man: dict, workload: str):
    cells = {c["name"]: c for c in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    with open(ROOT / entry["file"]) as f:
        config_file = json.load(f)
    with open(ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic_mix = json.load(f)
    return cell, config_file, traffic_mix


def metric_reader(name: str):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({k.split(".", 1)[0] for k in sys.modules}
                  & set(FORBIDDEN))


def set_caches() -> None:
    """The program's build and kernel caches inside the checkout, and no
    JAX behind the libraries it may load."""
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    man = manifest()
    cell, config_file, traffic_mix = cell_files(man, args.workload)
    set_caches()
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from perfbench import harness, report

    t_proc = harness.process_start_s()
    res = harness.run_cell(cell, config_file, traffic_mix, args.seed,
                           args.seconds, bool(args.trace), device="cuda",
                           control=bool(args.control), log=emit)
    res["setup_s"] = res["run"].t_window_boot - t_proc
    lines, final, stderr_lines = report.build(
        man, cell, config_file, res, bool(args.trace), metric_reader)
    for line in lines:
        emit(line)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded {found}, which the benchmark never may",
              file=sys.stderr)
        return 4
    final["device"] = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": int(cell["chips"]),
                       "memory_peak_bytes": int(res["peak_bytes"]),
                       **final.get("device", {})}
    checks = final.pop("checks")
    final["checks"] = checks
    for line in stderr_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    emit(final)
    return 0


if __name__ == "__main__":
    sys.exit(main())
