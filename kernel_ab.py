#!/usr/bin/env python3
"""A/B timing of compositing-kernel variants on one CUDA card.

    python3 kernel_ab.py                      # base, regs_free, reduce10
    python3 kernel_ab.py --parent DIR         # + K1's source from DIR
    python3 kernel_ab.py --sass DIR           # default instances' SASS
                                              # against DIR's

Builds the port's kernels as they are (`base`) and as variants that each
undo one design choice, every variant into its own library under
build/kernel_ab/; checks each variant against base on chip_smoke.py's
kernels-map inputs (they compute the same sums, so they must agree bit for
bit); then times them in four rounds that alternate the order (median of
20 CUDA-event timings each). Variants:
  regs_free  K1 / K5 without the register cap of their 512-thread blocks
             (`__launch_bounds__(512, 3)`)
  reduce10   K4 summing all 10 replay terms with reduce10 and keeping the
             6 pose terms, in place of reduce6
  parent_k1  K1's source taken from another checkout (DIR, e.g. a parent
             commit unpacked with git archive) with the same C interface
             (the variant argument `opts` before the stream)
Prints the card's name and power limit, one JSON line per variant with the
registers nvcc reports for K1, K4 and K5, the check, and the timings.
Exits 1 without a CUDA card.

`--sass DIR` compiles each kernel source of this tree and of DIR (e.g. a
parent commit unpacked with git archive) to sm_90a machine code, one nvcc
per source in parallel, and compares the instructions of every default
instance (K1-K4's <..., false, false> variants, K5 / K6 as they are) with
DIR's instance of the same tile shape, hex fields (addresses, branch
targets, constants) masked. Prints one JSON line {kernel<template args>:
{instructions, identical}}; exits 1 if one differs. Needs the CUDA toolkit,
not a card.
"""
import argparse
import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

BUILD = Path("build/kernel_ab")
FWD_BOUNDS = ("__global__ void __launch_bounds__(TILE * TILE / PPT, "
              "PPT == 2 ? 3 : 1)")
REGS_FREE = [(f, f"{FWD_BOUNDS}\n{k}",
              f"__global__ void __launch_bounds__(TILE * TILE / PPT)\n{k}")
             for f, k in (("composite_sorted_fwd.cu", "fwd_kernel"),
                          ("composite_entries_fwd.cu", "entries_fwd_kernel"))]
REDUCE10 = [("pose_grad_sorted.cu",
             "eags::walk_chunk<PJ, QUAD>(\n"
             "        P, s_attr, s_box, jmax, lane, wm,\n"
             "        [&](int j, int ch, float v) { s_warp[warp][ch][j] = v; }, "
             "B, s_q);",
             "eags::walk_chunk<eags::NG, QUAD>(\n"
             "        P, s_attr, s_box, jmax, lane, wm,\n"
             "        [&](int j, int ch, float v) {\n"
             "          const int c = ch < 5 ? ch : (ch == 9 ? 5 : -1);\n"
             "          if (c >= 0) s_warp[warp][c][j] = v;\n"
             "        }, B, s_q);")]


def build_variant(cs, name, subs=(), files=None):
    """Copy csrc/, apply the text substitutions and whole-file
    replacements, build it into its own library; returns (lib, regs)."""
    src = BUILD / name / "csrc"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(Path("eags_slam_torch/csrc"), src)
    for fname, old, new in subs:
        text = (src / fname).read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {fname} has no {old!r}")
        (src / fname).write_text(text.replace(old, new))
    for fname, text in (files or {}).items():
        (src / fname).write_text(text)
    cs.CSRC, cs.BUILD_DIR, cs._LIB = src, BUILD / name / "lib", None
    with contextlib.redirect_stdout(io.StringIO()):
        lib = cs.load_kernels(verbose=True)
    regs, fn = {}, None
    for line in cs.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        k = fn and re.search(r"(entries_fwd_kernel|fwd_kernel|pose_kernel)"
                             r"ILi(\d+)ELi(\d+)E(?:Lb0ELb0E)?E", fn)
        if m and k:
            regs[f"{k.group(1)}<{k.group(2)},{k.group(3)}>"] = int(m.group(1))
            fn = None
    return lib, regs


# K1-K4's kernels, whose last two template arguments are the variant.
VARIANT_KERNELS = ("fwd_kernel", "bwd_kernel", "bwd_window_kernel",
                   "pose_kernel")
KERNEL_NAME = re.compile(r"\d(entries_fwd_kernel|entries_bwd_kernel|"
                         r"bwd_window_kernel|pose_kernel|fwd_kernel|"
                         r"bwd_kernel)I((?:Li\d+E|Lb[01]E)+)E")


def _sass_functions(csrc: Path, out: Path) -> dict:
    """{mangled name: [instruction text]} of every kernel in csrc/*.cu."""
    from eags_slam_torch.ops import composite_sorted as cs

    out.mkdir(parents=True, exist_ok=True)
    names = sorted(p.name for p in csrc.glob("*.cu"))
    procs = [subprocess.Popen(
        [cs._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-cubin", "-o", str(out / (n + ".cubin")),
         str(csrc / n)]) for n in names]
    if any(p.wait() for p in procs):
        raise SystemExit(f"nvcc failed on {csrc}")
    cuobjdump = Path(cs._nvcc()).with_name("cuobjdump")
    funcs, name = {}, None
    for n in names:
        text = subprocess.run([str(cuobjdump), "-sass",
                               str(out / (n + ".cubin"))],
                              capture_output=True, text=True,
                              check=True).stdout
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                name = m.group(1)
                funcs[name] = []
                continue
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", line)
            if name and m:
                funcs[name].append(re.sub(r"0x[0-9a-f]+", "X", m.group(1)))
    return funcs


def _default_instances(funcs: dict, variants: bool) -> dict:
    """{kernel<tile args>: instructions} of the default instances; with
    `variants`, K1-K4 carry <QUAD, BF16> last and only <false, false>
    counts."""
    out = {}
    for name, body in funcs.items():
        m = KERNEL_NAME.search(name)
        if not m:
            continue
        kernel, targs = m.group(1), m.group(2)
        if variants and kernel in VARIANT_KERNELS:
            if not targs.endswith("Lb0ELb0E"):
                continue
            targs = targs[: -len("Lb0ELb0E")]
        out[f"{kernel}<{targs}>"] = body
    return out


def compare_sass(other: str) -> bool:
    """This tree's default kernel instances against `other`'s (a tree
    from before the variants), instruction by instruction."""
    mine = _default_instances(_sass_functions(
        Path("eags_slam_torch/csrc"), BUILD / "sass" / "this"), True)
    theirs = _default_instances(_sass_functions(
        Path(other) / "eags_slam_torch/csrc", BUILD / "sass" / "other"),
        False)
    report = {k: {"instructions": len(v), "identical": mine.get(k) == v}
              for k, v in sorted(theirs.items())}
    print(json.dumps({"sass_against": other, "kernels": report}),
          flush=True)
    return bool(report) and all(r["identical"] for r in report.values())


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", help="checkout whose K1 source to time")
    p.add_argument("--sass", help="checkout whose default kernels' SASS "
                                  "to compare")
    p.add_argument("--rounds", type=int, default=4)
    args = p.parse_args()
    if args.sass:
        sys.exit(0 if compare_sass(args.sass) else 1)

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("kernel_ab: needs a CUDA card\n")
        sys.exit(1)
    import chip_smoke as smk
    from eags_slam_torch.ops import composite_entries as ce
    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.ops import rasterizer as R

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    variants = {"base": (), "regs_free": REGS_FREE, "reduce10": REDUCE10}
    libs = {}
    for name, subs in variants.items():
        libs[name], regs = build_variant(cs, name, subs)
        print(json.dumps({"variant": name, "registers": regs}), flush=True)
    if args.parent:
        k1 = (Path(args.parent) / "eags_slam_torch/csrc/"
              "composite_sorted_fwd.cu").read_text()
        libs["parent_k1"], regs = build_variant(
            cs, "parent_k1", files={"composite_sorted_fwd.cu": k1})
        print(json.dumps({"variant": "parent_k1", "registers": regs}),
              flush=True)

    # chip_smoke.py's kernels-map inputs, its subset and polish sets.
    (attrs, ss, sc, cfg, cam, tx, ty, _, _, gmap) = smk._kernel_inputs(
        smk.PER_WALL)
    T = tx * ty
    gen = torch.Generator(device="cuda").manual_seed(0)
    full = torch.arange(T, dtype=torch.int32, device="cuda")
    subset = torch.randperm(T, generator=gen, device="cuda")[
        : round(0.125 * T)].to(torch.int32)
    polish = torch.randperm(T, generator=gen, device="cuda")[
        : round(0.25 * T)].to(torch.int32)
    cs._LIB = libs["base"]
    xyz, q, log_s, opac, colors, w2c = gmap
    fs = R.freeze_sorted(xyz, q, log_s, opac, colors, w2c, cam, cfg)
    pv = torch.tensor([0.9995, 0.01, -0.02, 0.015, 0.01, -0.02, 0.03],
                      device="cuda")
    with torch.no_grad():
        a4 = R._stack_reproj_rows(fs.e3d, R._pose_rel_w2c(pv, w2c), cam,
                                  cfg).contiguous()
        jac = R._pose_jacobian(fs.e3d, pv, w2c, cam, cfg)
    k4in = {}
    for lab, ids in (("subset", subset), ("polish", polish), ("full", full)):
        out, cols = cs.composite_sorted_fwd(
            a4, fs.seg_start.contiguous(), fs.seg_cnt.contiguous(), ids,
            cfg.tile, tx, cfg.bands, cfg.seg_cap)
        dout = torch.randn(out.shape, generator=gen, device="cuda")
        dout[:, 5:] = 0.0
        k4in[lab] = (ids, out, cols, dout)
    ecfg = R.RasterConfig(tile=32, dup_side=3, entry_cap_factor=4,
                          max_per_tile=8192, backend="pallas")
    with torch.no_grad():
        proj = R.project_gaussians(xyz, q, log_s, opac, w2c, cam, ecfg)
        slot, pstart, count = R._build_slots(proj, cam, ecfg)
        rent = R._gather_entries(R._with_sentinel(R._stack_attrs(
            proj, colors)), slot).contiguous()
        fb = R.freeze_binning(xyz, q, log_s, opac, colors, w2c, cam, ecfg)
        rows = R._reproject_rows(fb.e3d, R._pose_rel_w2c(pv, w2c), cam,
                                 ecfg)
        fent = torch.cat([torch.stack(rows[:10]), torch.zeros(
            (6, fb.e3d.shape[1]), device="cuda")]).contiguous()

    fwd = ["base", "regs_free"] + (["parent_k1"] if args.parent else [])
    jobs = {
        "K1_full": (fwd, lambda: cs.composite_sorted_fwd(
            attrs, ss, sc, full, cfg.tile, tx, cfg.bands, cfg.seg_cap)[0]),
        "K1_subset": (fwd, lambda: cs.composite_sorted_fwd(
            attrs, ss, sc, subset, cfg.tile, tx, cfg.bands, cfg.seg_cap)[0]),
        "K5_render": (["base", "regs_free"], lambda: ce.composite_entries_fwd(
            rent, pstart, count, 32, tx)),
        "K5_frozen": (["base", "regs_free"], lambda: ce.composite_entries_fwd(
            fent, fb.pstart, fb.count, 32, tx)),
    }
    for lab, (ids, out, cols, dout) in k4in.items():
        jobs["K4_" + lab] = (["base", "reduce10"],
                             lambda ids=ids, out=out, cols=cols, dout=dout:
                             cs.pose_grad_sorted(a4, jac, ids, out, cols,
                                                 dout, cfg.tile, tx))
    check = {}
    for name, (vs, fn) in jobs.items():
        cs._LIB = libs["base"]
        ref = fn()
        for v in vs[1:]:
            cs._LIB = libs[v]
            torch.cuda.synchronize()
            check[f"{name}:{v}"] = bool(torch.equal(fn(), ref))
    print(json.dumps({"equal_to_base": check}), flush=True)
    times = {k: {v: [] for v in vs} for k, (vs, _) in jobs.items()}
    for rnd in range(args.rounds):
        for name, (vs, fn) in jobs.items():
            for v in (vs if rnd % 2 == 0 else vs[::-1]):
                cs._LIB = libs[v]
                fn()
                torch.cuda.synchronize()
                times[name][v].append(smk._median_ms(fn, smk.REPS))
    print(json.dumps({"ms": times}), flush=True)
    if not all(check.values()):
        raise SystemExit("a variant disagrees with base")


if __name__ == "__main__":
    main()
