#!/usr/bin/env python3
"""Read, over many seeds in one process, the numbers that a cell's check
of ``correct`` compares: for the program, for its control and for the
planted faults; the readings from which ``benchmarks/limits/<cell>.json``
is set.

    python3 benchmarks/calibrate.py --workload <cell> --seeds S1 S2 ... \
        [--controls 3] [--window 3] [--out FILE] [--device cuda]

For every seed: the cell's set-up at its own size (a scoring cell also
runs a window of ``--window`` seconds, so its checked requests come from
the timed path), the program's outputs against the plain reference.  For
the first ``--controls`` seeds also: the control, the reference with
every matrix product in TF32 (the nearest precision below the
configuration's float32) put in the program's place; the program itself
in bfloat16 (``compute.dtype``); and the cell's planted faults.  One JSON
line per seed, then a summary line: per number the largest program
reading (the lower end of its limit) and the smallest control and fault
readings.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _program(mod, config, traffic, seed, device, window):
    from benchmarks.harness.device import peak_bytes, reset_peak

    drv = mod.Driver(config, traffic, seed, device)
    reset_peak(device)
    drv.setup()
    if drv.kind == "score":
        drv.window(window)
    out = drv.outputs()
    peak = peak_bytes(device)
    drv.release()
    return drv, out, peak


def calibrate(workload, seeds, controls, window, device) -> list:
    from benchmarks.harness import manifest

    cell = manifest.cell(workload)
    mod = manifest.load_module("drivers", cell.traffic["driver"] + ".py")
    lines = []
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        drv, out, peak = _program(mod, cell.config, cell.traffic, seed,
                                  device, window)
        t1 = time.perf_counter()
        ref = drv.reference()
        t2 = time.perf_counter()
        line = {"workload": workload, "seed": seed,
                "program": drv.gaps(out, ref), "peak_bytes": peak,
                "program_s": t1 - t0, "reference_s": t2 - t1}
        if k < controls:
            line["tf32"] = drv.gaps(drv.reference(tf32=True), ref)
            line["faults"] = {name: drv.gaps(o, ref)
                              for name, o in drv.faults(ref).items()}
            bf16 = dict(cell.config, dtype="bfloat16")
            _, out16, _ = _program(mod, bf16, cell.traffic, seed, device,
                                   window)
            line["bf16"] = drv.gaps(out16, ref)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def summary(lines, limits) -> dict:
    out = {}
    for name in limits:
        prog = [ln["program"][name] for ln in lines]
        row = {"limit": limits[name], "program_max": max(prog),
               "program_n": len(prog)}
        for kind in ("tf32", "bf16"):
            vals = [ln[kind][name] for ln in lines if kind in ln]
            if vals:
                row[f"{kind}_min"] = min(vals)
        faults = {}
        for ln in lines:
            for f, r in ln.get("faults", {}).items():
                faults[f] = min(faults.get(f, float("inf")), r[name])
        row["faults_min"] = faults
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--window", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmarks.harness import manifest

    lines = calibrate(args.workload, args.seeds, args.controls, args.window,
                      args.device)
    summ = {"workload": args.workload,
            "summary": summary(lines, manifest.cell(args.workload).limits)}
    print(json.dumps(summ), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for ln in lines + [summ]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
