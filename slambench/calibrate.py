#!/usr/bin/env python3
"""The readings that a cell's limits are set from (``limits/<cell>.json``).

    python3 slambench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--device cuda] [--out file.json]

In one process: a short window of the program on each of ``--seeds``, and
on each of ``--control-seeds`` the control, the reference at float8 put in
the program's place on the same sampled stream-frames. Prints each run's
numbers (``compare.judge``) and, per number, the largest over the
program's seeds (the lower reading) and the smallest over the control's
(the upper reading). A limit lies between the two. Benchmark runs never
run the control.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(workload, seeds, control_seeds, seconds, device, manifest=None, log=None):
    import torch

    from slambench import compare, harness

    man = manifest
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cfg = man.config(man.workload(workload)["config"])
    matcher = man.matcher(cfg.get("matcher"))

    def control(units):
        ref = harness.check_reference(cfg, matcher, man.root, device, "fp8")
        return compare.program_like(ref, units, cfg)

    runs = []
    for kind, seed in [("program", s) for s in seeds] + [("control", s) for s in control_seeds]:
        r = harness.run_cell(workload, seed, seconds, False, torch.device(device), time.monotonic(),
                             manifest=man, log=lambda s: None,
                             control=control if kind == "control" else None)
        nums = {k: v["value"] for k, v in r["checks"].items()}
        runs.append({"kind": kind, "seed": seed, "numbers": nums, "correct": r["correct"]})
        log(json.dumps(runs[-1]))
    out = {"workload": workload, "runs": runs, "lower": {}, "upper": {}}
    for k in runs[0]["numbers"]:
        prog = [r["numbers"][k] for r in runs if r["kind"] == "program"]
        ctrl = [r["numbers"][k] for r in runs if r["kind"] == "control"]
        out["lower"][k] = max(prog) if prog else None
        out["upper"][k] = min(ctrl) if ctrl else None
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    from slambench.manifest import Manifest

    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    out = readings(args.workload, seeds, cseeds, args.seconds, args.device, Manifest(ROOT, HERE))
    out["seconds_total"] = time.monotonic() - T_START
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
