#!/usr/bin/env python3
"""The benchmark of superslam_tpu_torch: one run of one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card. Set-up
(imports, the frame cache, the checkpoints, the program's kernels, the
cell's warm-up dispatches) is timed from this file's first line. Then the
window: ``--seconds`` of the cell's traffic, traced by the profiler with
``--trace 1``. Then the check against the plain reference. The last line
of standard output is the result as one JSON object; the numbers the check
compared, each beside its limit, are the last lines of standard error.
Exits non-zero, printing no result, without a card, without the program,
or when the process has loaded JAX or the JAX package.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # The program's and its libraries' caches stay in the checkout, at fixed paths.
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    import torch

    from slambench.harness import forbidden_modules, run_cell
    from slambench.manifest import Manifest

    man = Manifest(ROOT, HERE)
    chips = man.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA device(s), "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    import superslam_tpu_torch  # noqa: F401  (no program, no result)

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START, manifest=man, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"no result: the process loaded {', '.join(bad)}")
        return 3
    checks = result["checks"]
    for k, v in checks.items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
