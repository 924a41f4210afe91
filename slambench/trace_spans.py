#!/usr/bin/env python3
"""A traced run of one cell, with the program's own spans read beside the
device trace.

    python3 slambench/trace_spans.py --workload <cell> --seed <n> --seconds <s>
    python3 slambench/trace_spans.py --scope-cost <n>

The run is ``run.py --trace 1``'s (``harness.run_cell``: the same set-up,
window, profiler and check), with the port's span recording
(``superslam_tpu_torch/utils/profiler.py``) opened at the window's start
and stopped after the entry's ``finish()``. The spans reach the readers
named in ``SPAN_METRICS`` (``metrics/<name>.py``) as ``run.program_spans``
(those inside the window) and ``run.trace.program``
(``spans.by_program_span`` over the profiler's events). Standard error
gets, before the harness's own lines about the check: the device and idle
seconds by innermost program span, the shares of the device time mapped
through launch records, by stream order and not at all, the detector and
matcher seconds under both attributions (spans and ``layers/*.json``'s
name patterns), and the kernels each wrapper's counted launches make
against those of its kernels in the trace. The last line of standard
output is run.py's result with those metrics in it. The recording's cost
is read against ``run.py --trace 1`` on the same seed.

``--scope-cost n`` times ``n`` scopes of ``profile_scope`` with the
recorder off, with the accumulator's switch on, and with a recording
open, and prints the microseconds a scope.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from unittest import mock  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")

SPAN_METRICS = [
    {"name": "prepare_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "dispatch", "moves": "frames_per_s"},
    {"name": "prepare_idle_pct", "unit": "%", "better": "lower", "source": "program_span",
     "layer": "dispatch", "moves": "frames_per_s"},
    {"name": "issue_idle_pct", "unit": "%", "better": "lower", "source": "program_span",
     "layer": "dispatch", "moves": "frames_per_s"},
    {"name": "detector_device_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "models: detector", "moves": "frames_per_s"},
    {"name": "matcher_device_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "models: matcher", "moves": "frames_per_s"},
]


def inside(recorded, t0: int, t1: int) -> list[tuple]:
    """The recording's spans that lie in [t0, t1], their parent and root
    indices renumbered (-1 where that span lies outside)."""
    keep = [i for i, s in enumerate(recorded) if s[1] >= t0 and s[2] <= t1]
    new = {i: k for k, i in enumerate(keep)}
    return [(n, a, b, new.get(p, -1), new.get(r, -1), th)
            for n, a, b, p, r, th in (recorded[i] for i in keep)]


class SpanRun:
    """What one run records beyond the harness: the profiler (kept past the
    harness's own reference), the window's end, the program's spans; and
    their reading, made once, at the first span metric's read."""

    def __init__(self, seconds: float, log):
        self.seconds, self.log = seconds, log
        self.prof = None
        self.t_end = None
        self.recorded = None
        self.read_done = False

    def keep(self, prof):
        self.prof = prof
        return prof

    def attach(self, run) -> None:
        """``run.program_spans`` and ``run.trace.program``, and the lines
        the traced run prints about them."""
        if self.read_done:
            return
        self.read_done = True
        if self.recorded is None or self.prof is None or run.trace is None:
            return
        from slambench import spans

        t1 = self.t_end
        t0 = t1 - int(self.seconds * 1e9)
        run.program_spans = inside(self.recorded, t0, t1)
        evs = spans.events(self.prof)
        self.prof = None
        prog = run.trace.program = spans.by_program_span(evs, t0, t1, run.spans, self.recorded)
        lost = spans.lost_launches(evs, run.counters)
        del evs
        self.report(run, prog, lost)

    def report(self, run, prog, lost) -> None:
        log = self.log
        names = sorted(set(prog.device_incl_s) | set(prog.idle_incl_s),
                       key=lambda n: -prog.device_incl_s.get(n, 0.0))
        log("spans: by program span, device s (innermost / with what runs inside), idle s "
            "(innermost / with what runs inside): " + "; ".join(
                f"{n} {prog.device_s.get(n, 0.0):.6f} / {prog.device_incl_s.get(n, 0.0):.6f}, "
                f"idle {prog.idle_s.get(n, 0.0):.6f} / {prog.idle_incl_s.get(n, 0.0):.6f}"
                for n in names))
        log("spans: under no program span, by harness span: device s "
            + ", ".join(f"{n} {s:.6f}" for n, s in sorted(prog.harness_device_s.items()))
            + "; idle s " + ", ".join(f"{n} {s:.6f}" for n, s in
                                      sorted(prog.harness_idle_s.items(), key=lambda x: -x[1])))
        op = max(prog.op_s, 1e-12)
        log(f"spans: of {prog.op_s:.6f} s of device operations, mapped through their launch "
            f"{100 * prog.direct_s / op:.4f}%, by stream order {100 * prog.by_stream_s / op:.4f}%,"
            f" unmapped {100 * prog.unmapped_s / op:.4f}%; under a program span "
            f"{100 * sum(prog.device_s.values()) / op:.4f}%")
        for layer, parts in (("detector", ("detect", "select")), ("matcher", ("match", "extract"))):
            a = sum(prog.device_incl_s.get(p, 0.0) for p in parts)
            b = run.trace.layer_s.get(layer, 0.0)
            log(f"spans: {layer} s: {a:.6f} under {' + '.join(parts)}, {b:.6f} by name "
                f"(layers/{layer}.json), difference {a - b:+.6f}")
        for wrappers, want, got in lost:
            log(f"launches: {wrappers}: {want} kernels from counted launches, {got} in the "
                f"trace, {want - got} lost ({100.0 * (want - got) / want:.4f}%)")


class SpanManifest:
    """A ``Manifest`` whose cells open the recording over the window and
    whose per-layer metrics include ``SPAN_METRICS``; the rest is the
    manifest's own."""

    def __init__(self, base, span_run: SpanRun):
        self.base, self.span_run = base, span_run

    def __getattr__(self, name):
        return getattr(self.base, name)

    def entry(self, name):
        from superslam_tpu_torch.utils import profiler

        span_run = self.span_run
        mod = self.base.entry(name)

        class Entry(mod.Entry):
            def run(self, t_end):
                span_run.t_end = t_end
                profiler.start_recording()
                return super().run(t_end)

            def finish(self):
                try:
                    super().finish()
                finally:
                    span_run.recorded = profiler.stop_recording()

        out = types.ModuleType(mod.__name__)
        out.__dict__.update(mod.__dict__)
        out.Entry = Entry
        return out

    def per_layer(self, workload):
        return self.base.per_layer(workload) + SPAN_METRICS

    def reader(self, metric):
        mod = self.base.reader(metric)
        if metric not in {m["name"] for m in SPAN_METRICS}:
            return mod

        def read(run):
            self.span_run.attach(run)
            return mod.read(run)

        return types.SimpleNamespace(read=read)


def trace_cell(workload: str, seed: int, seconds: float, trace_on: bool, device, t_start: float,
               root=None, bench_dir=HERE, log=print):
    """``harness.run_cell`` with the recording; returns (result, SpanRun)."""
    from slambench import devtrace
    from slambench.harness import run_cell
    from slambench.manifest import Manifest

    span_run = SpanRun(seconds, log)
    man = SpanManifest(Manifest(root, bench_dir), span_run)
    real = devtrace.profiler
    with mock.patch.object(devtrace, "profiler", lambda: span_run.keep(real())):
        result = run_cell(workload, seed, seconds, trace_on, device, t_start, manifest=man,
                          log=log)
    return result, span_run


def scope_cost(n: int, log) -> None:
    from superslam_tpu_torch.utils import profiler

    def per_scope() -> float:
        scope = profiler.profile_scope
        t = time.perf_counter_ns()
        for _ in range(n):
            with scope("x"):
                pass
        return (time.perf_counter_ns() - t) / n * 1e-3

    def empty() -> float:
        t = time.perf_counter_ns()
        for _ in range(n):
            pass
        return (time.perf_counter_ns() - t) / n * 1e-3

    was = profiler.Profiler.enabled()
    profiler.set_enabled(False)
    off, bare = per_scope(), empty()
    profiler.set_enabled(True)
    on = per_scope()
    profiler.set_enabled(False)
    acc = profiler.Profiler.instance()
    with acc._lock:
        acc._acc.pop("x", None)
    profiler.start_recording()
    rec = per_scope()
    profiler.stop_recording()
    profiler.set_enabled(was)
    log(f"scope cost, us a scope over {n} (an empty loop's pass {bare:.4f} us included): "
        f"off {off:.4f}, accumulator on {on:.4f}, recording {rec:.4f}; host: "
        f"{os.cpu_count()} cores, Python {sys.version.split()[0]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--scope-cost", type=int, default=0)
    args = ap.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    if args.scope_cost:
        scope_cost(args.scope_cost, log)
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        ap.error("--workload, --seed and --seconds are required for a run")

    import torch

    from slambench.harness import forbidden_modules

    if not torch.cuda.is_available():
        log("no result: the traced run needs a CUDA device")
        return 2
    import superslam_tpu_torch  # noqa: F401

    result, _ = trace_cell(args.workload, args.seed, args.seconds, True, torch.device("cuda", 0),
                           T_START, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"no result: the process loaded {', '.join(bad)}")
        return 3
    for k, v in result["checks"].items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
