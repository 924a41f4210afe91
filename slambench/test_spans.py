"""The program's spans on the device trace (``spans.py``), their five
readers, and a tiny CPU run of each cell with the recording open
(``trace_spans.py``): ``python -m pytest slambench -q`` from the root."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from slambench import harness, spans
from slambench.devtrace import Trace
from slambench.manifest import Manifest
from slambench.test_slambench import ROOT, TINY, _tiny_checkout
from slambench.trace_spans import SPAN_METRICS, inside, trace_cell

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
MAIN, OTHER = 0x7F00_1234_5000, 0x7F00_9876_6000  # two threads' get_ident()


class Ev:
    """A stand-in of the profiler's event."""

    def __init__(self, dev, name, start, dur, corr, res, linked=0):
        self.v = (dev, name, start, dur, corr, res, linked)

    def device_type(self):
        return self.v[0]

    def name(self):
        return self.v[1]

    def start_ns(self):
        return self.v[2]

    def duration_ns(self):
        return self.v[3]

    def correlation_id(self):
        return self.v[4]

    def device_resource_id(self):
        return self.v[5]

    def linked_correlation_id(self):
        return self.v[6]


def launch(t, corr, thread=MAIN, name="cudaLaunchKernel"):
    return Ev(CPU, name, t, 2, corr, spans.thread32(thread))


def op(name, a, b, corr, stream=7, linked=0):
    return Ev(CUDA, name, a, b - a, corr, stream, linked)


# Program spans: (name, start, end, parent, root, thread); harness spans
# (name, start, end). The window is [0, 100].
PROGRAM = [
    ("upload", 0, 20, -1, 0, MAIN),            # 0
    ("upload.prepare", 2, 15, 0, 0, MAIN),     # 1
    ("upload.copy", 15, 18, 0, 0, MAIN),       # 2
    ("step", 30, 60, -1, 3, MAIN),             # 3
    ("detect", 31, 40, 3, 3, MAIN),            # 4
    ("match", 40, 55, 3, 3, MAIN),             # 5
    ("match.assign", 50, 54, 5, 3, MAIN),      # 6
    ("loop", 10, 50, -1, 7, OTHER),            # 7 (another thread)
]
HARNESS = [("prep_upload", 0, 25), ("issue", 28, 62), ("kf_write", 70, 80)]


def synthetic():
    return [
        launch(16, 1), op("Memcpy HtoD (Pinned -> Device)", 20, 26, 1),
        launch(32, 2), op("conv_pair_mma_kernel<1, bf16>", 33, 45, 2),
        op("elementwise_kernel", 45, 47, 0),  # no launch record: by stream order
        launch(45, 3), op("proj_mma_kernel", 47, 58, 3),
        launch(52, 4, name="cudaLaunchKernelExC"), op("softmax", 58, 61, 4),
        launch(41, 5, thread=OTHER), op("mystery", 61, 63, 5, stream=9),  # under "loop"
        launch(72, 6), op("Memcpy DtoD", 72, 75, 6),  # under no program span
        launch(85, 7), op("late", 95, 110, 0, linked=7),  # linked id; clipped at 100
        op("orphan", 90, 92, 0, stream=11),  # no launch and nothing before it on its stream
        Ev(CPU, "Runtime Triggered Module Loading", 10, 1, 2, 0),  # not a launch
    ]


def test_by_program_span_maps_operations_and_idle():
    tr = spans.by_program_span(synthetic(), 0, 100, HARNESS, PROGRAM)
    ns = 1e-9
    assert tr.window_s == pytest.approx(100 * ns)
    # launch 16 lies in upload.copy; launch 32 in detect; the untraced
    # elementwise follows the conv on stream 7; 45 in match; 52 in
    # match.assign; the other thread's launch at 41 in its own "loop", not
    # in this thread's match.
    assert tr.device_s == pytest.approx({"upload.copy": 6 * ns, "detect": 14 * ns,
                                         "match": 11 * ns, "match.assign": 3 * ns,
                                         "loop": 2 * ns})
    assert tr.device_incl_s == pytest.approx({
        "upload.copy": 6 * ns, "upload": 6 * ns, "detect": 14 * ns, "step": 28 * ns,
        "match": 14 * ns, "match.assign": 3 * ns, "loop": 2 * ns})
    # the DtoD copy under the harness's kf_write; the late op at 85: outside
    assert tr.harness_device_s == pytest.approx({"kf_write": 3 * ns, "outside": 5 * ns})
    assert tr.op_s == pytest.approx((6 + 12 + 2 + 11 + 3 + 2 + 3 + 5 + 2) * ns)
    assert tr.direct_s == pytest.approx((6 + 12 + 11 + 3 + 2 + 3 + 5) * ns)
    assert tr.by_stream_s == pytest.approx(2 * ns)
    assert tr.unmapped_s == pytest.approx(2 * ns)
    # Busy: [20, 26], [33, 63], [72, 75], [90, 92], [95, 100]. Idle, by the
    # deepest open span (on a tie the latest started): 0-2 upload, 2-15
    # upload.prepare (above the other thread's "loop" from 10), 15-18
    # upload.copy, 18-20 "loop" (started after "upload"), 26-30 "loop",
    # 30-31 step, 31-33 detect; then no program span: 63-70 outside, 70-72
    # and 75-80 kf_write, 80-90 and 92-95 outside.
    assert tr.idle_s == pytest.approx({"upload": 2 * ns, "upload.prepare": 13 * ns,
                                       "upload.copy": 3 * ns, "loop": 6 * ns, "step": 1 * ns,
                                       "detect": 2 * ns})
    assert tr.idle_incl_s == pytest.approx({"upload": 18 * ns, "upload.prepare": 13 * ns,
                                            "upload.copy": 3 * ns, "loop": 6 * ns,
                                            "step": 3 * ns, "detect": 2 * ns})
    assert tr.harness_idle_s == pytest.approx({"outside": 20 * ns, "kf_write": 7 * ns})
    idle = sum(tr.idle_s.values()) + sum(tr.harness_idle_s.values())
    assert idle + (6 + 30 + 3 + 2 + 5) * ns == pytest.approx(100 * ns)


def test_lost_launches_by_wrapper_group():
    evs = [op("void (anonymous namespace)::conv_pair_mma_kernel<1, __nv_bfloat16>(x)", 0, 1, 1),
           op("void (anonymous namespace)::conv_pair_mma_kernel<64, __nv_bfloat16>(x)", 1, 2, 2),
           op("proj_mma_kernel", 2, 3, 3), op("attn_fwd_bf16_kernel", 3, 4, 4),
           op("tail_mma_kernel", 4, 5, 5), launch(0, 1),
           op("void (anonymous namespace)::gather_kernel<__nv_bfloat16>(x)", 5, 6, 6),
           op("void at::native::vectorized_gather_kernel<16, long>(x)", 6, 7, 7)]
    got = spans.lost_launches(evs, {"conv1a1b": 2, "conv_pair": 1, "fused_self_block": 1,
                                    "fused_cross_block": 1, "nms": 0, "gather_normalize": 1})
    assert got == [("conv1a1b", 2, 1), ("conv_pair", 1, 1), ("gather_normalize", 1, 1),
                   ("fused_self_block+fused_cross_block", 6, 3)]


def test_inside_renumbers_the_window():
    got = inside(PROGRAM, 25, 60)
    assert [s[0] for s in got] == ["step", "detect", "match", "match.assign"]
    assert [(s[3], s[4]) for s in got] == [(-1, 0), (0, 0), (0, 0), (2, 0)]
    assert inside(PROGRAM, 31, 60)[0][:2] == ("detect", 31)  # its parent left out
    assert inside(PROGRAM, 31, 60)[0][3:5] == (-1, -1)


def test_the_five_readers_on_a_synthetic_run():
    man = Manifest()
    cfg = man.config("kitti00-stereo")
    tr = Trace(window_s=10.0, busy_s=8.0, layer_s={"detector": 4.0, "matcher": 3.5})
    prog = spans.SpanTrace(window_s=10.0)
    prog.device_incl_s = {"step": 7.8, "detect": 3.5, "select": 0.5, "match": 3.2,
                          "extract": 0.1, "upload": 0.1}
    prog.idle_s = {"upload.prepare": 1.5, "upload.wait": 0.01, "detect": 0.02}
    prog.idle_incl_s = {"upload.prepare": 1.5, "upload": 1.6, "step": 0.12, "detect": 0.02}
    tr.program = prog
    run = harness.Run(cfg, {}, "kitti00-stereo.fleet16", 10.0, 250, 4000, [1.0], 9.5,
                      [], {}, {}, 700.0, tr)
    run.program_spans = ([("upload", 0, 9_000_000, -1, 0, 1),
                          ("upload.prepare", 1_000_000, 7_000_000, 0, 0, 1),
                          ("step", 9_000_000, 20_000_000, -1, 2, 1)] * 4)
    got = {m["name"]: man.reader(m["name"]).read(run) for m in SPAN_METRICS}
    assert got["prepare_ms"] == pytest.approx(6.0)
    assert got["prepare_idle_pct"] == pytest.approx(15.0)
    assert got["issue_idle_pct"] == pytest.approx(1.2)
    assert got["detector_device_ms"] == pytest.approx(16.0)
    assert got["matcher_device_ms"] == pytest.approx(13.2)
    # Silent on a run whose program records no spans (the parent's), and
    # on an untraced one.
    bare = harness.Run(cfg, {}, "x", 10.0, 250, 4000, [1.0], 1.0, [], {}, {}, None,
                       Trace(10.0, 8.0))
    assert all(man.reader(m["name"]).read(bare) is None for m in SPAN_METRICS)



def test_prepare_ms_counts_a_nested_step_once():
    """The device-tracked RGB-D step opens the front end's ``step`` inside
    its own: one dispatch, one step."""
    man = Manifest()
    cfg = man.config("tum1-rgbd")
    run = harness.Run(cfg, {}, "tum1-rgbd.batch16", 10.0, 250, 4000, [1.0], 9.5,
                      [], {}, {}, 700.0, Trace(10.0, 8.0))
    run.program_spans = [("upload", 0, 4_000_000, -1, 0, 1),
                         ("upload.prepare", 1_000_000, 3_000_000, 0, 0, 1),
                         ("step", 5_000_000, 20_000_000, -1, 2, 1),
                         ("step", 5_500_000, 15_000_000, 2, 2, 1),
                         ("detect", 6_000_000, 9_000_000, 3, 2, 1),
                         ("track", 16_000_000, 19_000_000, 2, 2, 1)]
    assert man.reader("prepare_ms").read(run) == pytest.approx(2.0)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from slambench import render

    root = _tiny_checkout(str(tmp_path_factory.mktemp("checkout")))
    saved = render.CACHE_DIR
    render.CACHE_DIR = os.path.join(root, "cache")
    yield root
    render.CACHE_DIR = saved


CPU_SPANS = {"upload", "upload.prepare", "step", "detect", "select", "match", "match.assign",
             "extract", "pack"}


@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_tiny_run_records_the_programs_spans(tiny, workload):
    """The recording opened and stopped as a traced run opens it, on the
    CPU path (whose profiler has no CUDA activity to trace)."""
    result, run = trace_cell(workload, 20260, 4.0, False, torch.device("cpu"), time.monotonic(),
                             root=tiny, bench_dir=os.path.join(tiny, "slambench"),
                             log=lambda s: None)
    assert result["correct"]
    names = {s[0] for s in run.recorded}
    assert names == CPU_SPANS, names
    steps = [s for s in run.recorded if s[0] == "step"]
    assert steps and all(s[3] == -1 for s in steps)
    uploads = sum(1 for s in run.recorded if s[0] == "upload")
    per_step = TINY[workload][4].get("batch", 1)
    assert uploads >= per_step * (len(steps) - 1)


def test_a_run_prints_nothing_after_its_result_line(tmp_path):
    root = _tiny_checkout(str(tmp_path))
    code = (
        "import sys, time, json, torch\n"
        f"sys.path.insert(0, {root!r}); sys.path.insert(1, {ROOT!r})\n"
        "from slambench import render\n"
        "from slambench.trace_spans import trace_cell\n"
        f"render.CACHE_DIR = {os.path.join(root, 'cache')!r}\n"
        "result, run = trace_cell('tiny.stereo', 5, 3.0, False, torch.device('cpu'), "
        f"time.monotonic(), root={root!r}, bench_dir={os.path.join(root, 'slambench')!r}, "
        "log=lambda s: None)\n"
        "assert run.recorded\n"
        "print(json.dumps(result))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "SUPERSLAM_PROFILE"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**env, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
