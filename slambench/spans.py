"""The program's spans on the device trace: each device operation and each
idle gap put down to the span of the port that issued it.

The port records spans with ``superslam_tpu_torch/utils/profiler.py``
(``start_recording`` .. ``stop_recording``): ``(name, start ns, end ns,
parent, root, thread)`` on ``time.time_ns()``, the clock of the profiler's
events. The profiler's CUDA activity holds, beside each device operation,
CUPTI's record of the runtime call that launched it (``cudaLaunchKernel``,
``cudaLaunchKernelExC``, ``cudaMemcpyAsync``, ...): a host event with the
operation's correlation id, its host start and the launching thread (the
low 32 bits of its ``threading.get_ident()``, as ``device_resource_id()``).
So an operation belongs to the innermost program span, on the launching
thread, that holds its launch's start. No profiler activity beyond the
harness's ``devtrace.profiler()`` is needed.

Fallbacks: an operation launched under no program span goes to the harness
span holding its launch (``outside`` under none); one with no launch record
takes the span of the nearest mapped operation before it on its stream.
Idle time goes to the innermost program span open over it, else to the
harness span as ``devtrace.idle_by_span`` puts it.
"""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field

# The port's kernel wrappers (``ops/cuda/_build.py::KERNELS``) by the
# kernels each launch makes, and those kernels' names in the trace.
# Wrappers that share a kernel are one group. PyTorch has gather kernels of
# its own (``vectorized_gather_kernel``), hence the anchored pattern.
LAUNCH_GROUPS = (
    ({"conv1a1b": 1, "conv1a1b_full": 1}, r"conv_pair_mma_kernel<1\b"),
    ({"conv_pair": 1, "conv_pair_full": 1}, r"conv_pair_mma_kernel<64\b"),
    ({"conv3x3": 1}, r"conv3x3_(mma|gray)_kernel"),
    ({"nms": 1}, r"nms_tile_kernel<false>"),
    ({"scores_nms": 1}, r"nms_tile_kernel<true>"),
    ({"gather_normalize": 1}, r"^void \(anonymous namespace\)::gather_kernel<"),
    ({"fused_self_block": 3, "fused_cross_block": 3, "masked_attention": 1},
     r"(proj|tail)_(mma|f32)_kernel|attn_fwd_(bf16|f32)_kernel"),
    ({"masked_attention_bwd": 2}, r"attn_bwd_(dkv|dq)_kernel"),
    ({"pose_solve": 1}, r"pose_solve_kernel"),
    ({"track_frame": 1, "track_frame_batched": 1}, r"track_frame_kernel"),
)


def thread32(ident: int) -> int:
    """A thread identifier as CUPTI's launch records carry it: the low 32
    bits, signed."""
    return ((ident & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def events(prof) -> list:
    return list(prof.profiler.kineto_results.events())


def _split(evs):
    """(device operations as (name, start, end, correlation, stream), launch
    records by correlation id as (host start, thread))."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, launches = [], {}
    for e in evs:
        if e.device_type() == cuda:
            a = e.start_ns()
            ops.append((e.name(), a, a + e.duration_ns(),
                        e.correlation_id() or e.linked_correlation_id(), e.device_resource_id()))
        elif e.name().startswith("cu"):
            c = e.correlation_id() or e.linked_correlation_id()
            if c and c not in launches:
                launches[c] = (e.start_ns(), thread32(e.device_resource_id()))
    ops.sort(key=lambda o: o[1])
    return ops, launches


@dataclass
class SpanTrace:
    """Device and idle seconds of a traced window by the span that issued
    them. ``*_s`` dicts are keyed by program span name; ``*_incl_s`` count
    each operation once under every distinct name on its span's chain;
    ``harness_*`` hold what fell under no program span, by harness span
    name or ``outside``."""

    window_s: float
    op_s: float = 0.0  # device operations' seconds in the window, summed
    device_s: dict = field(default_factory=dict)
    device_incl_s: dict = field(default_factory=dict)
    harness_device_s: dict = field(default_factory=dict)
    idle_s: dict = field(default_factory=dict)
    idle_incl_s: dict = field(default_factory=dict)
    harness_idle_s: dict = field(default_factory=dict)
    direct_s: float = 0.0  # mapped through the operation's own launch record
    by_stream_s: float = 0.0  # mapped through the operation before it on its stream
    unmapped_s: float = 0.0


def _innermost(spans, threads):
    """A function (time ns, thread) -> index of the innermost program span
    on that thread holding the time, or -1. Spans on one thread nest."""
    import bisect

    by_thread: dict[int, tuple[list, list]] = {}
    for i, s in enumerate(spans):
        starts, idx = by_thread.setdefault(threads[i], ([], []))
        starts.append(s[1])
        idx.append(i)

    def find(t: int, thread: int) -> int:
        got = by_thread.get(thread)
        if got is None:
            return -1
        starts, idx = got
        k = bisect.bisect_right(starts, t) - 1
        i = idx[k] if k >= 0 else -1
        while i >= 0 and spans[i][2] < t:
            i = spans[i][3]
        return i

    return find


def _harness_at(harness_spans):
    """A function time ns -> the harness span holding it, or ``outside``.
    The harness's spans are sequential (one host thread)."""
    import bisect

    hs = sorted(harness_spans, key=lambda s: s[1])
    starts = [s[1] for s in hs]

    def find(t: int) -> str:
        k = bisect.bisect_right(starts, t) - 1
        return hs[k][0] if k >= 0 and hs[k][2] > t else "outside"

    return find


def _chain_names(spans, i):
    names = []
    while i >= 0:
        if spans[i][0] not in names:
            names.append(spans[i][0])
        i = spans[i][3]
    return names


def _add(d: dict, k, v: float) -> None:
    d[k] = d.get(k, 0.0) + v


def by_program_span(evs, t0: int, t1: int, harness_spans, program_spans) -> SpanTrace:
    """Put the window's device operations and idle gaps down to spans.
    ``evs``: the profiler's events (``events(prof)``); ``harness_spans``:
    ``(name, start, end)``; ``program_spans``: the recording's tuples with
    indices into that list."""
    from slambench.devtrace import gaps, union

    spans = list(program_spans)
    threads = [thread32(s[5]) for s in spans]
    innermost = _innermost(spans, threads)
    harness = _harness_at(harness_spans)
    ops, launches = _split(evs)
    tr = SpanTrace(window_s=(t1 - t0) * 1e-9)

    last_on_stream: dict = {}  # stream -> (span index, harness name) of its last mapped op
    clipped = []
    for name, a, b, corr, stream in ops:
        rec = launches.get(corr)
        if rec is not None:
            where = (innermost(rec[0], rec[1]), harness(rec[0]))
            last_on_stream[stream] = where
            how = "direct"
        else:
            where = last_on_stream.get(stream)
            how = "by_stream" if where is not None else "unmapped"
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        clipped.append((name, a, b))
        s = (b - a) * 1e-9
        tr.op_s += s
        if how == "unmapped":
            tr.unmapped_s += s
            continue
        if how == "direct":
            tr.direct_s += s
        else:
            tr.by_stream_s += s
        i, hname = where
        if i >= 0:
            _add(tr.device_s, spans[i][0], s)
            for n in _chain_names(spans, i):
                _add(tr.device_incl_s, n, s)
        else:
            _add(tr.harness_device_s, hname, s)

    _idle(tr, gaps(union(clipped), t0, t1), spans, harness_spans)
    return tr


def _idle(tr: SpanTrace, idle, spans, harness_spans) -> None:
    """Idle seconds under the innermost program span open over them (the
    deepest; on a tie the latest started), else under the harness span."""
    depth = []
    for s in spans:
        depth.append(0 if s[3] < 0 else depth[s[3]] + 1)
    order = sorted(range(len(spans)), key=lambda i: spans[i][1])
    harness = _harness_at(harness_spans)
    # Segments between every boundary lie wholly inside a gap or outside.
    bounds = sorted({t for a, b in idle for t in (a, b)}
                    | {t for s in spans for t in (s[1], s[2])}
                    | {t for s in harness_spans for t in (s[1], s[2])})
    heap: list = []  # the spans opened so far, innermost first; closed ones dropped lazily
    j = g = 0
    for p, q in zip(bounds, bounds[1:]):
        while j < len(order) and spans[order[j]][1] <= p:
            i = order[j]
            heapq.heappush(heap, (-depth[i], -spans[i][1], i))
            j += 1
        while g < len(idle) and idle[g][1] <= p:
            g += 1
        if g == len(idle):
            break
        if idle[g][0] > p:
            continue
        while heap and spans[heap[0][2]][2] <= p:
            heapq.heappop(heap)
        s = (q - p) * 1e-9
        if heap:
            i = heap[0][2]
            _add(tr.idle_s, spans[i][0], s)
            for n in _chain_names(spans, i):
                _add(tr.idle_incl_s, n, s)
        else:
            _add(tr.harness_idle_s, harness(p), s)


def lost_launches(evs, counters: dict) -> list[tuple[str, int, int]]:
    """For each group of ``LAUNCH_GROUPS`` with launches counted: (its
    wrappers, the kernels their counted launches make, the kernels of
    those names in the whole trace)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name() for e in evs if e.device_type() == cuda]
    out = []
    for per, pattern in LAUNCH_GROUPS:
        want = sum(counters.get(w, 0) * k for w, k in per.items())
        if want == 0:
            continue
        rx = re.compile(pattern)
        out.append(("+".join(w for w in per if counters.get(w, 0)), want,
                    sum(1 for n in names if rx.search(n))))
    return out
