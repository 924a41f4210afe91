"""The traced run: the profiler's device operations reduced to the numbers
the per-layer readers take.

The profiler records the card's activity only (kernels, copies, fills);
the harness's own host spans are ``time.time_ns()`` intervals, on the
profiler's clock (both are the host's real-time clock in ns). Every
device operation is attributed to a layer by the name patterns of
``layers/*.json``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def profiler():
    import torch

    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


def device_ops(prof, t0: int, t1: int) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device operation, clipped to the
    window [t0, t1], in start order."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        a, b = max(a, t0), min(b, t1)
        if b > a:
            out.append((e.name(), a, b))
    out.sort(key=lambda o: o[1])
    return out


def union(ops) -> list[tuple[int, int]]:
    """Merged busy intervals of operations in start order."""
    merged: list[list[int]] = []
    for _n, a, b in ops:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def gaps(busy, t0: int, t1: int) -> list[tuple[int, int]]:
    out, cur = [], t0
    for a, b in busy:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        out.append((cur, t1))
    return out


def idle_by_span(idle, spans) -> dict[str, float]:
    """Seconds of device idleness under each host span name; what no span
    covers is ``outside``. Spans are sequential (one host thread)."""
    spans = sorted(spans, key=lambda s: s[1])
    out: dict[str, float] = {}
    j = 0
    for a, b in idle:
        covered = 0
        while j < len(spans) and spans[j][2] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][1] < b:
            name, sa, sb = spans[k]
            ov = min(b, sb) - max(a, sa)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov * 1e-9
                covered += ov
            k += 1
        if b - a > covered:
            out["outside"] = out.get("outside", 0.0) + (b - a - covered) * 1e-9
    return out


def attribute(ops, layers) -> list[str | None]:
    """The layer of each operation: the first named layer whose patterns
    match its name; an operation of a ``follows_preceding`` layer takes the
    layer of the nearest named operation before it."""
    named = [ly for ly in layers if not ly.get("follows_preceding")]
    follow = [ly for ly in layers if ly.get("follows_preceding")]
    out: list[str | None] = []
    last = None
    for name, _a, _b in ops:
        hit = next((ly["layer"] for ly in named if ly["regex"].search(name)), None)
        if hit is not None:
            if hit != "transfer":
                last = hit
            out.append(hit)
        elif any(ly["regex"].search(name) for ly in follow):
            out.append(last if last is not None else follow[0]["layer"])
        else:
            out.append(None)
    return out


@dataclass
class Trace:
    window_s: float
    busy_s: float
    layer_s: dict = field(default_factory=dict)  # seconds of device time by layer
    unattributed_s: float = 0.0
    unattributed: dict = field(default_factory=dict)  # name -> seconds
    top_ops: list = field(default_factory=list)  # [name, seconds], the 10 longest in sum
    idle_gaps: list = field(default_factory=list)  # [span name, seconds], the 10 longest in sum
    n_ops: int = 0


def reduce(prof, t0: int, t1: int, spans, layers) -> Trace:
    ops = device_ops(prof, t0, t1)
    busy = union(ops)
    tr = Trace(window_s=(t1 - t0) * 1e-9, busy_s=sum(b - a for a, b in busy) * 1e-9, n_ops=len(ops))
    by_name: dict[str, float] = {}
    for (name, a, b), layer in zip(ops, attribute(ops, layers)):
        s = (b - a) * 1e-9
        by_name[name] = by_name.get(name, 0.0) + s
        if layer is None:
            tr.unattributed_s += s
            tr.unattributed[name] = tr.unattributed.get(name, 0.0) + s
        else:
            tr.layer_s[layer] = tr.layer_s.get(layer, 0.0) + s
    tr.top_ops = [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:10]]
    idle = idle_by_span(gaps(busy, t0, t1), spans)
    tr.idle_gaps = [[n, s] for n, s in sorted(idle.items(), key=lambda x: -x[1])[:10]]
    return tr
