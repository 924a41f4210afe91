"""One run of one cell: set-up, the measured window, the check, the result.

``run.py`` is the command line; ``run_cell`` is everything after its look
for a card, so the tests drive it on the CPU at a tiny size.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from slambench import compare, flops, render
from slambench.manifest import Manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "superslam_tpu")


@dataclass
class Context:
    """What an entry (``entries/<entry>.py::Entry``) is built from."""

    config: dict
    traffic: dict
    device: object
    seed: int
    frames: np.ndarray  # (frames, views, h, w) uint8, the seed's noise added
    rng: np.random.Generator
    sp_params: dict
    matcher: object  # the configuration's matcher module (``matchers/<matcher>.py``)
    matcher_params: dict  # its ``load``: the parameters handed to the port
    spans: list = field(default_factory=list)  # (name, start ns, end ns)

    @contextlib.contextmanager
    def span(self, name: str):
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, a, time.time_ns()))


@dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py::read(run)``): the
    end-to-end ones in a run with ``--trace 0``, the per-layer ones with
    ``--trace 1`` (``trace`` is None without)."""

    config: dict
    traffic: dict
    workload: str
    seconds: float  # the window's length
    steps: int  # dispatches whose results reached the host inside the window
    frames: int  # stream-frames in them
    latencies_ms: list  # each such dispatch's, from its images handed over to its block on the host
    setup_s: float  # process start to the first timed step
    spans: list  # (name, start ns, end ns) host spans of the harness inside the window
    work: dict  # flops.window_work of the dispatches completed inside the window
    counters: dict  # the program's kernel launches inside the window, by wrapper
    power_limit_w: float | None
    trace: object = None  # devtrace.Trace


def add_noise(frames: np.ndarray, sigma: float, seed: int, device) -> np.ndarray:
    """The rendered arc with the seed's sensor noise (N(0, sigma) gray
    levels, rounded and clipped), drawn on the device in one call."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    x = torch.as_tensor(frames).to(device)
    noise = torch.randn(x.shape, generator=gen, device=device, dtype=torch.float32) * sigma
    return torch.clamp(torch.round(x.float() + noise), 0, 255).to(torch.uint8).cpu().numpy()


def load_models(config: dict, matcher, root: str, device):
    """The committed checkpoints, read by the benchmark (safetensors, f32):
    SuperPoint's and the matcher's."""
    from slambench.reference import load_weights

    return (load_weights(os.path.join(root, config["superpoint"]["checkpoint"]), device),
            matcher.load(config, root, device))


def check_reference(config: dict, matcher, root: str, device, precision: str = "f32"):
    """The check's reference: SuperPoint's features and the matcher's
    reference, both at ``precision`` (``"fp8"``: the control)."""
    from slambench.reference import Reference

    return Reference(os.path.join(root, config["superpoint"]["checkpoint"]),
                     matcher.Reference(config, root, device, precision), device, precision)


def power_limit() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _launch_counts(on_card: bool) -> dict:
    """The port's per-wrapper kernel launch counters (``ops/cuda/_build.py``)."""
    if not on_card:
        return {}
    from superslam_tpu_torch.ops.cuda import _build

    return _build.launch_counts()


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, device, t_start: float,
             manifest: Manifest | None = None, log=print, control=None):
    """One run. Returns the result dict (the contract's last line).
    ``control`` (calibration and tests only): a callable that takes the
    run's units and returns the units to judge in the program's place."""
    import torch

    from slambench import devtrace

    man = manifest or Manifest()
    cell = man.workload(workload)
    cfg = man.config(cell["config"])
    matcher = man.matcher(cfg.get("matcher"))
    tr = man.traffic(cell["traffic"])
    limits = man.limits(workload)
    entry_mod = man.entry(tr["entry"])
    on_card = device.type == "cuda"

    arc, cached = render.frame_set(cfg, entry_mod.VIEWS)
    log(f"frame cache: {'hit' if cached else 'rendered'}, {render.cache_bytes()} bytes in "
        f"{render.CACHE_DIR}")
    frames = add_noise(arc, cfg["assumed"]["noise_sigma"], seed, device)
    sp, mp = load_models(cfg, matcher, man.root, device)
    ctx = Context(cfg, tr, device, seed, frames, np.random.default_rng([seed, 0x0FF5]), sp,
                  matcher, mp)
    entry = entry_mod.Entry(ctx)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    entry.warm(tr["warm_steps"])
    setup_s = time.monotonic() - t_start
    ctx.spans.clear()

    launches = _launch_counts(on_card)
    prof = devtrace.profiler() if trace_on else None
    if prof is not None:
        prof.start()
    t0 = time.time_ns()
    t_end = t0 + int(seconds * 1e9)
    done, dispatched = entry.run(t_end)
    entry.finish()
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = {k: v - launches.get(k, 0) for k, v in _launch_counts(on_card).items()}
    if not done:
        raise RuntimeError("no dispatch completed inside the window")
    latencies = [(b - a) * 1e-6 for a, b in done]
    run = Run(cfg, tr, workload, seconds, len(done), len(done) * entry.frames_per_step, latencies,
              setup_s, [s for s in ctx.spans if s[1] >= t0 and s[2] <= t_end],
              flops.window_work(cfg, matcher, entry.window_work()), launches,
              power_limit() if on_card else None)
    log(f"window: {run.steps} dispatches, {run.frames} stream-frames, {dispatched} frames "
        f"dispatched; step latency median {np.median(latencies):.4f} ms, p95 over "
        f"{len(latencies)} samples; card power limit {run.power_limit_w} W")

    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    breakdown = None
    if trace_on:
        run.trace = tr_sum = devtrace.reduce(prof, t0, t_end, run.spans, man.layers())
        run.seconds = tr_sum.window_s
        del prof
        log(f"trace: {tr_sum.n_ops} device operations, busy {tr_sum.busy_s:.6f} s of "
            f"{tr_sum.window_s:.6f} s; by layer (s): "
            + ", ".join(f"{k} {v:.6f}" for k, v in sorted(tr_sum.layer_s.items()))
            + f"; unattributed {tr_sum.unattributed_s:.6f} s "
            f"({100.0 * tr_sum.unattributed_s / max(tr_sum.busy_s, 1e-12):.4f}% of busy)")
        for name, s in sorted(tr_sum.unattributed.items(), key=lambda x: -x[1])[:10]:
            log(f"  unattributed {s:.6f} s: {name[:160]}")
        device_info["busy_s"] = tr_sum.busy_s
        device_info["window_s"] = tr_sum.window_s
        breakdown = {"device_ops": tr_sum.top_ops, "idle_gaps": tr_sum.idle_gaps}
    metrics = {}
    for m in man.per_layer(workload) if trace_on else man.end_to_end(workload):
        v = man.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # The check runs once the window has closed and the peak is read, with
    # the program's state freed.
    units = entry.units()
    n_sampled = len(entry.sample.items)
    entry.release()
    del entry
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    ref = check_reference(cfg, matcher, man.root, device)
    judged = control(units) if control is not None else units
    judge = getattr(entry_mod, "judge", compare.judge)
    numbers = judge(judged, ref, cfg) if judged else {}
    correct = bool(units) and compare.verdict(numbers, limits)
    if units:
        valid = [int((u.packed[0] >= 0).sum()) for u in units]
        log(f"keypoints a sampled frame: mean {np.mean(valid):.1f}, min {min(valid)} "
            f"of K {cfg['superpoint']['max_keypoints']}")
    log(f"check: {len(units)} stream-frames of {n_sampled} sampled dispatches, "
        f"{time.monotonic() - t_check:.3f} s")

    result = {
        "correct": correct,
        "attempted": int(dispatched),
        "failed": 0,
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    return result
