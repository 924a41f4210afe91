"""Host scopes: the label accumulator and the span recording.

Equivalent of the reference Profiler (``include/Profiling.h:14-74``):
``profile_scope(label)`` times a block. Under ``SUPERSLAM_PROFILE=1`` (read
once at import; ``set_enabled`` switches it later) the time goes to a
lock-guarded map of label -> (total_ms, n), dumped at exit. Scope labels
preserve the reference's names (sp_extract_stereo, sp_gpu_infer,
fe_extract_stereo, fe_lg_stereo_match, vo_track_total, vo_lg_track_match,
vo_gtsam_optimize, ws_rebuild, ws_solve) for comparability.

While a recording is open (``start_recording`` .. ``stop_recording``),
every scope also becomes a span ``(name, start_ns, end_ns, parent, root,
thread)``, whatever ``SUPERSLAM_PROFILE`` says: times from
``time.time_ns()`` (the clock of the profiler's device trace), ``parent``
the index of the enclosing span on the same thread (-1 for none), ``root``
the index of its outermost one (its own index for an outermost span), and
``thread`` the ``threading.get_ident()`` of the thread that ran it. A
recording adds nothing to the accumulator.

With the switch off and no recording open a scope is one test of a module
flag and a shared no-op context manager: no clock, no allocation, no read
of the environment.
"""

from __future__ import annotations

import atexit
import threading
import time

from .env import env_flag

_accumulate = env_flag("SUPERSLAM_PROFILE")  # the accumulator's switch
_recording: list | None = None  # the open recording's span records
_on = _accumulate  # a scope does work: the switch, or a recording open
_local = threading.local()  # .stack: the thread's open span records


def _refresh() -> None:
    global _on
    _on = _accumulate or _recording is not None


def set_enabled(on: bool) -> None:
    """Switch the accumulator (what ``SUPERSLAM_PROFILE`` sets at import)."""
    global _accumulate
    _accumulate = bool(on)
    _refresh()


def start_recording() -> None:
    """Open a recording: from now on every scope appends a span."""
    global _recording
    _recording = []
    _refresh()


def stop_recording() -> list[tuple]:
    """Close the recording; returns its closed spans in start order as
    ``(name, start_ns, end_ns, parent, root, thread)`` (see the module
    docstring). A span still open is left out, and so are the links to it."""
    global _recording
    recs, _recording = _recording or [], None
    _refresh()
    closed = [r for r in recs if r[2]]
    index = {id(r): i for i, r in enumerate(closed)}
    return [(name, a, b, index.get(id(parent), -1), index.get(id(root), -1), thread)
            for name, a, b, parent, root, thread in closed]


class Profiler:
    _instance: "Profiler | None" = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._acc: dict[str, tuple[float, int]] = {}

    @classmethod
    def instance(cls) -> "Profiler":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Profiler()
                atexit.register(cls._instance.dump)
            return cls._instance

    @staticmethod
    def enabled() -> bool:
        """The accumulator's switch (``SUPERSLAM_PROFILE``, ``set_enabled``)."""
        return _accumulate

    def add(self, label: str, ms: float) -> None:
        with self._lock:
            total, n = self._acc.get(label, (0.0, 0))
            self._acc[label] = (total + ms, n + 1)

    def stats(self) -> dict[str, tuple[float, int]]:
        with self._lock:
            return dict(self._acc)

    def dump(self) -> None:
        if not self._acc:
            return
        print("== superslam_tpu profile ==")
        with self._lock:
            for label in sorted(self._acc):
                total, n = self._acc[label]
                print(
                    f"  {label:<24} mean={total / max(n, 1):8.3f} ms"
                    f"  n={n:<6d} total={total:10.1f} ms"
                )


class _Off:
    """The scope with profiling off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class _Scope:
    __slots__ = ("label", "t0", "rec")

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self.t0 = time.perf_counter() if _accumulate else None
        spans = _recording
        self.rec = None
        if spans is not None:
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            parent = stack[-1] if stack else None
            # [name, start, end, parent, root, thread]; end 0 while open.
            rec = [self.label, time.time_ns(), 0, parent, None, threading.get_ident()]
            rec[4] = rec if parent is None else parent[4]
            spans.append(rec)
            stack.append(rec)
            self.rec = rec
        return None

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        if rec is not None:
            rec[2] = time.time_ns()
            _local.stack.pop()
        if self.t0 is not None:
            Profiler.instance().add(self.label, (time.perf_counter() - self.t0) * 1e3)
        return None


def profile_scope(label: str):
    """Python analogue of SUPERSLAM_PROFILE_SCOPE(label): a context manager
    that times its block into the accumulator and, while a recording is
    open, records it as a span."""
    if not _on:
        return _OFF
    return _Scope(label)
