"""Env-gated accumulator profiler.

Equivalent of the reference Profiler
(``include/Profiling.h:14-74``): enabled by
``SUPERSLAM_PROFILE=1``, a lock-guarded map of label -> (total_ms, n), an
RAII-style scope timer, and a dump at exit. Scope labels preserve the
reference's names (sp_extract_stereo, sp_gpu_infer, fe_extract_stereo,
fe_lg_stereo_match, vo_track_total, vo_lg_track_match, vo_gtsam_optimize,
ws_rebuild, ws_solve) for comparability.
"""

from __future__ import annotations

import atexit
import threading
import time
from contextlib import contextmanager

from .env import env_flag


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
        return env_flag("SUPERSLAM_PROFILE")

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


@contextmanager
def profile_scope(label: str):
    """Python analogue of SUPERSLAM_PROFILE_SCOPE(label)."""
    if not Profiler.enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        Profiler.instance().add(label, (time.perf_counter() - t0) * 1e3)
