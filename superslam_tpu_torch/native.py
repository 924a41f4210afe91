"""ctypes bindings for the native estimation core (csrc/).

The reference's estimation layer is C++ (GTSAM); ours keeps a device-free
Python core as the oracle and ships this native library for the host hot
loops — the per-frame pose-only LM and the pose-graph batch LM. The library
is optional: ``available()`` is False until ``make -C csrc`` has produced
``libsuperslam_core.so`` (the test suite builds it on demand), and every
caller falls back to the numpy implementation.

The multi-sequence step's upload fill (``padded_fill``) is the port's own
library: ``csrc/fill.cpp`` beside this module, built at its first use
(``fill_library``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings

import numpy as np

from .geometry.se3 import Pose3

_LIB: ctypes.CDLL | None = None
_TRIED = False

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
# SUPERSLAM_NATIVE_SO points at an alternative build, e.g. the ASan/UBSan
# library produced by `make -C csrc sanitize-test`.
_SO = os.environ.get(
    "SUPERSLAM_NATIVE_SO", os.path.join(_CSRC, "libsuperslam_core.so")
)

_d = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def build(force: bool = False) -> bool:
    """Compile the library with make; returns success."""
    if os.path.exists(_SO) and not force:
        return True
    try:
        subprocess.run(
            ["make", "-C", _CSRC, "-s"], check=True, capture_output=True, timeout=120
        )
        return os.path.exists(_SO)
    except Exception:
        return False


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO) and not build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
        lib.ssl_se3_exp.argtypes = [_d, _d]
        lib.ssl_se3_log.argtypes = [_d, _d]
        lib.ssl_se3_compose.argtypes = [_d, _d, _d]
        lib.ssl_se3_between.argtypes = [_d, _d, _d]
        lib.ssl_pose_only_lm.restype = ctypes.c_int
        lib.ssl_pose_only_lm.argtypes = [
            _d, _d, _d, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, _d, _d, ctypes.c_int,
        ]
        lib.ssl_pose_graph_lm.restype = ctypes.c_int
        lib.ssl_pose_graph_lm.argtypes = [
            _d, ctypes.c_int, _i32, ctypes.c_int, _d, _d, _d,
            ctypes.c_int, ctypes.c_double, _d, ctypes.c_int,
        ]
        lib.ssl_window_lm.restype = ctypes.c_int
        lib.ssl_window_lm.argtypes = [
            _d, ctypes.c_int, _i32, _d, _i32, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, _d, ctypes.c_int,
        ]
        lib.ssl_window_seed_gate.restype = None
        lib.ssl_window_seed_gate.argtypes = [
            _d, ctypes.c_int, _i32, _d, _i32, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, _u8,
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


_FILL_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "fill.cpp")
_FILL_BUILD_DIR = os.path.join(os.path.dirname(_CSRC), "build", "superslam_tpu_torch")
_FILL_LOCK = threading.Lock()
_FILL_LIB: ctypes.CDLL | None = None
_FILL_TRIED = False


def _build_fill() -> ctypes.CDLL | None:
    # The name carries the source's hash, so an edited source is never
    # served from an older build; a build is renamed into place whole, so
    # processes that build at once each load a finished library.
    with open(_FILL_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    so = os.path.join(_FILL_BUILD_DIR, f"libsuperslam_fill_{digest}.so")
    try:
        if not os.path.exists(so):
            os.makedirs(_FILL_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cxx = shutil.which("g++") or shutil.which("c++") or "c++"
            subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared",
                            "-o", tmp, _FILL_SRC], check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.SubprocessError) as e:
        warnings.warn(f"the upload fill's library did not build ({e}): the fill takes "
                      "numpy's copies", RuntimeWarning, stacklevel=4)
        return None
    lib.ssl_fill_padded.restype = None
    lib.ssl_fill_padded.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i64,
    ]
    return lib


def fill_library() -> ctypes.CDLL | None:
    """The fill's library, built into the git-ignored ``build/`` at the
    repository root at the first call of the process; None, with one
    warning, where no C++ compiler builds it."""
    global _FILL_LIB, _FILL_TRIED
    with _FILL_LOCK:
        if not _FILL_TRIED:
            _FILL_TRIED = True
            _FILL_LIB = _build_fill()
        return _FILL_LIB


class PaddedFill:
    """The native fill of one batch: the 2-D uint8 ``images`` into the
    C-contiguous uint8 ``out`` (len(images), padH, padW), each at the top
    left and cropped to the pad, the rest of its slot zeroed. The images'
    addresses are read once, at construction; ``fill(lo, hi)`` writes images
    ``lo:hi`` and holds no interpreter lock, so calls on disjoint ranges run
    side by side on several threads."""

    def __init__(self, lib: ctypes.CDLL, out: np.ndarray, images: list[np.ndarray]):
        n, pad_h, pad_w = out.shape
        if out.dtype != np.uint8 or not out.flags.c_contiguous or len(images) != n:
            raise ValueError(f"out {out.dtype} {out.shape} does not hold {len(images)} images")
        if any(a.dtype != np.uint8 or a.ndim != 2 for a in images):
            raise ValueError("the native fill takes 2-D uint8 images")
        # Rows must be contiguous; a copy of what the pad keeps where they are
        # not. The list keeps every image the table points at alive.
        self.images = [a if a.strides[1] == 1 else np.ascontiguousarray(a[:pad_h, :pad_w])
                       for a in images]
        self.table = np.array([(a.ctypes.data, *a.shape, a.strides[0]) for a in self.images],
                              np.int64).reshape(n, 4)
        self.lib, self.out, self.pad = lib, out, (pad_h, pad_w)

    def fill(self, lo: int, hi: int) -> None:
        if not 0 <= lo <= hi <= len(self.images):
            raise IndexError(f"images {lo}:{hi} of {len(self.images)}")
        pad_h, pad_w = self.pad
        self.lib.ssl_fill_padded(self.out[lo:hi].ctypes.data, hi - lo, pad_h, pad_w,
                                 self.table[lo:hi])


def padded_fill(out: np.ndarray, images: list[np.ndarray]) -> PaddedFill | None:
    """``PaddedFill(out, images)``, or None where the fill's library does
    not build."""
    lib = fill_library()
    return None if lib is None else PaddedFill(lib, out, images)


def _pack(p: Pose3) -> np.ndarray:
    out = np.empty(12)
    out[:9] = p.R.ravel()
    out[9:] = p.t
    return out


def _unpack(a: np.ndarray) -> Pose3:
    return Pose3(a[:9].reshape(3, 3).copy(), a[9:].copy())


def pose_only_lm(
    Xw: np.ndarray,
    meas: np.ndarray,
    sigmas: np.ndarray,
    calib,
    huber_k: float,
    initial: Pose3,
    max_iters: int = 100,
) -> Pose3:
    lib = _load()
    assert lib is not None
    n = int(Xw.shape[0])
    out = np.empty(12)
    lib.ssl_pose_only_lm(
        np.ascontiguousarray(Xw, np.float64),
        np.ascontiguousarray(meas, np.float64),
        np.ascontiguousarray(sigmas, np.float64),
        n,
        calib.fx, calib.fy, calib.cx, calib.cy, calib.baseline,
        float(huber_k),
        _pack(initial),
        out,
        int(max_iters),
    )
    return _unpack(out)


def pose_graph_lm(
    seeds: list[Pose3],
    edges: list[tuple[int, int, Pose3, np.ndarray, float]],
    prior_idx: int,
    prior_sigma: float,
    max_iters: int = 100,
) -> list[Pose3] | None:
    """edges: (i, j, rel, inv_sigmas(6,), huber_k<=0 for quadratic).
    Returns None on solver failure (caller applies rollback policy)."""
    lib = _load()
    assert lib is not None
    K = len(seeds)
    E = len(edges)
    seeds_a = np.concatenate([_pack(p) for p in seeds])
    ij = np.array([[e[0], e[1]] for e in edges], np.int32).reshape(E, 2)
    rel = np.concatenate([_pack(e[2]) for e in edges]) if E else np.zeros(0)
    inv_sig = np.concatenate([np.asarray(e[3], np.float64) for e in edges]) if E else np.zeros(0)
    hk = np.array([e[4] for e in edges], np.float64)
    out = np.empty(12 * K)
    rc = lib.ssl_pose_graph_lm(
        np.ascontiguousarray(seeds_a),
        K,
        np.ascontiguousarray(ij),
        E,
        np.ascontiguousarray(rel),
        np.ascontiguousarray(inv_sig),
        np.ascontiguousarray(hk),
        int(prior_idx),
        1.0 / (prior_sigma * prior_sigma),
        out,
        int(max_iters),
    )
    if rc < 0:
        return None
    return [_unpack(out[12 * i : 12 * i + 12]) for i in range(K)]


def window_seed_gate(
    poses: list[Pose3],
    views: np.ndarray,  # (L, m_max) int32, padded
    meas: np.ndarray,  # (L, m_max, 3)
    mlen: np.ndarray,  # (L,) int32 valid views per track (>= 2)
    calib,
    gate_px: float,
) -> np.ndarray:
    """Native seed gate (csrc ssl_window_seed_gate): triangulate every track
    once at the seed poses and keep tracks with max reprojection error under
    gate_px. The numpy WindowSmoother._prefilter_groups is the oracle; this
    sits on the tracking drain path at every keyframe insertion, where the
    numpy gate was 80-90% of ws_solve (~15-40 ms vs ~3 ms for the LM)."""
    lib = _load()
    assert lib is not None
    L, m_max = views.shape
    keep = np.empty(L, np.uint8)
    lib.ssl_window_seed_gate(
        np.ascontiguousarray(np.concatenate([_pack(p) for p in poses])),
        len(poses),
        np.ascontiguousarray(views, np.int32),
        np.ascontiguousarray(meas, np.float64),
        np.ascontiguousarray(mlen, np.int32),
        int(L), int(m_max),
        calib.fx, calib.fy, calib.cx, calib.cy, calib.baseline,
        float(gate_px),
        keep,
    )
    return keep.astype(bool)


def window_lm(
    poses: list[Pose3],
    views: np.ndarray,  # (L, m_max) int32, padded
    meas: np.ndarray,  # (L, m_max, 3)
    mlen: np.ndarray,  # (L,) int32 valid views per landmark (>= 2)
    calib,
    inv_sigma: float,
    dyn_outlier_px: float,
    prior_info: float,
    max_iters: int,
    huber_k: float = 0.0,
) -> list[Pose3]:
    """Native sliding-window smart-factor LM (csrc ssl_window_lm); the
    numpy WindowSmoother._lm is the oracle."""
    lib = _load()
    assert lib is not None
    K = len(poses)
    L, m_max = views.shape
    seeds = np.concatenate([_pack(p) for p in poses])
    out = np.empty(12 * K)
    lib.ssl_window_lm(
        np.ascontiguousarray(seeds),
        K,
        np.ascontiguousarray(views, np.int32),
        np.ascontiguousarray(meas, np.float64),
        np.ascontiguousarray(mlen, np.int32),
        int(L), int(m_max),
        calib.fx, calib.fy, calib.cx, calib.cy, calib.baseline,
        float(inv_sigma), float(dyn_outlier_px), float(prior_info),
        float(huber_k),
        out,
        int(max_iters),
    )
    return [_unpack(out[12 * i : 12 * i + 12]) for i in range(K)]
