"""Build and load the port's hand-written CUDA kernels.

All ``*.cu`` sources beside this file are compiled for ``sm_90a``, one
``nvcc`` process per source and all of them at once, and linked into one
shared library with a plain C interface, at first use, under
``build/superslam_tpu_torch/`` at the repository root. The library name
carries a hash of the sources, so an edited kernel is never served from a
stale build. It is loaded with ``ctypes``; no PyTorch header enters the
build (that is what keeps it to seconds instead of minutes).

Nothing here runs at import: the CPU tests import every kernel module on
hosts that have neither ``nvcc`` nor a card.

Each wrapper adds one to its launch count where it launches its kernel
(``count``); ``launch_counts``/``reset_launch_counts`` let a run show that
its main path really went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_SRC_DIR)))
BUILD_DIR = os.path.join(_REPO, "build", "superslam_tpu_torch")
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build, if it built

KERNELS = (
    "conv1a1b",
    "conv_pair",
    "nms",
    "scores_nms",
    "masked_attention",
    "masked_attention_bwd",
    "fused_self_block",
    "fused_cross_block",
    "gather_normalize",
    "conv_pair_full",
    "conv1a1b_full",
    "conv3x3",
    "pose_solve",
)
_LAUNCHES = dict.fromkeys(KERNELS, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, wa, ba, wb, bb, out, B, cin, H, W, out_f32, stream
    "ssl_conv_pair_pool": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the same arguments, no pool: out is (B, H, W, 64)
    "ssl_conv_pair": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, w, bias, out, B, cin, cout, H, W, relu, out_f32, stream
    "ssl_conv3x3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # s, out, B, H, W, radius, stream
    "ssl_nms": [_P, _P, _I, _I, _I, _I, _P],
    # logits, pre (or null), out, B, h, w, radius, stream
    "ssl_scores_nms": [_P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, mask, out, stats (or null), B, heads, N, is_bf16, stream
    "ssl_masked_attention": [_P] * 6 + [_I, _I, _I, _I, _P],
    # q, k, v, mask, dout, out, stats, dq, dk, dv, B, heads, N, is_bf16, stream
    "ssl_masked_attention_bwd": [_P] * 10 + [_I, _I, _I, _I, _P],
    # x, cos, sin, mask, wqkv, bqkv, wout, bout, w0, b0, g, be, w3, b3,
    # qkv scratch, ctx scratch, out, B, K, is_bf16, stream
    "ssl_fused_self_block": [_P] * 17 + [_I, _I, _I, _P],
    # the same without cos and sin
    "ssl_fused_cross_block": [_P] * 15 + [_I, _I, _I, _P],
    # grid, cells, out, B, G, K, D, is_bf16, stream
    "ssl_gather_normalize": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # R_prev, t_prev, R_pred, t_pred, kl, disp, stereo_ok, tm, kf_xw, kf_dok,
    # pose, stats, ok, uv, K, fx, fy, cx, cy, baseline, min_matches,
    # inv_sig_uLv, disp_sigma0, disp_cond, mono, gate_px, chi2_px,
    # chi2_rounds, track_iters, stream
    "ssl_pose_solve": [_P] * 14 + [_I] + [_F] * 5 + [_I] + [_F] * 3 + [_I] + [_F] * 2
    + [_I, _I, _P],
}


def count(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU host")


def _library_path() -> str:
    h = hashlib.sha1()
    for path in sources() + sorted(glob.glob(os.path.join(_SRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libsuperslam_kernels_{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile every kernel source (if not built yet): one nvcc process per
    source, started together, then one link; returns the library path.
    nvcc's resource reports (-Xptxas -v) go to nvcc.log beside the library."""
    global build_seconds
    out = _library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{out}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = f"{stem}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    log, failed = [], []
    for cmd, _, proc in jobs:
        try:
            text, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text += "\nnvcc: killed after 900 s"
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(text)
    objects = [obj for _, obj, _ in jobs]
    tmp = f"{stem}.tmp"
    if not failed:
        link = [nvcc, "-shared", "-o", tmp, *objects]
        proc = subprocess.run(link, capture_output=True, text=True, timeout=900)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stderr)
    build_seconds = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
        f.write("\n".join(log))
    for obj in objects:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(t[-4000:] for t in failed))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_of(t) -> int:
    """PyTorch's current stream on the tensor's device, as a handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
