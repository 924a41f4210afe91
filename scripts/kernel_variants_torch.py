#!/usr/bin/env python3
"""Build variants of a hand-written kernel side by side and time them on the
card at the main path's shapes.

    python3 scripts/kernel_variants_torch.py [--kernel pair|conv3x3|attn_bwd|attn_fwd|block|nms|nms_map|track_frame|gather] [--source DIR] [NAME[:EDIT,EDIT...] ...]

Kernels (``--kernel``, default ``pair``):

- ``pair``: the mma.sync conv pair (``conv_pair_mma.cu``), the gray pair
  (CIN = 1) at (2, 1, 384, 1248) f32 and the 64-channel pair at (2, 64,
  192, 624) bf16, pooled and unpooled, bf16 out;
- ``conv3x3``: the single conv (``conv3x3_mma.cu``) at (2, 64, 192, 624)
  bf16, COUT 64 and 128, ReLU, bf16 out;
- ``attn_bwd``: the attention backward (``attention_bwd.cu``) at the
  training shape (16, 4, 256, 64) f32, key masks of 128-256 real keys and
  one fully-masked batch row, on the plain forward's residuals;
- ``attn_fwd``: the attention forward (``masked_attention.cu`` with
  ``attention.cuh``) in bf16 at the serving shape (4, 4, 600, 64), 70% real
  keys and one fully-masked batch row, and in f32 at the training shape
  (16, 4, 256, 64) as for ``attn_bwd``; the library call beside each is
  ``scaled_dot_product_attention`` on the same inputs;
- ``block``: the fused LightGlue self and cross blocks
  (``lightglue_layer.cu``) at (4, 600, 256) bf16, one random layer, 70%
  real keys and one fully-masked row;
- ``nms``: the NMS kernel (``nms.cu``) in logits mode at the serving shape,
  (2, 65, 48, 156) channels_last f32 logits with peaks to the NMS'd and the
  pre-NMS map, radius 4, beside the composition of ``torch.softmax``,
  ``pixel_shuffle`` and a ``max_pool2d`` compare; and in map mode on a
  (2, 384, 1248) map with ties, beside the ``max_pool2d`` compare;
  ``nms_map`` the map mode alone (an ``nms.cu`` without the logits mode);
- ``track_frame``: the per-frame tracking kernel (``track_frame.cu`` with
  its engine ``pose_solve.cuh``) on frames built from a seed as
  tests/test_torch_track_frame_model.py's ``_case`` builds them: track_kf_scan's
  epilogue at K 600 (a cluster of 8 blocks, 256 f32 descriptors a
  feature, no promotion), track_scan's mono at K 1000, and
  ``track_frame_batched`` (one block a sequence) at Q 1, 4 and 16, K 600.
  Each case prints its plain twin's LM iterations (the longest sequence's
  for the batched ones) and its time per iteration;
- ``gather``: the descriptor gather (``gather.cu``) at the main path's
  shapes: the serving grid (2, 7488, 256) bf16 with 600 int64 cells, batch
  4 and the S = 4 multi-sequence step (8, 7488, 256) with 600, RGB-D (1,
  4800, 256) with 1000, and an f32 grid (1, 300, 256) with 256 (the
  training evaluation's 120 x 160 at 256 keypoints); the library call
  beside each is ``index_select`` + ``F.normalize`` on the same inputs, and
  a one-element ``fill_`` is timed in the same turns as the card's launch
  floor.

``--source DIR`` builds from the kernel sources in DIR instead of this
checkout's: with an unpacked parent commit's ``superslam_tpu_torch/ops/cuda``
it times the parent's kernel in the same call as this one's. A variant
named ``NAME@DIR`` builds from DIR alone, so the parent's kernel and this
one's take turns in one process (``tree prev@<parent>/superslam_tpu_torch/ops/cuda``).

A NAME alone is the kernel source as it is. An EDIT is either KEY=VALUE,
which sets the ``constexpr int KEY`` of the source or of one of its
headers (pair: ``p2:NPASS1=2``, the gray pair's conv_b in two 32-channel
passes, ``w16:NWARPS=16``, ``r4:RING=4``; conv3x3:
``w8:NWARPS3=8,NPASS3=2,MINB3=2``, 8 warps in 32-channel passes, two
blocks per SM; attn_bwd: ``r32:BR=32``, blocks of 32 own rows,
``wc1:WC=1``, one warp across a walked tile; attn_fwd: ``s3:KSTAGES=3``,
the bf16 key/value ring of 3 slots, ``q32:BQ=32``, bf16 blocks of 32
query rows, ``f32q32:FQ=32`` and ``f32q128:FQ=128``, f32 blocks of 32 or
128; block: ``ring4:RING=4``, a weight ring of 4 slots, ``r16:BM=16`` and
``r64:BM=64``, row tiles of 16 or 64 rows, ``w16:NWARPS=16``; nms:
``c4x16:TCX=16``, tiles of 4 x 16 cells, ``c8x16:TCY=8,TCX=16``; gather:
``w2:WARPS=2``, blocks of 2 warps, ``k4:kpw,KPW=4``, 4 keypoints a warp
after the ``kpw`` patch), or the name of
a diagnostic patch of ``PATCHES`` (pair: ``noA``, A operands from
registers, no ldmatrix; ``nomma``, no mma, one ALU operation per product
instead; ``nostep``, no tap step at all; ``noprologue``, no CUDA-core
conv_a in the gray pair; attn_bwd and attn_fwd: ``tf32x1``, one TF32
product instead of three; track_frame: ``frozen``, each LM step scaled by
zero after the solve, so the pose never moves and every LM solve runs
until lambda passes 1e8 (14 iterations), ``nopoints`` the same without
the per-point arithmetic (the sums are zero, the reduction stays) and
``nosolve`` the same without the 6 x 6 LU (a zero step): the three share
one control flow, and their differences split an iteration's time;
``lmcount``, the kernel's own LM iterations, printed beside the twin's
(they part where rounding decides a converged step); ``frozen_prev`` and
``lmcount_prev`` the same for the engine before its one-barrier schedule,
one thread solving the 6 x 6 system, with ``--source`` at its sources;
gather: ``kpw``, KPW (2) keypoints a warp, their cell ids in one load
and their rows held in registers together; ``nostream``, plain stores
instead of streaming ones; ``bulk``, each warp's row copied into shared
memory by Hopper's bulk copy, ``cp.async.bulk`` global -> shared on an
mbarrier, instead of loaded into registers).
Patched variants compute wrong results: they only split the time. With
no variant: pair ``tree p2:NPASS1=2 nostep:nostep nomma:nomma
noprologue:noprologue``; conv3x3 ``tree w8:NWARPS3=8,NPASS3=2,MINB3=2``;
attn_bwd ``tree r32:BR=32``; attn_fwd ``tree s3:KSTAGES=3 s4:KSTAGES=4
q32:BQ=32 f32q32:FQ=32 f32q128:FQ=128``; block ``tree ring4:RING=4
ring5:RING=5 r16:BM=16 r64:BM=64 w16:NWARPS=16``; nms ``tree c4x16:TCX=16
c8x16:TCY=8,TCX=16``; track_frame ``tree count:lmcount frozen:frozen
nopoints:frozen,nopoints nosolve:frozen,nosolve
t512frozen:THREADS=512,PPT=2,frozen`` (with ``--source`` at that earlier
engine's sources: ``prev prevcount:lmcount_prev prevfrozen:frozen_prev``);
gather ``tree w2:WARPS=2 w8:WARPS=8 k2:kpw k4:kpw,KPW=4 nostream:nostream
bulk:bulk`` (with ``--source`` at the earlier kernel's sources: ``prev``).

Each variant is compiled with the port's nvcc flags into its own library
under ``build/kernel_variants/<kernel>/`` (one nvcc per variant, all at once)
and called through the kernel's own C entry point. Unpatched variants are
held against the plain version (max error / max|plain| <= 2e-2 for the
convs, the blocks and bf16 attention, 1e-4 for f32 attention and the
backward; nms: the pre-NMS map within 1e-6 of the plain softmax's and the
NMS'd map against ``nms_plain`` of the kernel's own pre-NMS map, the map
mode exact; track_frame: the row's poses within 1e-3 of the twin's,
its counts exact; gather: 1e-5; patched variants are checked only where
their patches keep the function, the gather's three). Then every variant is timed: 4
rounds, in alternating order, of 50 back-to-back launches between two CUDA
events, for each case; with ``--graph`` the 50 launches are captured in a
CUDA graph and replayed, so the host's cost of a launch (~9 us through
ctypes and Python, above a small kernel's time) leaves the figure; with
``--device-time`` each call's device time (the sum of its kernels' own
durations in torch.profiler over 20 calls) is printed after the turns, and
with ``--cold`` too each call's device time after a 64 MB write (more than
the H100's 50 MB L2) that evicts its inputs, as a caller finds them after
other work.
Prints the card and its power limit, registers and spills from
nvcc's report, and one line per variant and case; conv3x3's cases are also
timed, in the same turns, through cuDNN (``library``), attn_fwd's
through scaled_dot_product_attention and nms's through the compositions
above. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SRC = os.path.join(REPO, "superslam_tpu_torch", "ops", "cuda")
OUT = os.path.join(REPO, "build", "kernel_variants")
ENGINE, ATTN, TF32, FWD = "conv_mma.cuh", "attention_bwd.cu", "tf32_mma.cuh", "attention.cuh"
POSE = "pose_solve.cuh"
# kernel: (source, headers beside common.cuh, default variants)
KERNELS = {
    "pair": ("conv_pair_mma.cu", (ENGINE,),
             ["tree", "p2:NPASS1=2", "nostep:nostep", "nomma:nomma", "noprologue:noprologue"]),
    "conv3x3": ("conv3x3_mma.cu", (ENGINE,), ["tree", "w8:NWARPS3=8,NPASS3=2,MINB3=2"]),
    "attn_bwd": (ATTN, (TF32,), ["tree", "r32:BR=32"]),
    "attn_fwd": ("masked_attention.cu", (FWD, ENGINE, TF32),
                 ["tree", "s3:KSTAGES=3", "s4:KSTAGES=4", "q32:BQ=32", "f32q32:FQ=32",
                  "f32q128:FQ=128"]),
    "block": ("lightglue_layer.cu", (FWD, ENGINE, TF32),
              ["tree", "ring4:RING=4", "ring5:RING=5", "r16:BM=16", "r64:BM=64",
               "w16:NWARPS=16"]),
    "nms": ("nms.cu", (), ["tree", "c4x16:TCX=16", "c8x16:TCY=8,TCX=16"]),
    "nms_map": ("nms.cu", (), ["tree"]),
    "track_frame": ("track_frame.cu", (POSE,),
                    ["tree", "count:lmcount", "frozen:frozen", "nopoints:frozen,nopoints",
                     "nosolve:frozen,nosolve", "t512frozen:THREADS=512,PPT=2,frozen"]),
    "gather": ("gather.cu", (), ["tree", "w2:WARPS=2", "w8:WARPS=8", "k2:kpw", "k4:kpw,KPW=4",
                                 "nostream:nostream", "bulk:bulk"]),
}
SHAPES = {1: (2, 1, 384, 1248), 64: (2, 64, 192, 624)}
ATTN_SHAPE = (16, 4, 256, 64)
SERVE_ATTN_SHAPE = (4, 4, 600, 64)
BLOCK_SHAPE = (4, 600, 256)
LOGITS_SHAPE = (2, 65, 48, 156)  # the detector head's logits of a 1248 x 384 stereo pair

# name: (file, text, replacement); the pair kernel's diagnostics.
PATCHES = {
    "noA": (ENGINE, "ldsm_x4(arow[r] + ((axor[r] ^ (2 * ks)) << 4), a);",
            "a[0] = arow[r]; a[1] = axor[r]; a[2] = ks; a[3] = lane;"),
    "nomma": (ENGINE, """  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));""",
              "  c[0] += __uint_as_float(a[0] ^ b0);"),
    "nostep": ("conv_pair_mma.cu", "    tap_step(acc,", "    if (s < 0) tap_step(acc,"),
    "noprologue": ("conv_pair_mma.cu", "for (int p = tid >> 3; p < (TH + 2) * AP;",
                   "for (int p = tid >> 3; p < 0;"),
}
# The attention kernels' diagnostics: one TF32 product instead of three
# (backward and f32 forward), no exp (backward).
PATCHES.update({
    "tf32x1": (TF32, """  mma_tf32(c, as[0], as[1], as[2], as[3], bb0, bb1);
  mma_tf32(c, ab[0], ab[1], ab[2], ab[3], bs0, bs1);
""", ""),
    "noexp": (ATTN, "expf(", "fabsf("),
})
# The tracking kernel's: a frozen pose (the step scaled by zero after the
# solve), no per-point arithmetic, no 6 x 6 LU; lmcount: each solve's LM
# iterations into stats[2] (track_kf_scan's new since then reads wrong). A
# patch is one (file, text, replacement) or a list of them. frozen_prev and
# lmcount_prev are the same for the engine before its one-barrier schedule
# (one thread solving the 6 x 6 system), to time that kernel the same way.
TRACK = "track_frame.cu"
_LU = "      finite = __all_sync(FULL, lu_solve(A, b, x));\n"
_ZERO = "      for (int j = 0; j < 6; ++j) x[j] *= 0.f;\n"
_SOLVE = ("__device__ __forceinline__ int solve(const Params& q, Points& pt, Reducer& red,\n"
          "                                     const float (&pred)[12], float (&P)[12]) {\n")
_SOLVE_PREV = ("__device__ __forceinline__ int solve(const Params& q, Points& pt, Shared& s, "
               "const float* pred) {\n")
_LAM = "    lam = accept ? clamp_min(lam * 0.1f, 1e-10f) : lam * 10.f;\n"
_LAM_PREV = "      s.lam = accept ? clamp_min(s.lam * 0.1f, 1e-10f) : s.lam * 10.f;\n"
_COUNT_DECL = (POSE, "namespace pose {\n", "namespace pose {\n\n__shared__ int lm_count;\n")
_COUNT_OUT = [(TRACK, "    stats_out[1] = kept;\n", "    stats_out[1] = kept;\n    stats_out[2] = lm_count;\n"),
              (TRACK, "      stats_out[2] = promo ? 0 : since1;\n", "      stats_out[2] = lm_count;\n")]
_POINT = "  float p0, p1, p2, iz, r[3];\n  bool good;\n  to_camera(P, pt.X[k]"
PATCHES.update({
    "frozen": (POSE, _LU, _LU + _ZERO),
    "nopoints": (POSE, _POINT, "  if (q.K > 0) return;\n" + _POINT),
    "nosolve": (POSE, _LU + _ZERO,
                "      finite = true;\n      for (int j = 0; j < 6; ++j) x[j] = 0.f;\n"),
    "lmcount": [_COUNT_DECL, (POSE, _SOLVE, _SOLVE + "  if (threadIdx.x == 0) lm_count = 0;\n"),
                (POSE, _LAM, _LAM + "    if (threadIdx.x == 0) ++lm_count;\n"), *_COUNT_OUT],
    "frozen_prev": (POSE, "  s.ok_step = finite;\n",
                    "  s.ok_step = finite;\n  for (int j = 0; j < 6; ++j) x[j] *= 0.f;\n"),
    "lmcount_prev": [_COUNT_DECL,
                     (POSE, _SOLVE_PREV, _SOLVE_PREV + "  if (threadIdx.x == 0) lm_count = 0;\n"),
                     (POSE, _LAM_PREV, _LAM_PREV + "      ++lm_count;\n"), *_COUNT_OUT],
})
# The gather's variants, each the kernel's function at D up to 256. kpw: KPW
# keypoints a warp, lane j < KPW loading keypoint j's cell id, every row of
# the warp's held in registers at once (no chunks past the registers').
# nostream: plain stores. bulk: lane 0 copies the warp's row into shared
# memory with cp.async.bulk on the warp's mbarrier; every lane waits on it,
# then reads its chunks from shared memory.
GATHER = "gather.cu"
_GATHER_ONE = """  const int kp = blockIdx.x * WARPS + threadIdx.x / 32;
  if (kp >= N) return;
"""
_GATHER_KPW_HEAD = """  const int first = (blockIdx.x * WARPS + threadIdx.x / 32) * KPW;
  if (first >= N) return;
  const int nch = D / 4;  // chunks a row

  // Lane j < KPW: keypoint first + j's row offset, clamped into the grid.
  long long mine = 0;
  if (lane < KPW && first + lane < N) {
    const int kp = first + lane;
    long long cell = __ldg(cells + kp);
    cell = cell < 0 ? 0 : (cell >= G ? G - 1 : cell);
    mine = ((long long)(kp / K) * G + cell) * D;
  }

  float4 v[KPW][NC];
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    const T* row = grid + __shfl_sync(FULL, mine, j);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = lane + 32 * c;
      v[j][c] = (ch < nch && first + j < N) ? load4(row + 4 * ch) : make_float4(0, 0, 0, 0);
    }
  }
  float sq[KPW];
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    sq[j] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) sq[j] += sum_sq(v[j][c]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < KPW; ++j) sq[j] += __shfl_xor_sync(FULL, sq[j], o);
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    if (first + j >= N) break;
    const float inv = rsqrtf(sq[j] + 1e-12f);
    float* dst = out + size_t(first + j) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = lane + 32 * c;
      if (ch < nch) store4(dst + 4 * ch, v[j][c], inv);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    gather_one(const T* __restrict__ grid, const long long* __restrict__ cells,
               float* __restrict__ out, int N, int G, int K, int D) {
  const int lane = threadIdx.x % 32;
  const int kp = blockIdx.x * WARPS + threadIdx.x / 32;
  if (kp >= N) return;
"""
_GATHER_LOAD = """  float4 v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int ch = lane + 32 * c;
    v[c] = ch < nch ? load4(row + 4 * ch) : make_float4(0, 0, 0, 0);
  }
"""
_GATHER_BULK = """  float4 v[NC];
  {
    __shared__ alignas(128) T stage[WARPS][NC * 128];
    __shared__ alignas(8) unsigned long long bar[WARPS];
    const int w = threadIdx.x / 32;
    const int held = nch < 32 * NC ? nch : 32 * NC;  // chunks copied
    const unsigned b = unsigned(__cvta_generic_to_shared(&bar[w]));
    if (lane == 0) {
      const unsigned bytes = unsigned(held * 4 * sizeof(T));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(b), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          ::"r"(unsigned(__cvta_generic_to_shared(&stage[w][0]))), "l"(row), "r"(bytes), "r"(b)
          : "memory");
    }
    __syncwarp();
    unsigned done = 0;
    while (!done)
      asm volatile("{\\n .reg .pred p;\\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
                   " selp.u32 %0, 1, 0, p;\\n}" : "=r"(done) : "r"(b), "r"(0u) : "memory");
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = lane + 32 * c;
      v[c] = ch < held ? load4_shared(&stage[w][4 * ch]) : make_float4(0, 0, 0, 0);
    }
  }
"""
_GATHER_SHARED = "__device__ __forceinline__ float sum_sq("
_GATHER_SHARED_LOAD = """__device__ __forceinline__ float4 load4_shared(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_shared(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float sum_sq("""
_STCS = "  __stcs(reinterpret_cast<float4*>(p), make_float4("
PATCHES.update({
    # The kernel's head becomes the KPW kernel's whole body; the rest of the
    # one-keypoint body is left to an unused kernel, gather_one.
    "kpw": [(GATHER, "constexpr unsigned FULL", "constexpr int KPW = 2;\nconstexpr unsigned FULL"),
            (GATHER, _GATHER_ONE, _GATHER_KPW_HEAD),
            (GATHER, "  const int blocks = (N + WARPS - 1) / WARPS;",
             "  const int blocks = (N + WARPS * KPW - 1) / (WARPS * KPW);")],
    "nostream": (GATHER, _STCS, "  *reinterpret_cast<float4*>(p) = (make_float4("),
    "bulk": [(GATHER, _GATHER_SHARED, _GATHER_SHARED_LOAD), (GATHER, _GATHER_LOAD, _GATHER_BULK)],
})
EXACT_PATCHES = {"kpw", "nostream", "bulk"}  # patches that keep the function: checked
# (label, B, G, K, grid dtype): serving, batch 4 and the S = 4 step, RGB-D, and
# the training evaluation (120 x 160, 256 keypoints).
GATHER_SHAPES = (("serving", 2, 48 * 156, 600, "bfloat16"),
                 ("batch 4", 8, 48 * 156, 600, "bfloat16"),
                 ("RGB-D", 1, 60 * 80, 1000, "bfloat16"),
                 ("training evaluation", 1, 15 * 20, 256, "float32"))

TRACK_CALIB = (320.0, 320.0, 320.0, 176.0, 0.3)  # tests/test_torch_pose_solve_model.py's
TRACK_SOLVE = dict(min_matches=10, inv_sig_uLv=0.1, disp_sigma0=1.0, disp_cond=320.0 * 0.3 / 40.0,
                   gate_px=10.0, chi2_px=2.0, chi2_rounds=2, track_iters=20)
TRACK_GATE = dict(accept_frac=0.4, support_px=4.0, kf_min_frames=2, kf_max_frames=99,
                  kf_min_matches=30, covis_ratio=0.5)
TRACK_K, TRACK_MONO_K, TRACK_D, TRACK_Q = 600, 1000, 256, (1, 4, 16)


def parse(args: list[str]) -> dict[str, tuple[dict[str, str], list[str]]]:
    """NAME[@DIR][:EDIT,...] -> {NAME: (constants, patches)}; the sources'
    directories, where given, in ``SOURCES``."""
    variants = {}
    for arg in args:
        name, _, edits = arg.partition(":")
        name, _, src = name.partition("@")
        if src:
            SOURCES[name] = src
        consts, patches = {}, []
        for edit in filter(None, edits.split(",")):
            if "=" in edit:
                key, value = edit.split("=", 1)
                consts[key] = value
            elif edit in PATCHES:
                patches.append(edit)
            else:
                raise SystemExit(f"kernel_variants: unknown edit {edit!r} of {arg!r}")
        variants[name] = (consts, patches)
    return variants


SOURCES: dict[str, str] = {}  # a variant's own sources' directory (NAME@DIR)


def write_variant(kernel: str, name: str, consts: dict[str, str], patches: list[str],
                  src: str = SRC) -> str:
    source, headers, _ = KERNELS[kernel]
    d = os.path.join(OUT, kernel, name)
    os.makedirs(d, exist_ok=True)
    shutil.copy(os.path.join(src, "common.cuh"), d)
    files = {}
    for f in (*headers, source):
        with open(os.path.join(src, f)) as fh:
            files[f] = fh.read()
    for p in patches:
        for f, old, new in PATCHES[p] if isinstance(PATCHES[p], list) else [PATCHES[p]]:
            if f not in files or old not in files[f]:
                raise SystemExit(f"kernel_variants: patch {p} does not match {kernel}'s sources")
            files[f] = files[f].replace(old, new)
    for key, value in consts.items():
        hits = 0
        for f in files:
            files[f], n = re.subn(rf"^constexpr int {key} = [^;]+;",
                                  f"constexpr int {key} = {value};", files[f], flags=re.M)
            hits += n
        if hits != 1:
            raise SystemExit(f"kernel_variants: {hits} constexpr int {key} in {kernel}'s sources")
    for f, text in files.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    return os.path.join(d, source)


def pair_cases(torch, dev, rng):
    """(label, launch(lib, stream), outputs, references, limit, library
    call or None) of the pair."""
    from superslam_tpu_torch.ops.cuda.conv import conv_pair_plain, conv_pair_pool_plain, pair_operands

    cases = []
    for cin, shape in SHAPES.items():
        b, c, h, w = shape
        x = rng.uniform(0, 1, shape) if cin == 1 else np.maximum(rng.normal(size=shape), 0)
        x = torch.from_numpy(x.astype(np.float32)).to(dev)
        wa = torch.from_numpy((rng.normal(size=(64, c, 3, 3)) * (0.3 if cin == 1 else 0.05))
                              .astype(np.float32)).to(dev)
        wb = torch.from_numpy((rng.normal(size=(64, 64, 3, 3)) * 0.05).astype(np.float32)).to(dev)
        ba, bb = (torch.from_numpy((rng.normal(size=(64,)) * 0.1).astype(np.float32)).to(dev)
                  for _ in range(2))
        xk = x if cin == 1 else x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        ops = pair_operands(wa, ba, wb, bb)
        for pool, plain in ((True, conv_pair_pool_plain), (False, conv_pair_plain)):
            ref = plain(x, wa, ba, wb, bb).float()
            out = torch.empty(ref.shape, dtype=torch.bfloat16, device=dev,
                              memory_format=torch.channels_last)

            def launch(lib, stream, xk=xk, ops=ops, out=out, pool=pool, cin=cin, b=b, h=h, w=w):
                fn = lib.ssl_conv_pair_pool if pool else lib.ssl_conv_pair
                return fn(xk.data_ptr(), *(t.data_ptr() for t in ops), out.data_ptr(), b, cin,
                          h, w, 0, stream)

            label = f"CIN {cin} {'pooled' if pool else 'unpooled'} at {shape}"
            cases.append((label, launch, [out], [ref], 2e-2, None))
    return cases


def conv3x3_cases(torch, dev, rng):
    """The library call beside each case is cuDNN's conv2d + ReLU on the same
    bf16 NHWC input and bf16 weights, prepared beforehand."""
    import torch.nn.functional as F

    from superslam_tpu_torch.ops.cuda.conv import conv3x3_operands, conv3x3_plain

    b, c, h, w = SHAPES[64]
    x = torch.from_numpy(np.maximum(rng.normal(size=(b, c, h, w)), 0).astype(np.float32)).to(dev)
    xk = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    cases = []
    for cout in (64, 128):
        wt = torch.from_numpy((rng.normal(size=(cout, c, 3, 3)) * 0.05).astype(np.float32)).to(dev)
        bias = torch.from_numpy((rng.normal(size=(cout,)) * 0.1).astype(np.float32)).to(dev)
        ops = conv3x3_operands(wt, bias)
        ref = conv3x3_plain(x, wt, bias).float()
        out = torch.empty(ref.shape, dtype=torch.bfloat16, device=dev,
                          memory_format=torch.channels_last)

        def launch(lib, stream, ops=ops, out=out, cout=cout):
            return lib.ssl_conv3x3(xk.data_ptr(), ops[0].data_ptr(), ops[1].data_ptr(),
                                   out.data_ptr(), b, c, cout, h, w, 1, 0, stream)

        wl, bl = wt.to(torch.bfloat16), bias.to(torch.bfloat16)
        cases.append((f"COUT {cout} at {SHAPES[64]}", launch, [out], [ref], 2e-2,
                      lambda wl=wl, bl=bl: F.relu(F.conv2d(xk, wl, bl, padding=1))))
    return cases


def attn_bwd_cases(torch, dev, rng):
    from superslam_tpu_torch.ops.cuda.attention import (
        attention_row_stats_plain,
        masked_attention_backward_plain,
        masked_attention_plain,
    )

    b, h, n, d = ATTN_SHAPE
    q, k, v, g = (torch.from_numpy(rng.standard_normal(ATTN_SHAPE).astype(np.float32)).to(dev)
                  for _ in range(4))
    mask = torch.from_numpy(np.arange(n)[None] < rng.integers(n // 2, n + 1, size=b)[:, None])
    mask = mask.to(dev)
    mask[3] = False
    out = masked_attention_plain(q, k, v, mask)
    stats = attention_row_stats_plain(q, k, mask).contiguous()
    refs = [t.float() for t in masked_attention_backward_plain(q, k, v, mask, g)]
    grads = [torch.empty_like(q) for _ in range(3)]

    def launch(lib, stream):
        return lib.ssl_masked_attention_bwd(
            *(t.data_ptr() for t in (q, k, v, mask, g, out, stats, *grads)), b, h, n, 0, stream)

    return [(f"f32 at {ATTN_SHAPE}", launch, grads, refs, 1e-4, None)]


def _serve_mask(torch, dev, rng, b, n):
    """70% real keys, batch row 1 fully masked (the keyframe side before the
    first keyframe)."""
    mask = torch.from_numpy(rng.uniform(size=(b, n)) < 0.7).to(dev)
    mask[1] = False
    return mask


def attn_fwd_cases(torch, dev, rng):
    """bf16 at the serving shape and f32 at the training shape, each with
    scaled_dot_product_attention on the same inputs as the library call (a
    fully-masked row unmasked for it: the library has no replaced logits)."""
    import torch.nn.functional as F

    from superslam_tpu_torch.ops.cuda.attention import masked_attention_plain

    cases = []
    for dtype, shape in ((torch.bfloat16, SERVE_ATTN_SHAPE), (torch.float32, ATTN_SHAPE)):
        b, h, n, d = shape
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
                   for _ in range(3))
        if dtype == torch.bfloat16:
            mask = _serve_mask(torch, dev, rng, b, n)
        else:
            mask = torch.from_numpy(
                np.arange(n)[None] < rng.integers(n // 2, n + 1, size=b)[:, None]).to(dev)
            mask[3] = False
        ref = masked_attention_plain(q, k, v, mask).float()
        out = torch.empty_like(q)
        lib_mask = mask[:, None, None, :].clone()
        lib_mask[~mask.any(dim=1)] = True

        def launch(lib, stream, q=q, k=k, v=v, mask=mask, out=out, shape=shape, dtype=dtype):
            b, h, n, _ = shape
            return lib.ssl_masked_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                            mask.data_ptr(), out.data_ptr(), None, b, h, n,
                                            int(dtype == torch.bfloat16), stream)

        limit = 2e-2 if dtype == torch.bfloat16 else 1e-4
        cases.append((f"{str(dtype)[6:]} at {shape}", launch, [out], [ref], limit,
                      lambda q=q, k=k, v=v, m=lib_mask: F.scaled_dot_product_attention(
                          q, k, v, attn_mask=m)))
    return cases


def block_cases(torch, dev, rng):
    """The self and the cross block at the serving shape, bf16."""
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.ops.cuda import lightglue_layer as lgl

    b, k, _ = BLOCK_SHAPE
    params = init_lightglue_params(seed=2)
    for name in list(params):  # non-trivial biases and LayerNorm parameters
        if name.endswith(".bias") or ".ffn.1." in name:
            params[name] = params[name] + torch.from_numpy(
                rng.normal(0, 0.1, tuple(params[name].shape)).astype(np.float32))
    params = {n: t.to(dev) for n, t in params.items()}
    x = torch.from_numpy(rng.standard_normal(BLOCK_SHAPE).astype(np.float32)).to(dev, torch.bfloat16)
    angles = torch.from_numpy(rng.uniform(-3, 3, (b, k, 32)).astype(np.float32)).to(dev)
    cos, sin = torch.cos(angles), torch.sin(angles)
    mask = _serve_mask(torch, dev, rng, b, k)
    cases = []
    for kind in ("self", "cross"):
        prefix = f"transformers.0.{kind}_attn"
        if kind == "self":
            w = lgl.prep_self_weights(params, prefix, torch.bfloat16)
            ref = lgl.fused_self_block_plain(x, cos, sin, mask, w).float()
        else:
            w = lgl.prep_cross_weights(params, prefix, torch.bfloat16)
            ref = lgl.fused_cross_block_plain(x, mask, w).float()
        groups = 3 if kind == "self" else 2
        qkv = torch.empty((groups, b, 4, k, 64), dtype=torch.bfloat16, device=dev)
        ctx, out = torch.empty_like(x), torch.empty_like(x)

        def launch(lib, stream, kind=kind, w=w, qkv=qkv, ctx=ctx, out=out):
            ptrs = [t.data_ptr() for t in w] + [qkv.data_ptr(), ctx.data_ptr(), out.data_ptr()]
            if kind == "self":
                return lib.ssl_fused_self_block(x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                                                mask.data_ptr(), *ptrs, b, k, 1, stream)
            return lib.ssl_fused_cross_block(x.data_ptr(), mask.data_ptr(), *ptrs, b, k, 1,
                                             stream)

        cases.append((f"{kind} block at {BLOCK_SHAPE}", launch, [out], [ref], 2e-2, None))
    return cases


def nms_cases(torch, dev, rng):
    """The logits mode with its pre-NMS map (the main path's call: the
    sub-pixel refinement reads it) and the map mode. A reference may be a
    function of the variant's outputs: the NMS'd map is held to nms_plain of
    the kernel's own pre-NMS map."""
    import torch.nn.functional as F

    from superslam_tpu_torch.ops.cuda.nms import nms_plain, scores_nms_plain

    logits = torch.from_numpy((rng.standard_normal(LOGITS_SHAPE) * 4).astype(np.float32))
    logits = logits.to(dev).contiguous(memory_format=torch.channels_last)
    b, _, h, w = LOGITS_SHAPE
    _, ref_pre = scores_nms_plain(logits, 4, return_pre=True)
    pre, out = torch.empty_like(ref_pre), torch.empty_like(ref_pre)

    def launch_logits(lib, stream):
        return lib.ssl_scores_nms(logits.data_ptr(), pre.data_ptr(), out.data_ptr(), b, h, w,
                                  4, stream)

    def library_logits():
        p = F.pixel_shuffle(torch.softmax(logits, dim=1)[:, :-1], 8)
        return torch.where(p == F.max_pool2d(p, 9, 1, 4), p, 0.0)

    s = rng.uniform(0, 1, (2, 384, 1248)) ** 6
    s = torch.from_numpy((np.round(s * 4096) / 4096).astype(np.float32)).to(dev)
    s_out = torch.empty_like(s)

    def launch_map(lib, stream):
        return lib.ssl_nms(s.data_ptr(), s_out.data_ptr(), 2, 384, 1248, 4, stream)

    def library_map():
        p = F.max_pool2d(s[:, None], 9, 1, 4)[:, 0]
        return torch.where(s == p, s, 0.0)

    return [
        (f"logits {LOGITS_SHAPE}", launch_logits, [pre, out],
         [ref_pre, lambda: nms_plain(pre, 4)], 1e-6, library_logits),
        ("map (2, 384, 1248)", launch_map, [s_out], [nms_plain(s, 4)], 0.0, library_map),
    ]


def gather_cases(torch, dev, rng):
    """Each GATHER_SHAPES grid (unit rows) with random int64 cells, both
    corners among them."""
    import torch.nn.functional as F

    from superslam_tpu_torch.ops.cuda.gather import gather_normalize_plain

    cases = []
    for label, b, g, k, dtype in GATHER_SHAPES:
        grid = torch.from_numpy(rng.standard_normal((b, g, 256)).astype(np.float32)).to(dev)
        grid = F.normalize(grid, dim=-1).to(getattr(torch, dtype))
        cells = torch.from_numpy(rng.integers(0, g, size=(b, k))).to(dev)
        cells[:, :2] = torch.tensor([0, g - 1], device=dev)
        flat_grid = grid.reshape(-1, 256)
        flat_cells = (cells + torch.arange(b, device=dev)[:, None] * g).reshape(-1)
        out = torch.empty((b, k, 256), dtype=torch.float32, device=dev)

        def launch(lib, stream, grid=grid, cells=cells, out=out, b=b, g=g, k=k):
            return lib.ssl_gather_normalize(grid.data_ptr(), cells.data_ptr(), out.data_ptr(),
                                            b, g, k, 256, int(grid.dtype == torch.bfloat16),
                                            stream)

        cases.append((f"{label} ({b}, {g}, 256) {dtype}, {k} cells", launch, [out],
                      [gather_normalize_plain(grid, cells)], 1e-5,
                      lambda fg=flat_grid, fc=flat_cells: F.normalize(
                          fg.index_select(0, fc).float(), dim=-1)))
    return cases


def _track_arrays(rng, k, usable, noise_px=0.3, since=0):
    """tests/test_torch_track_frame_model.py's ``_case``: a keyframe at the
    origin, the camera at (0.1, 0, 0.2) with noisy stereo projections of
    its points, the first ``usable`` matched, every ninth frame feature
    without stereo; the carry's previous pose at (0.05, 0, 0.1) and a
    constant-velocity step of the same. Numpy arrays."""
    fx, fy, cx, cy, b = TRACK_CALIB
    z = rng.uniform(3.0, 12.0, k)
    xw = np.stack([(rng.uniform(20, 620, k) - cx) * z / fx, (rng.uniform(20, 332, k) - cy) * z / fy,
                   z], 1)
    p = xw - np.asarray((0.1, 0.0, 0.2))
    kl = np.stack([fx * p[:, 0] / p[:, 2] + cx, fy * p[:, 1] / p[:, 2] + cy], 1)
    kl += rng.normal(0, noise_px, kl.shape)
    disp = fx * b / p[:, 2] + rng.normal(0, noise_px, k)
    tm = np.where(np.arange(k) < usable, np.arange(k), -1).astype(np.int32)
    f32 = np.float32
    frame = dict(kl=kl.astype(f32), nkl=((kl - 320.0) / 320.0).astype(f32),
                 dl=rng.normal(size=(k, TRACK_D)).astype(f32), vl=rng.uniform(size=k) < 0.9,
                 disp=disp.astype(f32), stereo_ok=np.ones(k, bool))
    frame["stereo_ok"][::9] = False
    kf = dict(nk=rng.normal(size=(k, 2)).astype(f32), desc=rng.normal(size=(k, TRACK_D)).astype(f32),
              valid=np.ones(k, bool), xw=xw.astype(f32), dok=np.ones(k, bool),
              since=np.asarray(since, np.int32))
    eye = np.eye(3, dtype=f32)
    step = np.asarray((0.05, 0.0, 0.1), f32)
    carry = np.concatenate([eye.ravel(), step, eye.ravel(), step]).astype(f32)
    return frame, kf, carry, tm


def _twin_iterations(torch, frame, kf, carry, tm, mono, keyframes):
    """The plain twin on the CPU: its row and its LM iterations (its
    _system calls), and the iterations of the frozen variants, whose pose
    never moves: each LM solve runs until lambda passes 1e8 (or
    track_iters), and the chi2 rounds count at the start pose."""
    from superslam_tpu_torch.ops import pose_solver
    from superslam_tpu_torch.ops.cuda import pose_solve as ps
    from superslam_tpu_torch.ops.cuda.track_frame import track_frame_plain

    t = torch.from_numpy
    c = t(carry)
    pose_carry = (c[:9].view(3, 3), c[9:12], c[12:21].view(3, 3), c[21:24])
    args = (pose_carry, tuple(t(frame[n]) for n in ("kl", "nkl", "dl", "vl", "disp", "stereo_ok")),
            t(tm), tuple(t(kf[n]) for n in ("nk", "desc", "valid", "xw", "dok", "since")))
    kw = dict(calib=TRACK_CALIB, mono=mono, keyframes=keyframes, **TRACK_SOLVE)
    iters, system, lm = [], pose_solver._system, ps.pose_only_lm_impl
    pose_solver._system = lambda *a, **k: iters.append(1) or system(*a, **k)
    try:
        row = track_frame_plain(*args, **kw)[0]
    finally:
        pose_solver._system = system
    lam, stop = np.float32(1e-5), 0
    while stop < TRACK_SOLVE["track_iters"] and not lam > 1e8:
        lam, stop = np.float32(lam * np.float32(10)), stop + 1
    solves = []
    ps.pose_only_lm_impl = lambda R, t_, *a, **k: solves.append(stop) or (R, t_)
    try:
        track_frame_plain(*args, **kw)
    finally:
        ps.pose_only_lm_impl = lm
    return row, len(iters), sum(solves)


def track_frame_cases(torch, dev, rng):
    """track_kf_scan's epilogue at K 600, mono track_scan at K 1000 and the
    batched kernel at each Q of TRACK_Q, K 600. Outputs: the row's poses
    (within 1e-3 of the twin's) and its counts (exact)."""
    fx, fy, cx, cy, b = TRACK_CALIB
    sv = TRACK_SOLVE
    stream_args = lambda mono: [fx, fy, cx, cy, b, sv["min_matches"], sv["inv_sig_uLv"],  # noqa: E731
                                sv["disp_sigma0"], sv["disp_cond"], int(mono), sv["gate_px"],
                                sv["chi2_px"], sv["chi2_rounds"], sv["track_iters"]]
    g = TRACK_GATE
    cases = []
    for label, k, mono, kfmode in ((f"track_kf_scan's epilogue, K {TRACK_K}", TRACK_K, False, True),
                                   (f"mono track_scan, K {TRACK_MONO_K}", TRACK_MONO_K, True, False)):
        frame, kf, carry, tm = _track_arrays(rng, k, usable=k * 5 // 6)
        ref, iters, frozen = _twin_iterations(torch, frame, kf, carry, tm, mono,
                                              TRACK_GATE if kfmode else None)
        d = {n: torch.from_numpy(np.asarray(a)).to(dev) for n, a in
             {**frame, **{f"kf_{n}": a for n, a in kf.items()}, "carry": carry, "tm": tm}.items()}
        cols = ref.numel()
        row = torch.empty(cols, dtype=torch.float32, device=dev)
        match = torch.empty(k, dtype=torch.int32, device=dev)
        small = torch.empty(36 + 5 * k, dtype=torch.float32, device=dev)
        stats = torch.empty(3, dtype=torch.int32, device=dev)
        new_desc, flags = torch.empty_like(d["kf_desc"]), torch.empty(2 * k + 1, dtype=torch.bool,
                                                                      device=dev)
        ptr = lambda n: d[n].data_ptr()  # noqa: E731
        if kfmode:
            kf_ptrs = [ptr(n) for n in ("nkl", "dl", "vl", "kf_nk", "kf_desc", "kf_valid",
                                        "kf_since")] + [0]
            out_ptrs = [small[36:].data_ptr(), new_desc.data_ptr(), flags.data_ptr(),
                        small[36 + 2 * k:].data_ptr(), flags[k:].data_ptr(), flags[2 * k:].data_ptr()]
            tail = [1, g["accept_frac"], g["support_px"], g["kf_min_frames"], g["kf_max_frames"],
                    g["kf_min_matches"], g["covis_ratio"], fx * b]
        else:
            kf_ptrs, out_ptrs = [0] * 8, [0] * 6
            tail = [0, 0.0, 0.0, 0, 0, 0, 0.0, fx * b]
        args = ([ptr("carry"), ptr("kl"), ptr("disp"), ptr("stereo_ok"), ptr("tm"), 0,
                 ptr("kf_xw"), ptr("kf_dok"), *kf_ptrs, row.data_ptr(), match.data_ptr(),
                 small.data_ptr(), stats.data_ptr(), *out_ptrs, k,
                 new_desc.numel() * 4 if kfmode else 0, *stream_args(mono)[:14], *tail])

        def launch(lib, stream, args=args, keep=(d, row, match, small, stats, new_desc, flags)):
            return lib.ssl_track_frame(*args, stream)  # keep: what args point into

        ref = ref.to(dev)
        cases.append((label, launch, [row[:12], row[12:]], [ref[:12], ref[12:]], [1e-3, 0.0],
                      None, (iters, frozen), lambda stats=stats: int(stats[2])))
    for q in TRACK_Q:
        seqs = [_track_arrays(rng, TRACK_K, usable=TRACK_K * 5 // 6) for _ in range(q)]
        twins = [_twin_iterations(torch, *s_, False, None) for s_ in seqs]
        stack = lambda key, src: torch.from_numpy(  # noqa: E731
            np.stack([s_[src][key] if key else s_[src] for s_ in seqs])).to(dev)
        carry = stack(None, 2)
        kl, disp, sok = stack("kl", 0), stack("disp", 0), stack("stereo_ok", 0)
        tm, xw, dok = stack(None, 3), stack("xw", 1), stack("dok", 1)
        rows = torch.empty((q, 13), dtype=torch.float32, device=dev)
        small = torch.empty((q, 36), dtype=torch.float32, device=dev)
        stats = torch.empty((q, 3), dtype=torch.int32, device=dev)
        pairs = [(t_.data_ptr(), t_.stride(0)) for t_ in (carry, kl, disp, sok, tm, xw, dok, rows,
                                                           small, stats)]
        args = [q, *(a for pair in pairs for a in pair), TRACK_K, *stream_args(False)]

        def launch(lib, stream, args=args,
                   keep=(carry, kl, disp, sok, tm, xw, dok, rows, small, stats)):
            return lib.ssl_track_frame_batched(*args, stream)  # keep: what args point into

        ref = torch.stack([r for r, _, _ in twins]).to(dev)
        cases.append((f"track_frame_batched, Q {q}, K {TRACK_K}", launch, [rows[:, :12], rows[:, 12]],
                      [ref[:, :12], ref[:, 12]], [1e-3, 0.0], None,
                      (max(i for _, i, _ in twins), max(f for _, _, f in twins)),
                      lambda stats=stats: int(stats[:, 2].max())))
    for label, *_, (iters, frozen), _probe in cases:
        print(f"{label}: the twin's LM iterations {iters} (the longest sequence's when batched); "
              f"the frozen variants' {frozen}")
    return cases


def main(argv: list[str]) -> int:
    import torch

    from superslam_tpu_torch.ops.cuda import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="pair")
    ap.add_argument("--source", default=SRC,
                    help="the kernel sources' directory (default: this checkout's); another "
                         "commit's, unpacked, times its kernel in the same call")
    ap.add_argument("--graph", action="store_true",
                    help="time 50 launches captured in a CUDA graph, not issued from the host")
    ap.add_argument("--device-time", action="store_true",
                    help="also print each call's device time from torch.profiler")
    ap.add_argument("--cold", action="store_true",
                    help="with --device-time, also after a 64 MB write that evicts L2")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(f"card: {smi.stdout.strip() or 'not readable'}")
    kernel = args.kernel
    variants = parse(args.variants or KERNELS[kernel][2])
    entries = {"pair": ("ssl_conv_pair_pool", "ssl_conv_pair"), "conv3x3": ("ssl_conv3x3",),
               "attn_bwd": ("ssl_masked_attention_bwd",),
               "attn_fwd": ("ssl_masked_attention",),
               "block": ("ssl_fused_self_block", "ssl_fused_cross_block"),
               "nms": ("ssl_scores_nms", "ssl_nms"), "nms_map": ("ssl_nms",),
               "track_frame": ("ssl_track_frame", "ssl_track_frame_batched"),
               "gather": ("ssl_gather_normalize",)}[kernel]

    jobs = {}
    for name, (consts, patches) in variants.items():
        src = write_variant(kernel, name, consts, patches, SOURCES.get(name, args.source))
        lib = os.path.join(os.path.dirname(src), "lib.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, src]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            print(f"{name}: build failed\n{log[-3000:]}")
            return 1
        for block in log.split("Compiling entry function '")[1:]:
            entry = block.split("'")[0]
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            print(f"{name}: {entry}: {regs and regs.group(1)} registers, "
                  f"{spill and spill.group(1)} B spill stores")
        lib = ctypes.CDLL(path)
        for fn in entries:
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        libs[name] = lib

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    cases = {"pair": pair_cases, "conv3x3": conv3x3_cases, "attn_bwd": attn_bwd_cases,
             "attn_fwd": attn_fwd_cases, "block": block_cases,
             "nms": nms_cases,
             "nms_map": lambda *a: nms_cases(*a)[1:],
             "track_frame": track_frame_cases, "gather": gather_cases}[kernel](torch, dev, rng)

    def call(lib, launch):
        err = launch(lib, torch.cuda.current_stream().cuda_stream if args.graph else stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")

    bad = False
    for name, lib in libs.items():
        if not set(variants[name][1]) <= EXACT_PATCHES:
            continue
        for label, launch, outs, refs, limits, *_ in cases:
            call(lib, launch)
            torch.cuda.synchronize()
            for j, (out, ref) in enumerate(zip(outs, refs)):
                ref = ref() if callable(ref) else ref
                limit = limits[j] if isinstance(limits, list) else limits
                rel = (out.float() - ref).abs().max().item() / ref.abs().max().item()
                print(f"{name} {label}: max error / max|plain| {rel:.3g} (limit {limit:g})")
                if not rel <= limit:
                    print(f"{name} {label}: got {out.flatten()[:16].tolist()}, plain "
                          f"{ref.flatten()[:16].tolist()}")
                    bad = True
    if bad:
        return 1

    # A counting variant's own LM iterations on each case (the longest
    # sequence's when batched), against the twin's.
    for name, lib in libs.items():
        if any(p.startswith("lmcount") for p in variants[name][1]):
            for c in cases:
                call(lib, c[1])
                torch.cuda.synchronize()
                print(f"{name} {c[0]}: the kernel's LM iterations {c[7]()}, the twin's {c[6][0]}")

    def graph_ms(fn, n):
        """n calls captured in one CUDA graph (after warm-up calls on the
        capturing stream), one replay between two events."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev) if args.cold else None

    def device_ms(fn, n=20, cold=False):
        """Sum of the kernels' own device durations over n calls, a call;
        and the kernels a call. cold: each call after the L2-evicting write
        (its int8 fill left out of the sums)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if cold:
                    flush.fill_(1)
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if "CPU" not in str(getattr(e, "device_type", "CPU"))
                and (getattr(e, "self_device_time_total", 0) or 0) > 0
                and not (cold and "FillFunctor<signed char>" in e.key)]
        return (sum(e.self_device_time_total for e in rows) / 1e3 / n,
                sum(e.count for e in rows) / n)

    def per_call_ms(fn, n=50):
        if args.graph:
            return graph_ms(fn, n)
        for _ in range(5):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    # Each variant's call of each case, and the library call where a case
    # has one, in turns.
    fns = {name: [lambda c=c, lib=lib: call(lib, c[1]) for c in cases] for name, lib in libs.items()}
    if any(c[5] for c in cases):
        fns["library"] = [c[5] for c in cases]
    if kernel == "gather":  # the launch floor: a one-element fill
        one = torch.empty(1, device=dev)
        fns["fill"] = [lambda: one.fill_(1.0)] + [None] * (len(cases) - 1)
    times = {(name, i): [] for name, row in fns.items() for i, fn in enumerate(row) if fn}
    order = list(fns)
    for rnd in range(4):
        for name in order if rnd % 2 == 0 else order[::-1]:
            for i, fn in enumerate(fns[name]):
                if fn:
                    times[(name, i)].append(per_call_ms(fn))
    for (name, i), ts in times.items():
        per_iter = ""
        if len(cases[i]) > 6:  # (the twin's LM iterations, the frozen variants')
            frozen = any(p.startswith("frozen") for p in variants.get(name, ({}, []))[1])
            n = cases[i][6][1 if frozen else 0]
            per_iter = f", {statistics.median(ts) / n * 1e3:.3f} us an LM iteration over {n}"
        label = "one-element fill_ (the launch floor)" if name == "fill" else cases[i][0]
        how = "in a CUDA graph" if args.graph else "back to back"
        print(f"time {kernel} {name} {label}: median {statistics.median(ts):.4f} ms a call "
              f"over 4 x 50 launches {how} ({', '.join(f'{t:.4f}' for t in ts)}){per_iter}")
    if args.device_time:
        for name in order:
            for i, fn in enumerate(fns[name]):
                if fn:
                    ms, kernels = device_ms(fn)
                    label = "one-element fill_ (the launch floor)" if name == "fill" else cases[i][0]
                    cold = ""
                    if args.cold:
                        cold = f"; after a 64 MB write {device_ms(fn, cold=True)[0]:.4f} ms"
                    print(f"device {kernel} {name} {label}: {ms:.4f} ms a call ({kernels:g} "
                          f"kernels a call, torch.profiler over 20 calls){cold}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
