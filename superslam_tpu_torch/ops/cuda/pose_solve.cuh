// The per-frame pose-only stereo solve on one block, shared by the two
// kernels that run it: pose_solve.cu (the solve alone) and track_frame.cu
// (the whole per-frame body of the device tracking scans around it).
//
// What it computes, for the K keyframe features of one frame (the port of
// superslam_tpu/ops/frontend_step.py::_frame_solve (:381) around
// superslam_tpu/ops/pose_solver.py::pose_only_lm_impl (:159); the plain
// twin is ops/cuda/pose_solve.py::pose_solve_plain):
// - the matched measurements (uL, uL - d, v) of the frame's keypoint that
//   each keyframe feature matched, the disparity-aware inverse sigmas
//   (uR weight 0 in mono mode) and the usable mask ok (n = sum(ok));
// - the prior gate: keep the matches within gate_px of their reprojection
//   at the constant-velocity prediction (R_pred, t_pred) when at least
//   min_matches survive, else every usable match (gate_px <= 0: no gate);
// - the LM from (R_prev, t_prev), with lax.while_loop's semantics: Huber-
//   IRLS normal equations, a solve of H + lambda I by LU with partial
//   pivoting, a non-finite step rejected, lambda x0.1 on an accepted step
//   and x10 on a rejected one, a stop when an accepted step improves the
//   error by less than 1e-4 of it or lambda passes 1e8, at most track_iters
//   iterations;
// - chi2_rounds re-solves on ok & (z > 0.1) & (reprojection < chi2_px); the
//   first round with fewer than min_matches inliers ends the rounds.
//
// The schedule: the chain of LM iterations runs on one SM (the bound on
// the H100 is bytes, well under a microsecond: ~20 KB in, and ~600 points x
// ~150 f32 operations an iteration is ~0.1 MFLOP), so what an iteration
// costs is its chain of dependent steps and the instructions two warps a
// scheduler issue for it (on an H100: ~2.6 us, the LU 42% of it,
// the pass 39%). An iteration is one pass, one reduction, one barrier and
// no one-thread section:
// - one pass over the points: THREADS threads keep their PPT points' world
//   points, measurements and weights in registers for the whole solve, and
//   evaluate at the step's trial pose its robust error and its 21 + 6
//   normal-equation sums together (28 sums; a point's terms as D^T M D,
//   point_terms; each thread's points in one straight run, ceil(K /
//   THREADS) of them, padding adding zeros). On acceptance they are the
//   next iteration's system; on a rejection the pose does not move, so the
//   system the JAX loop would rebuild at it is the one already held: only
//   lambda changes and the next solve touches no point. The LM's opening
//   error pass yields the first system, and each chi2 round opens with one
//   such pass on its mask. The accept / reject sequence, the iteration
//   count and the stop are pose_only_lm_impl's (a non-finite step retracts
//   by zero, to the pose itself, and is rejected, as there). The pass's
//   code appears once: the LM opens with an iteration that evaluates the
//   pose, and every solve of the frame is one call site;
// - one reduction: a reduce-scatter of the 28 sums (padded to 32) inside
//   each warp, 16 + 8 + 4 + 2 + 1 = 31 shuffles, leaves lane L with the
//   warp's sum of value L (pairing lanes by bit 4, 3, ..., 0: the order of
//   a butterfly); the warps' partials go to shared memory in the buffer of
//   the reduction's parity, so the next reduction's writes need no second
//   barrier; after one __syncthreads every warp adds the WARPS partials of
//   its lane's value in warp order, and the system stays spread over the
//   lanes, value L in lane L, identical in every warp;
// - no one-thread section: every thread fetches the system by shuffles and
//   runs the 6 x 6 LU (partial pivoting, the first largest pivot, one
//   reciprocal a pivot), the SE(3) exponential and the accept / lambda /
//   stop decision on the same bits, so no barrier publishes a trial pose or
//   a stop flag; the step's finiteness is a vote, so the compiler knows
//   every branch of the loop is taken by whole warps and emits no divergent
//   path for its shuffles. Counts (the gate, the chi2 rounds, kept) are
//   ballots and one such reduction.
// The tensor cores are left out: J^T W J is a (6 x 3K) by (3K x 6) product,
// about 100 FMAs a thread an iteration, and its f32 answer would need three
// TF32 products (3xTF32) and a fragment layout for a sum the warp
// reduction already makes in a few dozen cycles. The LU a row a lane
// (pivot by a lane argmax, swaps by shuffles) measured slower than every
// lane running it in registers: its shuffles lengthen the chain.
//
// Arithmetic is f32, IEEE divisions and square roots, as in the JAX
// program; the sums run in another order than PyTorch's, so the kernels
// agree with the twin to rounding, not bits.
#pragma once

#include "common.cuh"

namespace pose {

constexpr int THREADS = 256;
constexpr int PPT = 4;                // points a thread
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = THREADS * PPT;   // 1024 correspondences
constexpr int NSYS = 27;              // 21 of H's upper triangle + 6 of g
constexpr int ERR = NSYS;             // the robust error, the 28th sum
constexpr float HUBER_K = 2.7955f;    // sqrt(7.815)
constexpr unsigned FULL = 0xffffffffu;
static_assert(KMAX == 1024, "the wrappers take K <= 1024");

struct Params {
  float fx, fy, cx, cy, baseline;
  float inv_sig_uLv, disp_sigma0, disp_cond, gate_px, chi2_px;
  int K, min_matches, mono, chi2_rounds, track_iters;
};

// torch.clamp(x, min=m): NaN stays NaN (fmaxf would drop it).
__device__ __forceinline__ float clamp_min(float x, float m) { return x < m ? m : x; }

// The block's reductions: each warp's partials, in the buffer of the
// reduction's parity.
struct Shared {
  float part[2][WARPS][32];
};

// One stage of the warp's reduce-scatter: a lane holds 2 O values; the one
// whose bit O is set keeps the upper O and sends the lower, its partner the
// reverse, and each adds what it receives to what it kept.
template <int O>
__device__ __forceinline__ void scatter_stage(float (&v)[32], int lane) {
  const bool hi = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float keep = hi ? v[j + O] : v[j];
    const float send = hi ? v[j] : v[j + O];
    v[j] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

// The block's reductions, each one barrier. phase counts them (the same in
// every thread) and picks the buffer.
struct Reducer {
  Shared& s;
  int phase;

  // Totals of the 32 per-thread values v (clobbered): lane L returns the
  // block's sum of value L.
  __device__ __forceinline__ float sum(float (&v)[32]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    scatter_stage<16>(v, lane);
    scatter_stage<8>(v, lane);
    scatter_stage<4>(v, lane);
    scatter_stage<2>(v, lane);
    scatter_stage<1>(v, lane);
    float (*part)[32] = s.part[phase++ & 1];
    part[warp][lane] = v[0];
    __syncthreads();
    float t = part[0][lane];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) t += part[w][lane];
    return t;
  }

  // How many of the block's points hold b (every thread gets the count).
  __device__ __forceinline__ int count(const bool (&b)[PPT]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int c = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) c += __popc(__ballot_sync(FULL, b[k]));
    float (*part)[32] = s.part[phase++ & 1];
    if (lane == 0) part[warp][0] = float(c);
    __syncthreads();
    int t = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += int(part[w][0]);
    return t;
  }
};

// p = R^T (X - t), the row form (X - t) @ R of the PyTorch code.
__device__ __forceinline__ void to_camera(const float* P, float X, float Y, float Z,
                                          float& p0, float& p1, float& p2) {
  const float dx = X - P[9], dy = Y - P[10], dz = Z - P[11];
  p0 = dx * P[0] + dy * P[3] + dz * P[6];
  p1 = dx * P[1] + dy * P[4] + dz * P[7];
  p2 = dx * P[2] + dy * P[5] + dz * P[8];
}

// Stereo residuals (uL, uR, v) with the cheirality escape hatch.
__device__ __forceinline__ void residual(const Params& q, float p0, float p1, float p2,
                                         float m0, float m1, float m2, bool& good, float& iz,
                                         float (&r)[3]) {
  good = p2 > 1e-9f;
  iz = 1.f / (good ? p2 : 1.f);
  r[0] = q.fx * p0 * iz + q.cx - m0;
  r[1] = q.fx * (p0 - q.baseline) * iz + q.cx - m1;
  r[2] = q.fy * p1 * iz + q.cy - m2;
  if (!good) r[0] = r[1] = r[2] = 2.f * q.fx;
}

__device__ __forceinline__ float huber(float n) {
  return n <= HUBER_K ? 0.5f * n * n : HUBER_K * n - 0.5f * HUBER_K * HUBER_K;
}

// Reprojection distance of the left keypoint (the gate's, chi2's and the
// support count's residual) and z > 0.1.
__device__ __forceinline__ float reproj(const Params& q, const float* P, float X, float Y,
                                        float Z, float u, float v, bool& zok) {
  float p0, p1, p2;
  to_camera(P, X, Y, Z, p0, p1, p2);
  zok = p2 > 0.1f;
  const float zs = zok ? p2 : 1.f;
  return hypotf(q.fx * p0 / zs + q.cx - u, q.fy * p1 / zs + q.cy - v);
}

// Solve A x = b (A, b clobbered) by LU with partial pivoting (the first
// largest pivot, as LAPACK's getrf) and back substitution; one reciprocal
// a pivot, by which the column's multipliers and the unknown are scaled
// (getrf scales the column by it too), so the chain holds 6 divisions, not
// 21. Returns whether every x is finite.
__device__ __forceinline__ bool lu_solve(float (&A)[6][6], float (&b)[6], float (&x)[6]) {
  float inv[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int p = c;
    float best = fabsf(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(A[r][c]) > best) {
        best = fabsf(A[r][c]);
        p = r;
      }
    // The swap with compile-time row indices keeps A in registers; the
    // eliminated columns k < c are not read again.
#pragma unroll
    for (int r = c + 1; r < 6; ++r)
      if (r == p) {
#pragma unroll
        for (int k = c; k < 6; ++k) {
          const float tmp = A[c][k];
          A[c][k] = A[r][k];
          A[r][k] = tmp;
        }
        const float tb = b[c];
        b[c] = b[r];
        b[r] = tb;
      }
    inv[c] = 1.f / A[c][c];
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[r][c] * inv[c];
#pragma unroll
      for (int k = c + 1; k < 6; ++k) A[r][k] -= f * A[c][k];
      b[r] -= f * b[c];
    }
  }
  bool finite = true;
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    float acc = b[r];
#pragma unroll
    for (int k = r + 1; k < 6; ++k) acc -= A[r][k] * x[k];
    x[r] = acc * inv[r];
    finite = finite && isfinite(x[r]);
  }
  return finite;
}

// The pose P (R row-major, t) retracted by the step x: the SE(3)
// exponential (rotation first), as ops/pose_solver.py::_se3_exp, then
// R dR, R dt + t.
__device__ __forceinline__ void retract(const float (&P)[12], const float (&x)[6],
                                        float (&out)[12]) {
  const float w0 = x[0], w1 = x[1], w2 = x[2];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float W2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  const float th = sqrtf(th2 + 1e-20f);
  const bool small = th2 < 1e-12f;
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float a = small ? 1.f : sn / th;
  const float bb = small ? 0.5f : (1.f - cs) / th2;
  const float cc = small ? 1.f / 6.f : (th - sn) / (th2 * th);
  float dR[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.f : 0.f;
      dR[i][j] = e + a * W[i][j] + bb * W2[i][j];
      V[i][j] = e + bb * W[i][j] + cc * W2[i][j];
    }
  float dt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dt[i] = V[i][0] * x[3] + V[i][1] * x[4] + V[i][2] * x[5];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = P[3 * i] * dR[0][j] + P[3 * i + 1] * dR[1][j] + P[3 * i + 2] * dR[2][j];
    out[9 + i] = P[3 * i] * dt[0] + P[3 * i + 1] * dt[1] + P[3 * i + 2] * dt[2] + P[9 + i];
  }
}

struct Points {
  float X[PPT], Y[PPT], Z[PPT];     // keyframe world points
  float m0[PPT], m1[PPT], m2[PPT];  // (uL, uR, v)
  float su[PPT];                    // uR inverse sigma
  float u[PPT], v[PPT];             // (uL, v) for the reprojection residual
  float keep[PPT];                  // the LM's 0/1 mask
  bool ok[PPT];                     // usable match
};

// Point k's 21 + 6 normal-equation terms and robust error at the pose P,
// added to acc (the thread's part of H's upper triangle row by row, g and
// the error). A point past K, or not kept, adds exact zeros: keep is 0 and
// its residual finite (su 0, the cheirality hatch), so its weights are 0.
//
// The point's three rows J_i = Jp_i D (Jp the projection's Jacobian, D =
// [[p]x | -I] the camera point's derivative) enter H = sum_i W_i J_i^T J_i
// (W_i = w sig_i^2) as D^T M D with M = sum_i W_i Jp_i^T Jp_i, a 3 x 3 of
// five nonzero entries: H_ww = [p]x^T M [p]x, H_wt = -(M [p]x)^T, H_tt = M,
// and g = D^T gp with gp = sum_i W_i r_i Jp_i^T. The same sums as J^T W J
// row by row in about half the operations.
__device__ __forceinline__ void point_terms(const Params& q, const Points& pt, int k,
                                            const float* P, float (&acc)[32]) {
  float p0, p1, p2, iz, r[3];
  bool good;
  to_camera(P, pt.X[k], pt.Y[k], pt.Z[k], p0, p1, p2);
  residual(q, p0, p1, p2, pt.m0[k], pt.m1[k], pt.m2[k], good, iz, r);
  const float s0 = q.inv_sig_uLv, s1 = pt.su[k];
  const float rw0 = r[0] * s0, rw1 = r[1] * s1, rw2 = r[2] * s0;
  const float nrm = sqrtf(rw0 * rw0 + rw1 * rw1 + rw2 * rw2);
  const float w = (nrm <= HUBER_K ? 1.f : HUBER_K / clamp_min(nrm, 1e-12f)) * pt.keep[k];
  acc[ERR] += huber(nrm) * pt.keep[k];
  // Jp = [[a, 0, cu], [a, 0, cr], [0, bv, cv]] and p, zero behind the
  // camera (where the JAX code zeroes J), so a non-finite p adds nothing.
  const float iz2 = iz * iz;
  const float a = good ? q.fx * iz : 0.f, bv = good ? q.fy * iz : 0.f;
  const float cu = good ? -q.fx * p0 * iz2 : 0.f;
  const float cr = good ? -q.fx * (p0 - q.baseline) * iz2 : 0.f;
  const float cv = good ? -q.fy * p1 * iz2 : 0.f;
  const float x0 = good ? p0 : 0.f, x1 = good ? p1 : 0.f, x2 = good ? p2 : 0.f;
  const float W0 = w * s0 * s0, W1 = w * s1 * s1;  // the v row's weight is W0's
  const float e0 = W0 * r[0], e1 = W1 * r[1], e2 = W0 * r[2];
  const float m00 = (W0 + W1) * (a * a), m02 = a * (W0 * cu + W1 * cr);
  const float m11 = W0 * (bv * bv), m12 = W0 * (bv * cv);
  const float m22 = W0 * (cu * cu) + W1 * (cr * cr) + W0 * (cv * cv);
  const float g0 = a * (e0 + e1), g1 = bv * e2, g2 = cu * e0 + cr * e1 + cv * e2;
  // Q = M [p]x, rows of M times the columns (0, x2, -x1), (-x2, 0, x0),
  // (x1, -x0, 0).
  const float Q[3][3] = {
      {-m02 * x1, m02 * x0 - m00 * x2, m00 * x1},
      {m11 * x2 - m12 * x1, m12 * x0, -m11 * x0},
      {m12 * x2 - m22 * x1, m22 * x0 - m02 * x2, m02 * x1 - m12 * x0},
  };
  // H's upper triangle row by row: rows 0-2 the rotation's, 3-5 the
  // translation's (H[3][4] = M[0][1] = 0 stays 0).
  const float Hww00 = x2 * Q[1][0] - x1 * Q[2][0], Hww01 = x2 * Q[1][1] - x1 * Q[2][1];
  const float Hww02 = x2 * Q[1][2] - x1 * Q[2][2], Hww11 = x0 * Q[2][1] - x2 * Q[0][1];
  const float Hww12 = x0 * Q[2][2] - x2 * Q[0][2], Hww22 = x1 * Q[0][2] - x0 * Q[1][2];
  acc[0] += Hww00;
  acc[1] += Hww01;
  acc[2] += Hww02;
  acc[3] -= Q[0][0];
  acc[4] -= Q[1][0];
  acc[5] -= Q[2][0];
  acc[6] += Hww11;
  acc[7] += Hww12;
  acc[8] -= Q[0][1];
  acc[9] -= Q[1][1];
  acc[10] -= Q[2][1];
  acc[11] += Hww22;
  acc[12] -= Q[0][2];
  acc[13] -= Q[1][2];
  acc[14] -= Q[2][2];
  acc[15] += m00;
  acc[17] += m02;
  acc[18] += m11;
  acc[19] += m12;
  acc[20] += m22;
  acc[21] += x2 * g1 - x1 * g2;
  acc[22] += x0 * g2 - x2 * g0;
  acc[23] += x1 * g0 - x0 * g1;
  acc[24] -= g0;
  acc[25] -= g1;
  acc[26] -= g2;
}

// The thread's first N points, in one straight run the compiler can
// interleave; N is the same in every thread.
template <int N>
__device__ __forceinline__ void points_upto(int n, const Params& q, const Points& pt,
                                            const float* P, float (&acc)[32]) {
  if constexpr (N > 1) {
    if (n < N) {
      points_upto<N - 1>(n, q, pt, P, acc);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) point_terms(q, pt, k, P, acc);
}

// The thread's part of the 28 sums at the pose P: H's upper triangle row
// by row (0..20), g (21..26) and the robust error (27); 28..31 stay 0.
// Each thread takes ceil(K / THREADS) points, the last of them padding
// (adding zeros) where K is not a multiple of THREADS.
__device__ __forceinline__ void point_sums(const Params& q, const Points& pt, const float* P,
                                           float (&acc)[32]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  points_upto<PPT>((q.K + THREADS - 1) / THREADS, q, pt, P, acc);
}

// pose_only_lm_impl on the block: LM from P in place (P the same in every
// thread, before and after). Iteration -1 evaluates P itself (the opening
// error and the first system); each later one solves the held system,
// evaluates the trial and decides.
__device__ __forceinline__ void lm(const Params& q, const Points& pt, Reducer& red,
                                  float (&P)[12]) {
  float sys = 0.f, err = 0.f, lam = 1e-5f;  // lane L: sum L of the system at P
  for (int it = -1; it < q.track_iters; ++it) {
    float trial[12];
    bool finite = true;
    if (it >= 0) {
      float A[6][6], b[6], x[6];
      int idx = 0;
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int k = j; k < 6; ++k) A[j][k] = A[k][j] = __shfl_sync(FULL, sys, idx++);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        A[j][j] += lam;
        b[j] = -__shfl_sync(FULL, sys, 21 + j);
      }
      // A vote: the same in every lane, and known to be so by the compiler,
      // which then needs no divergent path for the shuffles that follow.
      finite = __all_sync(FULL, lu_solve(A, b, x));
      if (!finite) {  // the JAX loop's where: a zero step, to the pose itself
#pragma unroll
        for (int j = 0; j < 6; ++j) x[j] = 0.f;
      }
      retract(P, x, trial);
    } else {
#pragma unroll
      for (int j = 0; j < 12; ++j) trial[j] = P[j];
    }
    float v[32];
    point_sums(q, pt, trial, v);
    const float trial_sys = red.sum(v);
    const float new_err = __shfl_sync(FULL, trial_sys, ERR);
    if (it < 0) {
      sys = trial_sys;
      err = new_err;
      continue;
    }
    const bool accept = finite && new_err < err;
    if (accept) {
#pragma unroll
      for (int j = 0; j < 12; ++j) P[j] = trial[j];
      sys = trial_sys;
    }
    const float improvement = err - new_err;
    if (accept) err = new_err;
    lam = accept ? clamp_min(lam * 0.1f, 1e-10f) : lam * 10.f;
    if ((accept && improvement < 1e-4f * clamp_min(err, 1.f)) || lam > 1e8f) break;
  }
}

// Each thread's points of the frame: keyframe feature i = threadIdx.x +
// k * THREADS matched frame keypoint tm[i] (or -1). kl (K, 2), disp (K,),
// stereo_ok (K,) are the frame's; kf_xw (K, 3), kf_dok (K,) the keyframe's.
__device__ __forceinline__ void load_points(const Params& q, const float* __restrict__ kl,
                                            const float* __restrict__ disp,
                                            const uint8_t* __restrict__ stereo_ok,
                                            const int* __restrict__ tm,
                                            const float* __restrict__ kf_xw,
                                            const uint8_t* __restrict__ kf_dok, Points& pt) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * THREADS;
    pt.ok[k] = false;
    pt.keep[k] = 0.f;
    pt.X[k] = pt.Y[k] = pt.Z[k] = pt.m0[k] = pt.m1[k] = pt.m2[k] = pt.su[k] = 0.f;
    pt.u[k] = pt.v[k] = 0.f;
    if (i >= q.K) continue;
    const int m = tm[i];
    const int f = m < 0 ? 0 : m;
    const float u = kl[2 * f], v = kl[2 * f + 1], d = disp[f];
    pt.ok[k] = m >= 0 && stereo_ok[f] && kf_dok[i];
    pt.X[k] = kf_xw[3 * i];
    pt.Y[k] = kf_xw[3 * i + 1];
    pt.Z[k] = kf_xw[3 * i + 2];
    pt.m0[k] = u;
    pt.m1[k] = u - d;
    pt.m2[k] = v;
    pt.u[k] = u;
    pt.v[k] = v;
    const float ratio = q.disp_cond / clamp_min(d, 1e-3f);
    pt.su[k] = q.mono ? 0.f : 1.f / (q.disp_sigma0 * sqrtf(1.f + ratio * ratio));
    pt.keep[k] = pt.ok[k] ? 1.f : 0.f;
  }
}

// Which of the thread's usable points reproject at P within px, z > 0.1.
__device__ __forceinline__ void within(const Params& q, const Points& pt, const float* P,
                                       float px, bool (&b)[PPT]) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    bool zok = false;
    const float r = threadIdx.x + k * THREADS < q.K
                        ? reproj(q, P, pt.X[k], pt.Y[k], pt.Z[k], pt.u[k], pt.v[k], zok)
                        : 0.f;
    b[k] = pt.ok[k] && zok && r < px;
  }
}

// The gate, the LM and the chi2 rounds: P holds the start pose and pred
// (R_pred row-major, t_pred) the prediction, the same in every thread.
// Leaves the solved pose in P; returns the last kept set's size.
__device__ __forceinline__ int solve(const Params& q, Points& pt, Reducer& red,
                                     const float (&pred)[12], float (&P)[12]) {
  if (q.gate_px > 0.f) {
    bool k0[PPT];
    within(q, pt, pred, q.gate_px, k0);
    if (red.count(k0) >= q.min_matches) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) pt.keep[k] = k0[k] ? 1.f : 0.f;
    }
  }
  // Round 0 solves on the gated set; each later one re-solves on its chi2
  // inliers (one call site: one copy of the LM's code).
  for (int round = 0; round <= q.chi2_rounds; ++round) {
    if (round > 0) {
      bool k2[PPT];
      within(q, pt, P, q.chi2_px, k2);
      if (red.count(k2) < q.min_matches) break;  // uniform: every thread holds the count
#pragma unroll
      for (int k = 0; k < PPT; ++k) pt.keep[k] = k2[k] ? 1.f : 0.f;
    }
    lm(q, pt, red, P);
  }

  bool kept[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) kept[k] = pt.keep[k] != 0.f;
  return red.count(kept);
}

}  // namespace pose
