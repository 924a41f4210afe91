// pose_solve: one frame's prior-gated, pose-only stereo Levenberg-Marquardt
// solve, the per-frame body of the device tracking chain, in one launch.
//
// Replaces what the JAX package runs as XLA inside its tracking scans:
// superslam_tpu/ops/frontend_step.py::_frame_solve (:381) around
// superslam_tpu/ops/pose_solver.py::pose_only_lm_impl (:159, the LM as a
// lax.while_loop at :198). Its plain twin is
// ops/cuda/pose_solve.py::pose_solve_plain (the same function in PyTorch,
// with ops/pose_solver.py::pose_only_lm_impl).
//
// What it computes, for the K keyframe features of one frame:
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
// Outputs: the pose (R row-major, t), n and the final kept count, ok, and
// the gathered (uL, v) for the caller's support count.
//
// Bound on the H100: bytes, and far below a microsecond. At K = 600 it reads
// ~20 KB (keypoints, disparities, masks, matches, world points) and writes
// ~7 KB: ~8 ns at 3.35 TB/s; ~600 points x 20 iterations x 3 solves x ~300
// f32 operations is ~11 MFLOP, ~0.2 us at 67 TFLOP/s. What a frame pays is
// latency: up to 60 dependent iterations, each a block reduction, a 6 x 6
// solve on one thread and a second reduction. The design answers that
// without the host: one block per frame (frames of a scan are sequential,
// each frame's prior is the last frame's solve), 256 threads that keep
// their four points' world points, measurements and weights in registers
// for the whole solve, each iteration's 21 + 6 normal-equation sums by warp
// shuffles and one warp across the eight warps, the error likewise, counts
// by __syncthreads_count, and every early exit a branch on a shared flag.
// Nothing is read by the host between the upload and the packed readback.
//
// Arithmetic is f32, as in the JAX program; the sums run in another order
// than PyTorch's, so the kernel agrees with the twin to rounding, not bits.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PPT = 4;                // points a thread
constexpr int KMAX = THREADS * PPT;   // 1024 correspondences
constexpr int NSYS = 27;              // 21 of H's upper triangle + 6 of g
constexpr float HUBER_K = 2.7955f;    // sqrt(7.815)

struct Params {
  float fx, fy, cx, cy, baseline;
  float inv_sig_uLv, disp_sigma0, disp_cond, gate_px, chi2_px;
  int K, min_matches, mono, chi2_rounds, track_iters;
};

// torch.clamp(x, min=m): NaN stays NaN (fmaxf would drop it).
__device__ __forceinline__ float clamp_min(float x, float m) { return x < m ? m : x; }

struct Shared {
  float red[WARPS][32];
  float sums[32];
  float pose[12];   // current R (row-major), t
  float trial[12];  // the step's retraction
  float lam, err;
  int ok_step, done;
};

// Sum N per-thread values over the block: warp butterflies, then warp 0
// across the warps; the totals land in s.sums[0..N).
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], Shared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float x = v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) s.red[warp][j] = x;
  }
  __syncthreads();
  if (warp == 0 && lane < N) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += s.red[w][lane];
    s.sums[lane] = t;
  }
  __syncthreads();
}

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

// One thread: solve (H + lam I) x = -g by LU with partial pivoting (the
// first largest pivot, as LAPACK's getrf), then retract the pose by x.
__device__ void solve_and_retract(Shared& s) {
  float A[6][6], b[6];
  int idx = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int k = j; k < 6; ++k) {
      A[j][k] = A[k][j] = s.sums[idx++];
    }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    A[j][j] += s.lam;
    b[j] = -s.sums[21 + j];
  }
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
    // The swap with compile-time row indices keeps A in registers.
#pragma unroll
    for (int r = c + 1; r < 6; ++r)
      if (r == p) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float tmp = A[c][k];
          A[c][k] = A[r][k];
          A[r][k] = tmp;
        }
        const float tb = b[c];
        b[c] = b[r];
        b[r] = tb;
      }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[r][c] / A[c][c];
#pragma unroll
      for (int k = c + 1; k < 6; ++k) A[r][k] -= f * A[c][k];
      b[r] -= f * b[c];
    }
  }
  float x[6];
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    float acc = b[r];
#pragma unroll
    for (int k = r + 1; k < 6; ++k) acc -= A[r][k] * x[k];
    x[r] = acc / A[r][r];
  }
  bool finite = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) finite = finite && isfinite(x[j]);
  s.ok_step = finite;
  if (!finite) {
#pragma unroll
    for (int j = 0; j < 6; ++j) x[j] = 0.f;
  }

  // SE(3) exponential (rotation first), as ops/pose_solver.py::_se3_exp.
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
  const float a = small ? 1.f : sinf(th) / th;
  const float bb = small ? 0.5f : (1.f - cosf(th)) / th2;
  const float cc = small ? 1.f / 6.f : (th - sinf(th)) / (th2 * th);
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
  const float* R = s.pose;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      s.trial[3 * i + j] =
          R[3 * i] * dR[0][j] + R[3 * i + 1] * dR[1][j] + R[3 * i + 2] * dR[2][j];
    s.trial[9 + i] = R[3 * i] * dt[0] + R[3 * i + 1] * dt[1] + R[3 * i + 2] * dt[2] + s.pose[9 + i];
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

// Robust error of the pose P over the kept points (every thread's part).
__device__ __forceinline__ float point_error(const Params& q, const Points& pt, const float* P) {
  float e = 0.f;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (threadIdx.x + k * THREADS >= q.K) continue;
    float p0, p1, p2, iz, r[3];
    bool good;
    to_camera(P, pt.X[k], pt.Y[k], pt.Z[k], p0, p1, p2);
    residual(q, p0, p1, p2, pt.m0[k], pt.m1[k], pt.m2[k], good, iz, r);
    const float s0 = q.inv_sig_uLv, s1 = pt.su[k];
    const float a = r[0] * s0, b = r[1] * s1, c = r[2] * s0;
    e += huber(sqrtf(a * a + b * b + c * c)) * pt.keep[k];
  }
  return e;
}

// pose_only_lm_impl on the block: LM from s.pose in place.
__device__ __forceinline__ void lm(const Params& q, const Points& pt, Shared& s) {
  {
    float e[1] = {point_error(q, pt, s.pose)};
    block_sum<1>(e, s);
  }
  if (threadIdx.x == 0) {
    s.err = s.sums[0];
    s.lam = 1e-5f;
  }
  __syncthreads();
  for (int it = 0; it < q.track_iters; ++it) {
    float acc[NSYS];
#pragma unroll
    for (int j = 0; j < NSYS; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (threadIdx.x + k * THREADS >= q.K) continue;
      float p0, p1, p2, iz, r[3];
      bool good;
      to_camera(s.pose, pt.X[k], pt.Y[k], pt.Z[k], p0, p1, p2);
      residual(q, p0, p1, p2, pt.m0[k], pt.m1[k], pt.m2[k], good, iz, r);
      const float iz2 = iz * iz;
      const float Jp[3][3] = {
          {q.fx * iz, 0.f, -q.fx * p0 * iz2},
          {q.fx * iz, 0.f, -q.fx * (p0 - q.baseline) * iz2},
          {0.f, q.fy * iz, -q.fy * p1 * iz2},
      };
      const float D[3][6] = {
          {0.f, -p2, p1, -1.f, 0.f, 0.f},
          {p2, 0.f, -p0, 0.f, -1.f, 0.f},
          {-p1, p0, 0.f, 0.f, 0.f, -1.f},
      };
      const float sig[3] = {q.inv_sig_uLv, pt.su[k], q.inv_sig_uLv};
      float Jw[3][6], rw[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        rw[i] = r[i] * sig[i];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float J = Jp[i][0] * D[0][j] + Jp[i][1] * D[1][j] + Jp[i][2] * D[2][j];
          Jw[i][j] = (good ? J : 0.f) * sig[i];
        }
      }
      const float nrm = sqrtf(rw[0] * rw[0] + rw[1] * rw[1] + rw[2] * rw[2]);
      const float w = (nrm <= HUBER_K ? 1.f : HUBER_K / clamp_min(nrm, 1e-12f)) * pt.keep[k];
      int idx = 0;
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int l = j; l < 6; ++l)
          acc[idx++] += w * (Jw[0][j] * Jw[0][l] + Jw[1][j] * Jw[1][l] + Jw[2][j] * Jw[2][l]);
#pragma unroll
      for (int j = 0; j < 6; ++j)
        acc[21 + j] += w * (Jw[0][j] * rw[0] + Jw[1][j] * rw[1] + Jw[2][j] * rw[2]);
    }
    block_sum<NSYS>(acc, s);
    if (threadIdx.x == 0) solve_and_retract(s);
    __syncthreads();
    float e[1] = {point_error(q, pt, s.trial)};
    block_sum<1>(e, s);
    if (threadIdx.x == 0) {
      const float new_err = s.sums[0];
      const bool accept = s.ok_step && new_err < s.err;
      if (accept)
        for (int j = 0; j < 12; ++j) s.pose[j] = s.trial[j];
      const float improvement = s.err - new_err;
      if (accept) s.err = new_err;
      s.lam = accept ? clamp_min(s.lam * 0.1f, 1e-10f) : s.lam * 10.f;
      s.done = (accept && improvement < 1e-4f * clamp_min(s.err, 1.f)) || s.lam > 1e8f;
    }
    __syncthreads();
    if (s.done) break;
  }
}

__global__ void __launch_bounds__(THREADS)
    pose_solve_kernel(Params q, const float* __restrict__ R_prev, const float* __restrict__ t_prev,
                      const float* __restrict__ R_pred, const float* __restrict__ t_pred,
                      const float* __restrict__ kl, const float* __restrict__ disp,
                      const uint8_t* __restrict__ stereo_ok, const int* __restrict__ tm,
                      const float* __restrict__ kf_xw, const uint8_t* __restrict__ kf_dok,
                      float* __restrict__ pose_out, int* __restrict__ stats_out,
                      uint8_t* __restrict__ ok_out, float* __restrict__ uv_out) {
  __shared__ Shared s;
  __shared__ float pred[12];
  Points pt;
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
    ok_out[i] = pt.ok[k];
    uv_out[2 * i] = u;
    uv_out[2 * i + 1] = v;
  }
  if (threadIdx.x < 9) {
    s.pose[threadIdx.x] = R_prev[threadIdx.x];
    pred[threadIdx.x] = R_pred[threadIdx.x];
  } else if (threadIdx.x < 12) {
    s.pose[threadIdx.x] = t_prev[threadIdx.x - 9];
    pred[threadIdx.x] = t_pred[threadIdx.x - 9];
  }
  // n = sum(ok): __syncthreads_count counts threads, so count point by point
  // (its barriers also publish the pose and prediction above).
  int n_total = 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) n_total += __syncthreads_count(pt.ok[k]);

  // The prior gate at the constant-velocity prediction.
  if (q.gate_px > 0.f) {
    bool k0[PPT];
    int c0 = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      bool zok = false;
      const float r = threadIdx.x + k * THREADS < q.K
                          ? reproj(q, pred, pt.X[k], pt.Y[k], pt.Z[k], pt.u[k], pt.v[k], zok)
                          : 0.f;
      k0[k] = pt.ok[k] && zok && r < q.gate_px;
      c0 += __syncthreads_count(k0[k]);
    }
    if (c0 >= q.min_matches) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) pt.keep[k] = k0[k] ? 1.f : 0.f;
    }
  }
  lm(q, pt, s);

  for (int round = 0; round < q.chi2_rounds; ++round) {
    bool k2[PPT];
    int c2 = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      bool zok = false;
      const float r = threadIdx.x + k * THREADS < q.K
                          ? reproj(q, s.pose, pt.X[k], pt.Y[k], pt.Z[k], pt.u[k], pt.v[k], zok)
                          : 0.f;
      k2[k] = pt.ok[k] && zok && r < q.chi2_px;
      c2 += __syncthreads_count(k2[k]);
    }
    if (c2 < q.min_matches) break;  // uniform: every thread holds the same count
#pragma unroll
    for (int k = 0; k < PPT; ++k) pt.keep[k] = k2[k] ? 1.f : 0.f;
    lm(q, pt, s);
  }

  int kept = 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) kept += __syncthreads_count(pt.keep[k] != 0.f);
  if (threadIdx.x < 12) pose_out[threadIdx.x] = s.pose[threadIdx.x];
  if (threadIdx.x == 0) {
    stats_out[0] = n_total;
    stats_out[1] = kept;
  }
}

}  // namespace

// R_prev, R_pred (3, 3) and t_prev, t_pred (3,) f32; kl (K, 2) f32 frame
// keypoints; disp (K,) f32; stereo_ok (K,) bool; tm (K,) int32 (keyframe
// feature i -> frame keypoint, or -1); kf_xw (K, 3) f32; kf_dok (K,) bool.
// Out: pose (12,) f32 (R row-major, t), stats (2,) int32 (n, kept), ok (K,)
// bool, uv (K, 2) f32. K <= 1024.
SSL_EXPORT int ssl_pose_solve(const float* R_prev, const float* t_prev, const float* R_pred,
                              const float* t_pred, const float* kl, const float* disp,
                              const uint8_t* stereo_ok, const int* tm, const float* kf_xw,
                              const uint8_t* kf_dok, float* pose_out, int* stats_out,
                              uint8_t* ok_out, float* uv_out, int K, float fx, float fy, float cx,
                              float cy, float baseline, int min_matches, float inv_sig_uLv,
                              float disp_sigma0, float disp_cond, int mono, float gate_px,
                              float chi2_px, int chi2_rounds, int track_iters, void* stream) {
  if (K < 1 || K > KMAX || track_iters < 0 || chi2_rounds < 0) return int(cudaErrorInvalidValue);
  Params q{fx, fy, cx, cy, baseline, inv_sig_uLv, disp_sigma0, disp_cond, gate_px, chi2_px,
           K, min_matches, mono, chi2_rounds, track_iters};
  pose_solve_kernel<<<1, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      q, R_prev, t_prev, R_pred, t_pred, kl, disp, stereo_ok, tm, kf_xw, kf_dok, pose_out,
      stats_out, ok_out, uv_out);
  return int(cudaGetLastError());
}
