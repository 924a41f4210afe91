// pose_solve: one frame's prior-gated, pose-only stereo Levenberg-Marquardt
// solve in one launch: the solve of pose_solve.cuh (what it computes, and
// how the block computes it) and nothing around it.
//
// Replaces what the JAX package runs as XLA inside its tracking scans:
// superslam_tpu/ops/frontend_step.py::_frame_solve (:381) around
// superslam_tpu/ops/pose_solver.py::pose_only_lm_impl (:159, the LM as a
// lax.while_loop at :198). Its plain twin is
// ops/cuda/pose_solve.py::pose_solve_plain. The tracking scans no longer
// launch it: their per-frame body, this solve included, is one launch of
// track_frame.cu. It stays as the solve's own entry point, timed beside
// that kernel.
//
// Outputs: the pose (R row-major, t), n and the final kept count, ok, and
// the gathered (uL, v).
//
// Bound on the H100: bytes, and far below a microsecond: at K = 600 it
// reads ~20 KB and writes ~7 KB (~8 ns at 3.35 TB/s); ~600 points x 20
// iterations x 3 solves x ~400 f32 operations is ~14 MFLOP, ~0.2 us at 67
// TFLOP/s. What it pays is latency: up to 60 dependent iterations on one
// SM, each one pass, one block reduction and one barrier, and a 6 x 6 LU
// that every thread runs (pose_solve.cuh's schedule).
#include "pose_solve.cuh"

namespace {

using namespace pose;

__global__ void __launch_bounds__(THREADS, 1)
    pose_solve_kernel(Params q, const float* __restrict__ R_prev, const float* __restrict__ t_prev,
                      const float* __restrict__ R_pred, const float* __restrict__ t_pred,
                      const float* __restrict__ kl, const float* __restrict__ disp,
                      const uint8_t* __restrict__ stereo_ok, const int* __restrict__ tm,
                      const float* __restrict__ kf_xw, const uint8_t* __restrict__ kf_dok,
                      float* __restrict__ pose_out, int* __restrict__ stats_out,
                      uint8_t* __restrict__ ok_out, float* __restrict__ uv_out) {
  __shared__ Shared s;
  Points pt;
  load_points(q, kl, disp, stereo_ok, tm, kf_xw, kf_dok, pt);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i >= q.K) continue;
    ok_out[i] = pt.ok[k];
    uv_out[2 * i] = pt.u[k];
    uv_out[2 * i + 1] = pt.v[k];
  }
  // The poses in every thread's registers.
  float P[12], pred[12];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    P[j] = R_prev[j];
    pred[j] = R_pred[j];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    P[9 + j] = t_prev[j];
    pred[9 + j] = t_pred[j];
  }
  Reducer red{s, 0};
  const int n = red.count(pt.ok);
  const int kept = solve(q, pt, red, pred, P);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 12; ++j) pose_out[j] = P[j];
    stats_out[0] = n;
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
