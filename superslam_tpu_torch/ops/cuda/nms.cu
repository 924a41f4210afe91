// nms: keep s where s equals the (2r+1) x (2r+1) window max, else 0.
//
// Replaces superslam_tpu/ops/pallas/nms.py::nms_suppress (_nms_kernel).
// Zero padding outside the map, ties keep their score; scores are softmax
// probabilities (>= 0), so zero padding equals the -inf padding of a max
// pool.
//
// Bound on the H100: bytes. The map is read once and written once
// (2 x 384 x 1248 f32 = 3.8 MB each way at the KITTI shape, ~2.3 us at
// 3.35 TB/s); the 2 x 9 compares per pixel are far below the f32 rate.
// What the design does about it: a block stages a 32 x 64 output tile with
// its 8-pixel halo in shared memory (one coalesced read of each input byte
// plus the halo), takes the separable max there (row pass into a second
// shared tile, then the column pass), and writes each output once.
#include "common.cuh"

namespace {

constexpr int TH = 32, TW = 64, HALO = 8;  // radius <= HALO
constexpr int SH = TH + 2 * HALO, SW = TW + 2 * HALO;
constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
    nms_kernel(const float* __restrict__ s, float* __restrict__ out, int H, int W,
               int radius) {
  __shared__ float x_s[SH][SW + 1];
  __shared__ float h_s[SH][TW + 1];
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const float* src = s + size_t(b) * H * W;
  for (int i = threadIdx.x; i < SH * SW; i += NTHREADS) {
    const int r = i / SW, c = i % SW;
    const int gy = y0 - HALO + r, gx = x0 - HALO + c;
    x_s[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? src[size_t(gy) * W + gx] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SH * TW; i += NTHREADS) {
    const int r = i / TW, c = i % TW;
    float m = x_s[r][c + HALO - radius];
    for (int d = 1; d <= 2 * radius; ++d) m = fmaxf(m, x_s[r][c + HALO - radius + d]);
    h_s[r][c] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TH * TW; i += NTHREADS) {
    const int r = i / TW, c = i % TW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    float m = h_s[r + HALO - radius][c];
    for (int d = 1; d <= 2 * radius; ++d) m = fmaxf(m, h_s[r + HALO - radius + d][c]);
    const float v = x_s[r + HALO][c + HALO];
    out[(size_t(b) * H + gy) * W + gx] = (v == m) ? v : 0.0f;
  }
}

}  // namespace

// s, out: f32 (B, H, W); 0 <= radius <= 8.
SSL_EXPORT int ssl_nms(const float* s, float* out, int B, int H, int W, int radius,
                       void* stream) {
  if (radius < 0 || radius > HALO || B < 1) return int(cudaErrorInvalidValue);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  nms_kernel<<<grid, NTHREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(s, out, H, W,
                                                                            radius);
  return int(cudaGetLastError());
}
