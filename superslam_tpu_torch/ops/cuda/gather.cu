// gather_normalize: out[b, k, :] = l2_normalize(grid[b, cells[b, k], :]).
//
// Replaces superslam_tpu/ops/pallas/gather.py::gather_normalize
// (_gather_kernel): for each selected keypoint fetch its descriptor cell
// from the dense (GH*GW, D) grid and write the row scaled by
// rsqrt(sum of squares + 1e-12), in f32. The TPU kernel takes one image
// and walks its keypoints as sequential grid steps with scalar-prefetched
// cell ids; here one launch covers the whole (B, K) batch.
//
// Bound on the H100: bytes. (2, 600) keypoints x 256 channels read 0.6 MB
// of bf16 rows and write 1.2 MB of f32: ~0.6 us at the HBM rate, below the
// cost of a launch, against 3 operations per element.
// What the design does about it: one warp per keypoint, 16 bytes a lane per
// load so a 512-byte bf16 row is one coalesced request, a shuffle reduction
// for the norm, and a second pass over the row (an L1 hit) for the scaled
// store. Cell ids outside the grid are clamped, so no lane reads past it.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    gather_kernel(const T* __restrict__ grid, const int64_t* __restrict__ cells,
                  float* __restrict__ out, int B, int G, int K, int D) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  const int kp = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (kp >= B * K) return;
  const int b = kp / K;
  int64_t cell = cells[kp];
  cell = cell < 0 ? 0 : (cell >= G ? G - 1 : cell);
  const T* row = grid + (size_t(b) * G + size_t(cell)) * D;

  float sq = 0.0f;
  for (int c = lane * V; c < D; c += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float f = ssl_to_float(e[i]);
      sq += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float inv = rsqrtf(sq + 1e-12f);

  float* dst = out + size_t(kp) * D;
  for (int c = lane * V; c < D; c += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(dst + c + i) =
          make_float4(ssl_to_float(e[i]) * inv, ssl_to_float(e[i + 1]) * inv,
                      ssl_to_float(e[i + 2]) * inv, ssl_to_float(e[i + 3]) * inv);
  }
}

template <typename T>
cudaError_t launch(const void* grid, const int64_t* cells, float* out, int B, int G, int K,
                   int D, cudaStream_t stream) {
  const int blocks = (B * K + WARPS - 1) / WARPS;
  gather_kernel<T><<<blocks, WARPS * 32, 0, stream>>>(reinterpret_cast<const T*>(grid),
                                                      cells, out, B, G, K, D);
  return cudaGetLastError();
}

}  // namespace

// grid (B, G, D) bf16 if is_bf16 else f32, D a multiple of 8; cells (B, K)
// int64 flat cell ids; out (B, K, D) f32.
SSL_EXPORT int ssl_gather_normalize(const void* grid, const int64_t* cells, float* out,
                                    int B, int G, int K, int D, int is_bf16, void* stream) {
  if (B < 1 || G < 1 || K < 1 || D < 8 || D % 8) return int(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return int(is_bf16 ? launch<__nv_bfloat16>(grid, cells, out, B, G, K, D, s)
                     : launch<float>(grid, cells, out, B, G, K, D, s));
}
