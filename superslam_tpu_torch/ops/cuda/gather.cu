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
// of bf16 rows and write 1.2 MB of f32: ~0.6 us at the HBM rate, under the
// card's launch floor, against 3 operations per element. Too few bytes to
// fill HBM, so the time is the chain of memory trips each warp waits on:
// its cell id, then its row, then the drain of its stores.
// What the design does about it: one keypoint a warp, its cell id loaded
// once by lane 0 through the read-only path and broadcast by shuffle; the
// row loaded at once into registers (a lane owns chunks lane and lane + 32
// of 4 elements, so each load and each store instruction of the warp
// covers one contiguous span); the norm by a butterfly; the scaled row
// stored from the same registers, with no second load, as streaming stores
// (nothing in the kernel reads them). Chunks past the registers' (D > 256)
// are summed in a strided loop and loaded again for their stores. Small
// blocks (WARPS warps) give every SM work at K 600-1000 and B 1-8. Cell
// ids outside the grid are clamped, so no lane reads past it.
// On the H100 (scripts/kernel_variants_torch.py --kernel gather; PERF.md
// row 7 has the figures): 2 or 8 warps a block, 2 or 4 keypoints a warp,
// plain stores and a bulk copy (cp.async.bulk into shared memory on an
// mbarrier) were no faster.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;  // warps a block, one keypoint a warp
constexpr int NC = 2;     // chunks of 4 elements a lane holds in registers: D up to 256
constexpr unsigned FULL = 0xffffffffu;

// Four consecutive elements of a row, loaded through the read-only path.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float sum_sq(float4 v) {
  return v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}

// Streaming (evict-first) store of v * s.
__device__ __forceinline__ void store4(float* p, float4 v, float s) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v.x * s, v.y * s, v.z * s, v.w * s));
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    gather_kernel(const T* __restrict__ grid, const long long* __restrict__ cells,
                  float* __restrict__ out, int N, int G, int K, int D) {
  const int lane = threadIdx.x % 32;
  const int kp = blockIdx.x * WARPS + threadIdx.x / 32;
  if (kp >= N) return;
  const int nch = D / 4;  // chunks a row

  // Lane 0: the keypoint's row offset, its cell clamped into the grid.
  long long mine = 0;
  if (lane == 0) {
    long long cell = __ldg(cells + kp);
    cell = cell < 0 ? 0 : (cell >= G ? G - 1 : cell);
    mine = ((long long)(kp / K) * G + cell) * D;
  }
  const T* row = grid + __shfl_sync(FULL, mine, 0);

  float4 v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int ch = lane + 32 * c;
    v[c] = ch < nch ? load4(row + 4 * ch) : make_float4(0, 0, 0, 0);
  }
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) sq += sum_sq(v[c]);
  for (int ch = lane + 32 * NC; ch < nch; ch += 32) sq += sum_sq(load4(row + 4 * ch));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(FULL, sq, o);
  const float inv = rsqrtf(sq + 1e-12f);

  float* dst = out + size_t(kp) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int ch = lane + 32 * c;
    if (ch < nch) store4(dst + 4 * ch, v[c], inv);
  }
  for (int ch = lane + 32 * NC; ch < nch; ch += 32) store4(dst + 4 * ch, load4(row + 4 * ch), inv);
}

template <typename T>
cudaError_t launch(const void* grid, const int64_t* cells, float* out, int N, int G, int K, int D,
                   cudaStream_t stream) {
  const int blocks = (N + WARPS - 1) / WARPS;
  gather_kernel<T><<<blocks, WARPS * 32, 0, stream>>>(
      reinterpret_cast<const T*>(grid), reinterpret_cast<const long long*>(cells), out, N, G, K,
      D);
  return cudaGetLastError();
}

}  // namespace

// grid (B, G, D) bf16 if is_bf16 else f32, D a multiple of 8; cells (B, K)
// int64 flat cell ids; out (B, K, D) f32.
SSL_EXPORT int ssl_gather_normalize(const void* grid, const int64_t* cells, float* out,
                                    int B, int G, int K, int D, int is_bf16, void* stream) {
  if (B < 1 || G < 1 || K < 1 || D < 8 || D % 8) return int(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int N = B * K;
  return int(is_bf16 ? launch<__nv_bfloat16>(grid, cells, out, N, G, K, D, s)
                     : launch<float>(grid, cells, out, N, G, K, D, s));
}
