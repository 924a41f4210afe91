// conv3x3: one 3x3 SAME conv + f32 bias + optional ReLU, CIN 1 or 64, COUT
// 64 or 128, on WMMA: the last conv kernel of the port that does not run on
// the mma.sync engine of conv_mma.cuh. Both conv pairs (CIN 1 and 64, pooled
// or not) are conv_pair_mma.cu.
//
// Replaces superslam_tpu/ops/pallas/conv.py::conv3x3_chw (_conv_kernel);
// only the stage profiler and the tests call it.
//
// Bound on the H100 at conv2a's shape (2, 64, 192, 624) bf16: bytes, 61 MB
// in and out = 0.0183 ms against 17.7 GFLOP = 0.0179 ms.
// What the design does about it:
//   * CIN = 64 runs on the tensor cores as an implicit GEMM through WMMA
//     bf16 16x16x16 fragments with f32 accumulation; no im2col is
//     materialised anywhere. A block owns a 16-row x 32-column tile and
//     loads the input tile with its one-pixel halo (18 x 34 x 64 bf16) into
//     shared memory.
//   * "flat runs": a warp's 16 GEMM rows are 16 consecutive pixels of the
//     tile stored with a fixed pixel pitch, so each 3x3 tap is one
//     constant offset into shared memory and one fragment load. The
//     columns that wrap past the tile edge are computed and discarded
//     (6-7% extra work) instead of being special-cased.
//   * CIN = 1 is nine FMAs per output on the CUDA cores.
// Later work (ROADMAP queue 2): move CIN = 64 onto conv_mma.cuh's engine
// (swizzled tile, mma.sync, cp.async weight ring), as conv_pair_mma.cu did
// for the conv pairs.
//
// Layouts: CIN = 1 takes f32 (B, 1, H, W); CIN = 64 takes bf16 NHWC (a
// channels_last (B, 64, H, W) tensor). The output is NHWC (channels_last
// (B, COUT, H, W)) in bf16 or f32.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int C = 64;           // input channels of the GEMM path, output channels of a pass
constexpr int TH = 16;          // conv rows per block
constexpr int TW = 32;          // conv columns per block
constexpr int AP = TW + 2;      // pixel pitch of the input tile
constexpr int AR = TH + 2 + 1;  // input tile rows: 18 + 1 zero row for run overrun
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NRUN_B = TH * AP / 16;  // 34 runs cover the 16 x 32 tile

constexpr size_t A_BYTES = size_t(AR) * AP * C * 2;       // 82,688
constexpr size_t STAGE_BYTES = size_t(NWARPS) * 256 * 4;  // 8,192

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc[nb] += sum over 9 taps and 64 input channels of
//   src[(base + ky*pitch + kx) * 64 + ci] * w[(tap*64 + ci)*ldw + nb*16 + j].
__device__ __forceinline__ void run_gemm(const __nv_bfloat16* src, int base, int pitch,
                                         const __nv_bfloat16* __restrict__ w,
                                         FragC (&acc)[4], int ldw = C) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) wmma::fill_fragment(acc[nb], 0.0f);
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    const __nv_bfloat16* a = src + size_t(base + ky * pitch + kx) * C;
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
      FragA fa;
      wmma::load_matrix_sync(fa, a + cb * 16, C);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        FragB fb;
        wmma::load_matrix_sync(fb, w + size_t(tap * C + cb * 16) * ldw + nb * 16, ldw);
        wmma::mma_sync(acc[nb], fa, fb, acc[nb]);
      }
    }
  }
}

// ---- conv3x3: one 3x3 SAME conv + bias (+ ReLU) to device memory ----

constexpr int MAX_COUT = 128;

template <int CIN, typename TOut>
__global__ void __launch_bounds__(NTHREADS)
    conv3x3_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
                   const float* __restrict__ bias, TOut* __restrict__ out, int H, int W,
                   int cout, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  if constexpr (CIN == 1) {
    // x_s[(r, c)] at image (y0-1+r, x0-1+c); nine FMAs per output value.
    const float* x = reinterpret_cast<const float*>(xv) + size_t(b) * H * W;
    const float* w = reinterpret_cast<const float*>(wv);  // (cout, 9)
    float* x_s = reinterpret_cast<float*>(smem);           // (TH + 2, AP)
    float* w_s = x_s + (TH + 2) * AP;                      // (cout, 9)
    for (int i = tid; i < (TH + 2) * AP; i += NTHREADS) {
      const int gy = y0 - 1 + i / AP, gx = x0 - 1 + i % AP;
      x_s[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? x[size_t(gy) * W + gx] : 0.0f;
    }
    for (int i = tid; i < cout * 9; i += NTHREADS) w_s[i] = w[i];
    __syncthreads();
    const int groups = cout / 8;  // one item = one pixel x 8 channels
    for (int i = tid; i < TH * TW * groups; i += NTHREADS) {
      const int pix = i / groups, g = i % groups;
      const int r = pix / TW, c = pix % TW;
      if (y0 + r >= H || x0 + c >= W) continue;
      TOut* o = out + ((size_t(b) * H + y0 + r) * W + x0 + c) * cout + g * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = g * 8 + j;
        float acc = bias[co];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          acc += x_s[(r + tap / 3) * AP + c + tap % 3] * w_s[co * 9 + tap];
        o[j] = ssl_from_float<TOut>(relu ? fmaxf(acc, 0.0f) : acc);
      }
    }
  } else {
    // The input tile with its one-pixel halo: a_s[(r*AP + c)*64 + ci] at
    // image (y0-1+r, x0-1+c).
    const __nv_bfloat16* x =
        reinterpret_cast<const __nv_bfloat16*>(xv) + size_t(b) * H * W * C;
    const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(wv);  // (9, 64, cout)
    __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
    float* stage = reinterpret_cast<float*>(smem + A_BYTES) + warp * 256;
    for (int i = tid; i < AR * AP * 8; i += NTHREADS) {
      const int pix = i / 8, part = i % 8;
      const int r = pix / AP, c = pix % AP;
      const int gy = y0 - 1 + r, gx = x0 - 1 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < TH + 2 && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const uint4*>(x + (size_t(gy) * W + gx) * C + part * 8);
      *reinterpret_cast<uint4*>(a_s + size_t(pix) * C + part * 8) = v;
    }
    __syncthreads();
    for (int half = 0; half < cout / C; ++half) {  // 64 output channels at a time
      for (int run = warp; run < NRUN_B; run += NWARPS) {
        FragC acc[4];
        run_gemm(a_s, run * 16, AP, w + half * C, acc, cout);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          wmma::store_matrix_sync(stage, acc[nb], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int f = run * 16 + e / 16, co = half * C + nb * 16 + e % 16;
            const int r = f / AP, c = f % AP;
            if (c < TW && y0 + r < H && x0 + c < W) {
              const float v = stage[e] + bias[co];
              out[((size_t(b) * H + y0 + r) * W + x0 + c) * cout + co] =
                  ssl_from_float<TOut>(relu ? fmaxf(v, 0.0f) : v);
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int CIN, typename TOut>
cudaError_t launch_conv3x3(const void* x, const void* w, const float* bias, void* out, int B,
                           int H, int W, int cout, int relu, cudaStream_t stream) {
  auto kernel = conv3x3_kernel<CIN, TOut>;
  const size_t smem = CIN == 1 ? size_t((TH + 2) * AP + MAX_COUT * 9) * 4
                               : A_BYTES + STAGE_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(x, w, bias, reinterpret_cast<TOut*>(out), H, W,
                                           cout, relu);
  return cudaGetLastError();
}

}  // namespace

// x: CIN = 1 -> f32 (B, H, W); CIN = 64 -> bf16 (B, H, W, 64).
// w: CIN = 1 -> f32 (cout, 9); CIN = 64 -> bf16 (9, 64, cout) [tap][ci][co].
// bias: f32 (cout,); cout is 64 or 128. out: (B, H, W, cout), f32 if out_f32
// else bf16.
SSL_EXPORT int ssl_conv3x3(const void* x, const void* w, const float* bias, void* out, int B,
                           int cin, int cout, int H, int W, int relu, int out_f32,
                           void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((cin != 1 && cin != 64) || (cout != 64 && cout != MAX_COUT) || H < 1 || W < 1 || B < 1)
    return int(cudaErrorInvalidValue);
  if (cin == 1)
    return int(out_f32
                   ? launch_conv3x3<1, float>(x, w, bias, out, B, H, W, cout, relu, s)
                   : launch_conv3x3<1, __nv_bfloat16>(x, w, bias, out, B, H, W, cout, relu, s));
  return int(out_f32
                 ? launch_conv3x3<64, float>(x, w, bias, out, B, H, W, cout, relu, s)
                 : launch_conv3x3<64, __nv_bfloat16>(x, w, bias, out, B, H, W, cout, relu, s));
}
