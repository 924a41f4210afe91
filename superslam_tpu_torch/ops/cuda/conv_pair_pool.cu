// conv_pair_pool: maxpool2x2(relu(conv_b(relu(conv_a(x) + ba)) + bb)) for
// the gray image (CIN = 1).
//
// Replaces superslam_tpu/ops/pallas/conv.py::conv1a1b_chw with
// pool_vert=True (kernel body _conv_pair_pool_kernel) plus the XLA
// hpool_canvas that finishes its pool. Both convs are 3x3 SAME with zero
// padding; conv_a maps 1 -> 64 channels, conv_b 64 -> 64. The 64-channel
// pair (conv_pair_chw) runs on the mma.sync engine in conv_pair_mma.cu; the
// exported entry points below send cin == 64 there.
//
// Bound on the H100: operations. SuperPoint's conv1a+conv1b pair at the
// KITTI shape (2 x 384 x 1248) is ~71 GFLOP against ~4 MB of image in and
// ~20 MB of pooled map out.
// What the design does about it:
//   * conv_b runs on the tensor cores as an implicit GEMM through WMMA bf16
//     16x16x16 fragments with f32 accumulation; no im2col is materialised
//     anywhere. conv_a (one input channel) is nine FMAs per output.
//   * a block owns a 16-row x 32-column conv tile. The conv_a map of the
//     tile plus its one-pixel halo (18 x 34 x 64 bf16) lives only in shared
//     memory, and the 2x2 pool runs in the epilogue (shared-memory atomic
//     max of the non-negative ReLU outputs), so neither the conv_a map nor
//     the full-resolution conv_b map ever reaches device memory.
//   * "flat runs": a warp's 16 GEMM rows are 16 consecutive pixels of the
//     tile stored with a fixed pixel pitch, so each 3x3 tap is one
//     constant offset into shared memory and one fragment load. The
//     columns that wrap past the tile edge are computed and discarded
//     (6-7% extra work) instead of being special-cased.
// Later work (ROADMAP queue 2): move conv_b onto conv_mma.cuh's engine
// (swizzled tile, mma.sync, cp.async weight ring), as conv_pair_mma.cu did
// for the 64-channel pair.
//
// The same file holds the two conv kernels that only the stage profiler
// and the tests call:
//   * conv_pair (POOL = false): the unpooled conv1a1b_chw (kernel body
//     _conv1a1b_kernel). The same kernel with the pool epilogue replaced by
//     stores of the conv_b tile to device memory, 16 channels (32 bytes in
//     bf16) at a time. Bound: operations, as the pooled pair.
//   * conv3x3: conv3x3_chw (_conv_kernel), one 3x3 SAME conv + f32 bias +
//     optional ReLU, CIN 1 or 64, COUT 64 or 128. CIN = 64 loads the input
//     tile with its halo where the pair kernel keeps its conv_a tile and
//     runs the conv_b stage on it; CIN = 1 is nine FMAs per output. Bound at
//     conv2a's shape (2, 64, 192, 624) bf16: bytes, 61 MB in and out =
//     0.0183 ms against 17.7 GFLOP = 0.0179 ms; the only conv here that
//     device memory, not the tensor cores, limits.
//
// Layouts: CIN = 1 takes f32 (B, 1, H, W); conv3x3 with CIN = 64 takes bf16
// NHWC (a channels_last (B, 64, H, W) tensor). The output is NHWC
// (channels_last (B, 64, H/2, W/2) pooled, (B, COUT, H, W) unpooled) in bf16
// or f32. H and W are even where the pool runs.
#include <mma.h>

#include "common.cuh"
#include "conv_mma.cuh"

using namespace nvcuda;

namespace {

constexpr int C = 64;           // conv_a output, conv_b input and output channels
constexpr int TH = 16;          // conv rows per block (8 pooled rows)
constexpr int TW = 32;          // conv columns per block (16 pooled columns)
constexpr int AP = TW + 2;      // pixel pitch of the conv_a tile
constexpr int AR = TH + 2 + 1;  // conv_a tile rows: 18 + 1 zero row for run overrun
constexpr int XP = TW + 4;      // pixel pitch of the input tile
constexpr int XR = TH + 4 + 1;  // input tile rows: 20 + 1 zero row for run overrun
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PH = TH / 2, PW = TW / 2;
constexpr int NRUN_B = TH * AP / 16;  // 34 runs cover the 16 x 32 conv_b tile

constexpr size_t A_BYTES = size_t(AR) * AP * C * 2;       // 82,688
constexpr size_t POOL_BYTES = size_t(PH) * PW * C * 4;    // 32,768 (first the f32 image tile)
constexpr size_t STAGE_BYTES = size_t(NWARPS) * 256 * 4;  // 8,192
constexpr size_t PAIR_SMEM_BYTES = A_BYTES + POOL_BYTES + STAGE_BYTES;

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

// POOL: the 2x2 max pool in the epilogue, out (B, H/2, W/2, 64); else the
// conv_b tile itself, out (B, H, W, 64).
template <typename TOut, bool POOL>
__global__ void __launch_bounds__(NTHREADS)
    conv_pair_pool_kernel(const float* __restrict__ x, const float* __restrict__ wa,
                          const float* __restrict__ ba,
                          const __nv_bfloat16* __restrict__ wb,
                          const float* __restrict__ bb, TOut* __restrict__ out, int H,
                          int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* u_s = smem + A_BYTES;  // input tile, then the pooled tile
  float* stage_all = reinterpret_cast<float*>(smem + A_BYTES + POOL_BYTES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  float* stage = stage_all + warp * 256;

  // ---- conv_a tile: a_s[(r*AP + c)*64 + co] at image (y0-1+r, x0-1+c) ----
  {
    x += size_t(b) * H * W;
    float* x_s = reinterpret_cast<float*>(u_s);  // (XR, XP) f32
    float* wa_s = x_s + XR * XP;                 // (64, 9)
    for (int i = tid; i < XR * XP; i += NTHREADS) {
      const int r = i / XP, c = i % XP;
      const int gy = y0 - 2 + r, gx = x0 - 2 + c;
      x_s[i] = (r < TH + 4 && gy >= 0 && gy < H && gx >= 0 && gx < W)
                   ? x[size_t(gy) * W + gx]
                   : 0.0f;
    }
    for (int i = tid; i < C * 9; i += NTHREADS) wa_s[i] = wa[i];
    __syncthreads();
    // One item = one conv_a pixel x 8 channels, written as one 16-byte store.
    for (int i = tid; i < AR * AP * 8; i += NTHREADS) {
      const int pix = i / 8, g = i % 8;
      const int r = pix / AP, c = pix % AP;
      const int gy = y0 - 1 + r, gx = x0 - 1 + c;
      const bool inside = r < TH + 2 && gy >= 0 && gy < H && gx >= 0 && gx < W;
      __align__(16) __nv_bfloat16 v8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = g * 8 + j;
        float acc = ba[co];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          acc += x_s[(r + tap / 3) * XP + c + tap % 3] * wa_s[co * 9 + tap];
        v8[j] = __float2bfloat16(inside ? fmaxf(acc, 0.0f) : 0.0f);
      }
      *reinterpret_cast<uint4*>(a_s + size_t(pix) * C + g * 8) =
          *reinterpret_cast<const uint4*>(v8);
    }
  }
  __syncthreads();

  // ---- conv_b + ReLU (+ 2x2 max pool into pool_s, which aliases the input tile) ----
  float* pool_s = reinterpret_cast<float*>(u_s);  // (PH, PW, 64)
  if constexpr (POOL) {
    for (int i = tid; i < PH * PW * C; i += NTHREADS) pool_s[i] = 0.0f;
    __syncthreads();
  }
  for (int run = warp; run < NRUN_B; run += NWARPS) {
    FragC acc[4];
    run_gemm(a_s, run * 16, AP, wb, acc);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      wmma::store_matrix_sync(stage, acc[nb], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int f = run * 16 + e / 16, co = nb * 16 + e % 16;
        const int r = f / AP, c = f % AP;
        if (c < TW && y0 + r < H && x0 + c < W) {
          const float v = fmaxf(stage[e] + bb[co], 0.0f);
          if constexpr (POOL) {
            // ReLU outputs are >= 0, so their IEEE bit patterns order as ints.
            atomicMax(reinterpret_cast<int*>(pool_s) + ((r / 2) * PW + c / 2) * C + co,
                      __float_as_int(v));
          } else {
            out[((size_t(b) * H + y0 + r) * W + x0 + c) * C + co] = ssl_from_float<TOut>(v);
          }
        }
      }
      __syncwarp();
    }
  }
  if constexpr (!POOL) return;
  __syncthreads();

  const int Ho = H / 2, Wo = W / 2;
  for (int i = tid; i < PH * PW * C; i += NTHREADS) {
    const int co = i % C, pix = i / C;
    const int oy = y0 / 2 + pix / PW, ox = x0 / 2 + pix % PW;
    if (oy < Ho && ox < Wo)
      out[((size_t(b) * Ho + oy) * Wo + ox) * C + co] = ssl_from_float<TOut>(pool_s[i]);
  }
}

template <typename TOut, bool POOL>
cudaError_t launch(const void* x, const void* wa, const float* ba, const void* wb,
                   const float* bb, void* out, int B, int H, int W,
                   cudaStream_t stream) {
  auto kernel = conv_pair_pool_kernel<TOut, POOL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(PAIR_SMEM_BYTES));
  if (err != cudaSuccess) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NTHREADS, PAIR_SMEM_BYTES, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wa), ba,
      static_cast<const __nv_bfloat16*>(wb), bb, static_cast<TOut*>(out), H, W);
  return cudaGetLastError();
}

template <bool POOL>
cudaError_t dispatch(const void* x, const void* wa, const float* ba, const void* wb,
                     const float* bb, void* out, int B, int cin, int H, int W, int out_f32,
                     cudaStream_t s) {
  if (cin == 64) return conv_pair_mma(x, wa, ba, wb, bb, out, B, H, W, out_f32, POOL, s);
  return out_f32 ? launch<float, POOL>(x, wa, ba, wb, bb, out, B, H, W, s)
                 : launch<__nv_bfloat16, POOL>(x, wa, ba, wb, bb, out, B, H, W, s);
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
    // The input tile with its one-pixel halo, laid out as the pair kernel's
    // conv_a tile: a_s[(r*AP + c)*64 + ci] at image (y0-1+r, x0-1+c).
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
// wa: CIN = 1 -> f32 (64, 9); CIN = 64 -> bf16 (9, 64, 64) [tap][co][ci].
// wb: CIN = 1 -> bf16 (9, 64, 64) [tap][ci][co]; CIN = 64 -> [tap][co][ci].
// ba, bb: f32 (64,). out: (B, H/2, W/2, 64), f32 if out_f32 else bf16.
// CIN = 64 needs x, wa, wb and out 16-byte aligned (cudaErrorMisalignedAddress).
SSL_EXPORT int ssl_conv_pair_pool(const void* x, const void* wa, const float* ba,
                                  const void* wb, const float* bb, void* out, int B,
                                  int cin, int H, int W, int out_f32, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((cin != 1 && cin != 64) || H % 2 != 0 || W % 2 != 0 || B < 1)
    return int(cudaErrorInvalidValue);
  return int(dispatch<true>(x, wa, ba, wb, bb, out, B, cin, H, W, out_f32, s));
}

// The same operands, no pool: out is (B, H, W, 64); H and W >= 1.
SSL_EXPORT int ssl_conv_pair(const void* x, const void* wa, const float* ba, const void* wb,
                             const float* bb, void* out, int B, int cin, int H, int W,
                             int out_f32, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((cin != 1 && cin != 64) || H < 1 || W < 1 || B < 1) return int(cudaErrorInvalidValue);
  return int(dispatch<false>(x, wa, ba, wb, bb, out, B, cin, H, W, out_f32, s));
}

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
