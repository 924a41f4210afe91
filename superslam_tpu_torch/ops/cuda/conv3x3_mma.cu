// conv3x3: one 3x3 SAME conv with zero padding + f32 bias + optional ReLU,
// CIN 1 or 64, COUT 64 or 128, bf16 or f32 NHWC out. CIN = 64 runs on the
// tensor-core engine of conv_mma.cuh; CIN = 1 is nine f32 FMAs an output on
// the CUDA cores.
//
// Replaces superslam_tpu/ops/pallas/conv.py::conv3x3_chw (_conv_kernel);
// only the stage profiler and the tests call it (wrapper conv.py::conv3x3,
// counted "conv3x3").
//
// Bound on the H100 at conv2a's shape (2, 64, 192, 624) bf16, COUT 64:
// bytes, 31 MB in and 31 MB out = 0.0184 ms at 3.35 TB/s, against 17.7
// GFLOP of bf16 products = 0.0179 ms at 989 TFLOP/s: both bounds nearly
// meet. What the design does about it (CIN = 64; one block = one 16 x 32
// output tile):
//   * it is the CIN = 1 pair's conv_b (conv_pair_mma.cu) with the conv_a
//     prologue replaced by a load: the 18 + 1 rows x pitch-34 input tile
//     arrives by 16-byte cp.async straight into the XOR-swizzled layout
//     (swz) that conv_b's 34 flat runs read by ldmatrix.x4; a halo pixel
//     outside the image is zero-filled (source size 0), and so is the
//     overrun row that the runs' discarded columns read. About 19.3 GFLOP
//     are done for the 17.7 needed (the runs' columns 32-33 wrap).
//   * mma.sync.m16n8k16 bf16 with f32 accumulators in registers; a warp
//     keeps the accumulators of its runs (warp, warp + NWARPS3, ...) over
//     the nine taps of one pass.
//   * weights: the wrapper hands (tap, co, ci) bf16 (conv.py::_tap_out_in,
//     or conv3x3_operands prepared once). A pass covers 64 / NPASS3 output
//     channels; its nine tap slices of (64 / NPASS3) x 64 bf16 stream
//     through the engine's 3-slot cp.async ring, slice s + 2 in flight
//     while slice s is multiplied. COUT 128 is twice the passes of COUT 64.
//   * the epilogue from the accumulator layout: bias + optional ReLU, one
//     bf16x2 or float2 store of a channel pair per accumulator row.
// Where trouble was likely, and what was done:
//   * occupancy. (a) the tree: 12 warps, one 64-channel pass per 64 output
//     channels (8 n-tiles, at most 3 runs a warp: 96 accumulators, the CIN
//     = 1 pair's conv_b schedule), one block per SM by registers; (b) 8
//     warps in 32-channel passes (5 runs x 4 n-tiles, 80 accumulators) at
//     __launch_bounds__(256, 2), two blocks per SM, so that one block's
//     tile load and epilogue overlap the other's products.
//     scripts/conv_variants_torch.py builds and times both (variant
//     "w8:NWARPS3=8,NPASS3=2,MINB3=2"); PERF.md has the times, and the
//     constants below are the faster one.
//   * shared memory: tile 19 x 34 x 128 B = 82,688 B + ring 3 x (64 /
//     NPASS3) x 128 B (24,576 B or 12,288 B) = 107,264 B (94,976 B).
//   * the flat-run overrun: the farthest read is pixel 33 * 16 + 15 + 2 *
//     34 + 2 = 613 of 646 (static_assert below). The address model is
//     conv.py::mma_layout("x3") and ("w3"); tests/test_torch_conv_layout.py
//     checks it against these constants and proves every ldmatrix phase
//     conflict-free and every address in bounds.
//   * spills: chip_smoke.py reads nvcc's report of every instantiation and
//     fails on a spill.
//   * rounding: f32 accumulation, f32 bias, one rounding to the output type,
//     as the TPU kernel body.
//
// Layouts: CIN = 1 takes f32 (B, 1, H, W) and f32 (COUT, 9) weights; CIN =
// 64 takes bf16 NHWC (a channels_last (B, 64, H, W) tensor). The output is
// NHWC (channels_last (B, COUT, H, W)) in bf16 or f32.
#include "conv_mma.cuh"

namespace {

using namespace conv_mma;

constexpr int TH3 = 16;       // conv rows per block
constexpr int TW3 = 32;       // conv columns per block
constexpr int AP3 = 34;       // pixel pitch of the input tile (TW3 + 2)
constexpr int AR3 = 19;       // input tile rows: TH3 + 2, + 1 zero row for run overrun
constexpr int NRUN3 = 34;     // 16-pixel runs over 16 rows of pitch AP3 (544 pixels)
constexpr int NWARPS3 = 12;   // warps of a CIN = 64 block
constexpr int NPASS3 = 1;     // passes over each 64 output channels (1 or 2)
constexpr int MINB3 = 1;      // blocks per SM that __launch_bounds__ asks registers for
constexpr int NTHREADS3 = NWARPS3 * 32;
constexpr int NT3 = 8 / NPASS3;                        // n-tiles of 8 output channels in a pass
constexpr int SLOT_CO3 = NT3 * 8;                      // output channels (ring slot rows) of a pass
constexpr int MAXR3 = (NRUN3 + NWARPS3 - 1) / NWARPS3;  // most runs one warp owns
constexpr int RING3 = 3;                               // weight slices in shared memory
constexpr int X3_BYTES = AR3 * AP3 * 128;              // 82,688
constexpr int SMEM3_BYTES = X3_BYTES + RING3 * SLOT_CO3 * 128;  // 107,264 (one pass)
constexpr int MAX_COUT = 128;
constexpr int GRAY_THREADS = 256;  // CIN = 1
constexpr int GRAY_SMEM_BYTES = ((TH3 + 2) * AP3 + MAX_COUT * 9) * 4;  // image tile + weights

static_assert(PIX_BYTES == 128 && CH == 64, "64-channel tile pixels");
static_assert(NPASS3 * NT3 == 8 && NT3 % 2 == 0, "passes cover 64 output channels");
static_assert(NRUN3 * 16 == TH3 * AP3 && AP3 == TW3 + 2 && AR3 == TH3 + 3, "runs cover the tile");
static_assert((NRUN3 - 1) * 16 + 15 + 2 * AP3 + 2 < AR3 * AP3, "reads stay in the tile");
static_assert(SMEM3_BYTES <= 232448 && MAXR3 * NWARPS3 >= NRUN3, "shared memory and runs");

__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// CIN = 64: x bf16 NHWC (B, H, W, 64), w bf16 (9, cout, 64) [tap][co][ci].
template <typename TOut>
__global__ void __launch_bounds__(NTHREADS3, MINB3)
    conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias, TOut* __restrict__ out, int H, int W,
                       int cout, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t x_s = smem_u32(smem), ring = x_s + X3_BYTES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, y0 = blockIdx.y * TH3, x0 = blockIdx.x * TW3;
  const int nstep = 9 * (cout / SLOT_CO3);  // (pass, tap) slices

  // Slice s = (pass s / 9, tap s % 9) into ring slot s % RING3; every thread
  // commits one group per call (empty past the last slice), so the
  // wait_group counts below hold to the end.
  auto load_slice = [&](int s) {
    if (s < nstep) {
      const __nv_bfloat16* src = w + size_t((s % 9) * cout + (s / 9) * SLOT_CO3) * CH;
      for (int i = tid; i < SLOT_CO3 * 8; i += NTHREADS3)
        cp_async16(ring + (s % RING3) * (SLOT_CO3 * PIX_BYTES) + swz(i >> 3, i & 7),
                   src + (i >> 3) * CH + (i & 7) * 8, true);
    }
    cp_async_commit();
  };

  // ---- input tile: pixel (r, c) = image (y0-1+r, x0-1+c); row 18 and the
  // pixels outside the image are zero-filled ----
  const __nv_bfloat16* xb = x + size_t(b) * H * W * CH;
  for (int i = tid; i < AR3 * AP3 * 8; i += NTHREADS3) {
    const int p = i >> 3, j = i & 7;
    const int r = p / AP3, c = p - r * AP3;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    const bool inside = r < TH3 + 2 && gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16(x_s + swz(p, j), inside ? xb + (size_t(gy) * W + gx) * CH + j * 8 : xb, inside);
  }
  cp_async_commit();
  for (int s = 0; s < RING3 - 1; ++s) load_slice(s);

  float acc[MAXR3][NT3][4];
  const int g = lane >> 2, t2 = 2 * (lane & 3);  // accumulator row and column pair
  const int nrun = (NRUN3 - warp + NWARPS3 - 1) / NWARPS3;
  for (int s = 0; s < nstep; ++s) {
    cp_async_wait<RING3 - 2>();  // this thread's part of slice s (and the tile) landed
    __syncthreads();             // everyone's has; slot (s - 1) % RING3 is free again
    load_slice(s + RING3 - 1);
    const int tap = s % 9;
    if (tap == 0) {
#pragma unroll
      for (int r = 0; r < MAXR3; ++r)
#pragma unroll
        for (int nt = 0; nt < NT3; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][nt][e] = 0.0f;
    }
    tap_step(acc, x_s, warp, NWARPS3, nrun, (tap / 3) * AP3 + tap % 3,
             ring + (s % RING3) * (SLOT_CO3 * PIX_BYTES), lane);
    if (tap != 8) continue;

    // ---- epilogue of one pass: run pixel f of pitch AP3 is tile pixel
    // (rr, cc); columns 32 and 33 wrap and are dropped ----
    const int co0 = (s / 9) * SLOT_CO3 + t2;  // this lane's first channel in n-tile 0
#pragma unroll
    for (int r = 0; r < MAXR3; ++r) {
      if (r >= nrun) break;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int f = (warp + r * NWARPS3) * 16 + g + 8 * hr;
        const int rr = f / AP3, cc = f - rr * AP3;
        if (cc >= TW3 || y0 + rr >= H || x0 + cc >= W) continue;
        TOut* o = out + ((size_t(b) * H + y0 + rr) * W + x0 + cc) * cout + co0;
#pragma unroll
        for (int nt = 0; nt < NT3; ++nt) {
          float v0 = acc[r][nt][2 * hr] + __ldg(bias + co0 + nt * 8);
          float v1 = acc[r][nt][2 * hr + 1] + __ldg(bias + co0 + nt * 8 + 1);
          if (relu) v0 = fmaxf(v0, 0.0f), v1 = fmaxf(v1, 0.0f);
          store2(o + nt * 8, v0, v1);
        }
      }
    }
  }
}

// CIN = 1: x f32 (B, H, W), w f32 (cout, 9). x_s[(r, c)] is image (y0-1+r,
// x0-1+c); nine FMAs per output value. Memory-bound and on no path.
template <typename TOut>
__global__ void __launch_bounds__(GRAY_THREADS)
    conv3x3_gray_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, TOut* __restrict__ out, int H, int W,
                        int cout, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.z, y0 = blockIdx.y * TH3, x0 = blockIdx.x * TW3;
  const float* xb = x + size_t(b) * H * W;
  float* x_s = reinterpret_cast<float*>(smem);  // (TH3 + 2, AP3)
  float* w_s = x_s + (TH3 + 2) * AP3;           // (cout, 9)
  for (int i = tid; i < (TH3 + 2) * AP3; i += GRAY_THREADS) {
    const int gy = y0 - 1 + i / AP3, gx = x0 - 1 + i % AP3;
    x_s[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? xb[size_t(gy) * W + gx] : 0.0f;
  }
  for (int i = tid; i < cout * 9; i += GRAY_THREADS) w_s[i] = w[i];
  __syncthreads();
  const int groups = cout / 8;  // one item = one pixel x 8 channels
  for (int i = tid; i < TH3 * TW3 * groups; i += GRAY_THREADS) {
    const int pix = i / groups, gr = i % groups;
    const int r = pix / TW3, c = pix % TW3;
    if (y0 + r >= H || x0 + c >= W) continue;
    TOut* o = out + ((size_t(b) * H + y0 + r) * W + x0 + c) * cout + gr * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = gr * 8 + j;
      float a = bias[co];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) a += x_s[(r + tap / 3) * AP3 + c + tap % 3] * w_s[co * 9 + tap];
      o[j] = ssl_from_float<TOut>(relu ? fmaxf(a, 0.0f) : a);
    }
  }
}

template <typename TOut>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out, int B, int cin,
                   int H, int W, int cout, int relu, cudaStream_t stream) {
  const dim3 grid((W + TW3 - 1) / TW3, (H + TH3 - 1) / TH3, B);
  if (cin == 1) {
    auto kernel = conv3x3_gray_kernel<TOut>;
    kernel<<<grid, GRAY_THREADS, GRAY_SMEM_BYTES, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<TOut*>(out), H, W, cout, relu);
    return cudaGetLastError();
  }
  auto kernel = conv3x3_mma_kernel<TOut>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM3_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS3, SMEM3_BYTES, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                                   static_cast<const __nv_bfloat16*>(w), bias,
                                                   static_cast<TOut*>(out), H, W, cout, relu);
  return cudaGetLastError();
}

}  // namespace

// x: CIN = 1 -> f32 (B, H, W); CIN = 64 -> bf16 (B, H, W, 64).
// w: CIN = 1 -> f32 (cout, 9); CIN = 64 -> bf16 (9, cout, 64) [tap][co][ci].
// bias: f32 (cout,); cout is 64 or 128. out: (B, H, W, cout), f32 if out_f32
// else bf16. CIN = 64 needs x, w and out 16-byte aligned
// (cudaErrorMisalignedAddress).
SSL_EXPORT int ssl_conv3x3(const void* x, const void* w, const float* bias, void* out, int B,
                           int cin, int cout, int H, int W, int relu, int out_f32,
                           void* stream) {
  if ((cin != 1 && cin != CH) || (cout != CH && cout != MAX_COUT) || H < 1 || W < 1 || B < 1)
    return int(cudaErrorInvalidValue);
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(out);
  if (cin == CH && any % 16 != 0) return int(cudaErrorMisalignedAddress);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return int(out_f32 ? launch<float>(x, w, bias, out, B, cin, H, W, cout, relu, s)
                     : launch<__nv_bfloat16>(x, w, bias, out, B, cin, H, W, cout, relu, s));
}
