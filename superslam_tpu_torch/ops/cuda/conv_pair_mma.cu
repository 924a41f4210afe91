// conv_pair_mma: relu(conv_b(relu(conv_a(x) + ba)) + bb) for both conv pairs
// of SuperPoint's encoder, CIN = 1 (the gray image: conv1a + conv1b) or
// CIN = 64 (conv2a + conv2b), 64 output channels in each conv, two 3x3 SAME
// convs with zero padding, with (POOL) or without the 2x2 max pool, on the
// tensor-core engine of conv_mma.cuh.
//
// Replaces superslam_tpu/ops/pallas/conv.py::conv1a1b_chw (CIN = 1) and
// ::conv_pair_chw (CIN = 64), each with pool_vert (kernel body
// _conv_pair_pool_kernel plus the XLA hpool_canvas that finishes its pool;
// wrapper conv.py::conv_pair_pool, counted "conv1a1b" / "conv_pair") and
// without (_conv1a1b_kernel / _conv_pair_kernel; wrapper conv.py::conv_pair,
// counted "conv1a1b_full" / "conv_pair_full"). conv3x3 is conv3x3_mma.cu,
// this schedule's conv_b on a loaded tile.
//
// Bound on the H100: operations. At (2, 64, 192, 624) the 64-channel pair is
// 35.3 GFLOP of bf16 products, 0.0357 ms at 989 TFLOP/s, against 31 MB in
// and 8 MB (pooled) or 31 MB (unpooled) out, 0.012-0.018 ms at 3.35 TB/s.
// At (2, 1, 384, 1248) the gray pair is 70.7 GFLOP of bf16 conv_b products
// and 1.1 GFLOP of f32 conv_a, 0.0879 ms, against 4 MB in and 31 MB
// (pooled) or 123 MB (unpooled) out. What the design does about it (one
// block = one 16 x 32 conv tile, 12 warps):
//   * tensor cores through mma.sync.m16n8k16 bf16 with f32 accumulators in
//     registers. A warp's 16 GEMM rows are one "flat run" of 16 consecutive
//     tile pixels, so a 3x3 tap is one constant pixel offset (ky * pitch +
//     kx); the columns that wrap past the tile edge are computed and
//     discarded. conv_b covers the 16 x 32 tile with 34 runs at the conv_a
//     tile's pitch (34); for CIN = 64 conv_a covers the 18 x 34 halo tile
//     with 41 runs at the input tile's pitch (36): about 42 GFLOP done for
//     the 35.3 needed (CIN = 64), 75 for the 70.7 (CIN = 1).
//   * A from XOR-swizzled NHWC tiles by ldmatrix.x4 (conv_mma.cuh), so the
//     128-byte pixel pitch no longer puts a phase's 8 rows in one bank group.
//   * CIN = 1: conv_a has one input channel, nine FMAs an output, so it runs
//     on the CUDA cores in f32 from the f32 image, as the TPU kernel's
//     shifted_a mode keeps it. Thread t computes channel chunk j = t & 7 (8
//     channels, their 72 weights and 8 biases in registers, loaded as 16-byte
//     reads of the (64, 9) weights) of conv_a tile pixels (t >> 3) + 48k and
//     writes each as one 16-byte store at swz(p, j): the 8 lanes of a store
//     phase write the 8 chunks of one 128-byte row, conflict-free. The f32
//     image tile (20 x 36, 2,880 B) arrives by 4-byte cp.async (the rows start
//     off 16-byte alignment) into the input region, which is dead for CIN = 1
//     once conv_a is written; the first conv_b slices are in flight behind it.
//   * CIN = 64: the conv_a map goes from the accumulators (bias + ReLU) into
//     the swizzled conv_a tile. Either way it is rounded to bf16 as the TPU
//     kernel rounds it in VMEM, zero outside the image (conv_b's padding), and
//     never leaves shared memory.
//   * weights: the wrapper hands conv_b's (and CIN = 64's conv_a's) weights
//     as (tap, co, ci) bf16. A step multiplies one ring slice: (tap, 8 * NT
//     output channels, 64 input channels) of one conv. CIN = 64 runs 36 steps:
//     (conv s / 18, output channels 32 * ((s / 9) % 2) + [0, 32), tap s % 9).
//     CIN = 1 runs conv_b only, in NPASS1 passes of 9 taps over 64 / NPASS1
//     output channels. Slices stream through a 3-slot cp.async ring, slice s
//     + 2 in flight while slice s is multiplied, each read from L2 once per
//     block.
//   * taps outside, runs inside: a warp keeps the accumulators of all its
//     runs (runs warp, warp + 12, ...) across the nine taps of one slice.
//     12 warps, not 8: three a scheduler hide more of the ldmatrix and
//     mma latency (~9% faster at (2, 64, 192, 624) on an H100;
//     scripts/conv_variants_torch.py builds and times such variants).
//   * CIN = 64's input tile arrives by cp.async (16-byte cg, source size 0
//     zero-fills halo pixels outside the image), behind the first two slices.
//   * epilogues from the known accumulator layout: the unpooled pair stores
//     bf16x2 (or float2) channel pairs to device memory; the pooled pair
//     takes the horizontal half of the 2x2 max with one __shfl_xor (lane ^ 4
//     holds the run's next pixel: the pitch and run starts are even) and
//     stages the result in f32 in shared memory aliasing the dead input tile;
//     a last pass takes the vertical half and writes the pooled tile. No
//     atomics: the result does not depend on the order of the warps.
// Where trouble was likely, and what was done:
//   * shared memory: input region 21 x 36 pixels (20 rows + 1 overrun row)
//     96,768 B + conv_a tile 19 x 34 (18 + 1) 82,688 B + ring 3 x 4,096 B
//     (CIN = 1 in one pass: 3 x 8,192 B) = 191,744 B (204,032 B) of the
//     232,448 a block may have; both convs' weights resident (147,456 B)
//     would not fit beside the tiles. The pool staging tile (16 x 16 x 72 f32
//     = 73,728 B; 72 floats a pixel, 8 of padding, keeps the shuffled stores
//     off one bank group) aliases the input region.
//   * registers: CIN = 64 splits N into two halves of 32 output channels
//     (two passes over the taps per conv), so a run holds 16 accumulators a
//     lane; warps 0-4 own 4 conv_a runs (64 accumulator registers). CIN = 1
//     has no conv_a runs: a warp owns at most 3 conv_b runs, which leaves
//     room for all 64 output channels in one pass (96 accumulators), so each
//     A fragment feeds 8 mma, not 4. chip_smoke.py prints nvcc's registers
//     and spills of every instantiation and fails on any spill.
//   * the flat-run overrun: runs past the tile's last row read the overrun
//     row (input tile: zero-filled by cp.async; conv_a tile: zeroed here).
//     The farthest reads are pixel 729 of 756 (conv_a) and 613 of 646
//     (conv_b): static_asserts below, and tests/test_torch_conv_layout.py.
//   * rounding: conv_a is rounded to bf16 before conv_b, as the TPU kernel.
// The address model (swizzle, pitches, run starts, tap offsets, ring, image
// tile, conv_a prologue and pool offsets) is mirrored by
// conv.py::mma_layout; the CPU test checks it against the constants below
// and proves every ldmatrix and prologue store phase conflict-free and every
// address inside its allocation.
#include "conv_mma.cuh"

namespace {

using namespace conv_mma;

constexpr int TH = 16;      // conv rows per block (8 pooled rows)
constexpr int TW = 32;      // conv columns per block (16 pooled columns)
constexpr int XP = 36;      // pixel pitch of the input tile (TW + 4)
constexpr int XR = 21;      // input tile rows: TH + 4, + 1 zero row for run overrun
constexpr int IMG_R = 20;   // rows of CIN = 1's f32 image tile (TH + 4, pitch XP)
constexpr int AP = 34;      // pixel pitch of the conv_a tile (TW + 2)
constexpr int AR = 19;      // conv_a tile rows: TH + 2, + 1 zero row for run overrun
constexpr int NRUN_A = 41;  // 16-pixel runs over 18 rows of pitch XP (648 pixels)
constexpr int NRUN_B = 34;  // runs over 16 rows of pitch AP (544 pixels)
constexpr int NWARPS = 12;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXR = (NRUN_A + NWARPS - 1) / NWARPS;   // most runs one warp owns (CIN = 64)
constexpr int MAXR1 = (NRUN_B + NWARPS - 1) / NWARPS;  // the same for CIN = 1 (conv_b only)
constexpr int RING = 3;     // weight slices in shared memory
constexpr int NSTEP = 36;   // CIN = 64: 2 convs x 2 halves of the output channels x 9 taps
constexpr int NPASS1 = 1;   // CIN = 1: conv_b passes over the output channels (1 or 2)
constexpr int NT1 = 8 / NPASS1;  // CIN = 1: n-tiles of 8 output channels in one pass
constexpr int PW = 16;      // pooled columns of the tile (TW / 2)
constexpr int HP_PITCH = 72;  // floats per pixel of the pool staging tile
constexpr int X_BYTES = XR * XP * 128;                  // 96,768
constexpr int IMG_BYTES = IMG_R * XP * 4;               // 2,880, in the input region
constexpr int A_BYTES = AR * AP * 128;                  // 82,688
constexpr int SMEM_BYTES = X_BYTES + A_BYTES + RING * 4096;  // 191,744 (CIN = 64)
constexpr int HP_BYTES = TH * PW * HP_PITCH * 4;       // 73,728, aliases the input region

// The schedule's shape for one CIN: runs a warp owns, n-tiles of one ring
// slice, steps, bytes of a ring slot and of the block's shared memory.
__host__ __device__ constexpr int maxr(int cin) { return cin == 1 ? MAXR1 : MAXR; }
__host__ __device__ constexpr int ntiles(int cin) { return cin == 1 ? NT1 : SLICE_CO / 8; }
__host__ __device__ constexpr int nstep(int cin) { return cin == 1 ? 9 * NPASS1 : NSTEP; }
__host__ __device__ constexpr int slot_bytes(int cin) { return ntiles(cin) * 8 * PIX_BYTES; }
__host__ __device__ constexpr int smem_bytes(int cin) {
  return X_BYTES + A_BYTES + RING * slot_bytes(cin);
}

static_assert(PIX_BYTES == 128 && SLICE_BYTES == 4096, "tile pixel and ring slice sizes");
static_assert(smem_bytes(64) == SMEM_BYTES && smem_bytes(1) <= 232448, "shared memory");
static_assert(NPASS1 * NT1 == 8 && NT1 % 2 == 0, "CIN = 1 passes cover the 64 channels");
static_assert(NRUN_A * 16 >= (TH + 2) * XP && NRUN_B * 16 == TH * AP, "runs cover the tiles");
static_assert((NRUN_A - 1) * 16 + 15 + 2 * XP + 2 < XR * XP, "conv_a reads stay in the input tile");
static_assert((NRUN_B - 1) * 16 + 15 + 2 * AP + 2 < AR * AP, "conv_b reads stay in the conv_a tile");
static_assert(HP_BYTES <= X_BYTES && IMG_BYTES <= X_BYTES && AP % 2 == 0,
              "pool staging, image tile and lane pairs");
static_assert(NTHREADS % 8 == 0, "the conv_a prologue keeps one channel chunk per thread");

__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store4(float* o, float4 v) {
  *reinterpret_cast<float4*>(o) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(o) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// CIN = 1: x f32 (B, H, W), wa f32 (64, 9). CIN = 64: x bf16 NHWC, wa bf16
// (9, 64, 64) [tap][co][ci]. wb bf16 (9, 64, 64) [tap][co][ci] for both.
template <int CIN, typename TOut, bool POOL>
__global__ void __launch_bounds__(NTHREADS, 1)
    conv_pair_mma_kernel(const void* __restrict__ xv, const void* __restrict__ wav,
                         const float* __restrict__ ba, const __nv_bfloat16* __restrict__ wb,
                         const float* __restrict__ bb, TOut* __restrict__ out, int H, int W) {
  constexpr bool GRAY = CIN == 1;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* a_tile = smem + X_BYTES;
  const uint32_t x_s = smem_u32(smem), a_s = x_s + X_BYTES, ring = a_s + A_BYTES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  // Weight slice s into ring slot s % RING, one 16-byte chunk per copy.
  // Every thread commits one group per call (empty past the last slice), so
  // the wait_group counts below hold to the end.
  auto load_slice = [&](int s) {
    if (s < nstep(CIN)) {
      const __nv_bfloat16* w =
          (!GRAY && s < NSTEP / 2) ? static_cast<const __nv_bfloat16*>(wav) : wb;
      const int part = GRAY ? s / 9 : (s / 9) & 1;  // which 8 * NT output channels
      w += size_t((s % 9) * CH + part * ntiles(CIN) * 8) * CH;
      for (int i = tid; i < ntiles(CIN) * 8 * 8; i += NTHREADS)
        cp_async16(ring + (s % RING) * slot_bytes(CIN) + swz(i >> 3, i & 7),
                   w + (i >> 3) * CH + (i & 7) * 8, true);
    }
    cp_async_commit();
  };

  if constexpr (GRAY) {
    // ---- f32 image tile: (r, c) = image (y0-2+r, x0-2+c), zero outside ----
    const float* xb = static_cast<const float*>(xv) + size_t(b) * H * W;
    for (int i = tid; i < IMG_R * XP; i += NTHREADS) {
      const int r = i / XP, c = i - r * XP;
      const int gy = y0 - 2 + r, gx = x0 - 2 + c;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async4(x_s + 4 * i, inside ? xb + size_t(gy) * W + gx : xb, inside);
    }
  } else {
    // ---- input tile: pixel (r, c) = image (y0-2+r, x0-2+c); row 20 and the
    // pixels outside the image are zero-filled ----
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(xv) + size_t(b) * H * W * CH;
    for (int i = tid; i < XR * XP * 8; i += NTHREADS) {
      const int p = i >> 3, j = i & 7;
      const int r = p / XP, c = p - r * XP;
      const int gy = y0 - 2 + r, gx = x0 - 2 + c;
      const bool inside = r < TH + 4 && gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(x_s + swz(p, j), inside ? xb + (size_t(gy) * W + gx) * CH + j * 8 : xb, inside);
    }
  }
  cp_async_commit();
  for (int s = 0; s < RING - 1; ++s) load_slice(s);
  // The conv_a tile's overrun row is read by conv_b's discarded columns
  // only; keep it finite.
  for (int i = tid; i < AP * 8; i += NTHREADS)
    *reinterpret_cast<uint4*>(a_tile + (TH + 2) * AP * PIX_BYTES + i * 16) = make_uint4(0, 0, 0, 0);

  if constexpr (GRAY) {
    // ---- conv_a on the CUDA cores: channels 8j..8j+7 of conv_a tile pixel
    // p = image (y0-1+r, x0-1+c), f32, bias + ReLU, bf16 into the tile ----
    const int j = tid & 7;
    float wr[72], br[8];
    const float4* wj = reinterpret_cast<const float4*>(static_cast<const float*>(wav)) + j * 18;
#pragma unroll
    for (int q = 0; q < 18; ++q) {
      const float4 v = __ldg(wj + q);
      wr[4 * q] = v.x, wr[4 * q + 1] = v.y, wr[4 * q + 2] = v.z, wr[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) br[i] = __ldg(ba + 8 * j + i);
    cp_async_wait<RING - 1>();  // this thread's part of the image tile landed
    __syncthreads();            // everyone's has
    const float* img = reinterpret_cast<const float*>(smem);
    for (int p = tid >> 3; p < (TH + 2) * AP; p += NTHREADS / 8) {
      const int r = p / AP, c = p - r * AP;
      const int gy = y0 - 1 + r, gx = x0 - 1 + c;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float v[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) v[tap] = img[(r + tap / 3) * XP + c + tap % 3];
      uint32_t packed[4];
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        float s0 = br[i], s1 = br[i + 1];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          s0 = fmaf(v[tap], wr[i * 9 + tap], s0);
          s1 = fmaf(v[tap], wr[(i + 1) * 9 + tap], s1);
        }
        packed[i / 2] = inside ? bf16x2_bits(fmaxf(s0, 0.0f), fmaxf(s1, 0.0f)) : 0u;
      }
      *reinterpret_cast<uint4*>(a_tile + swz(p, j)) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }

  float acc[maxr(CIN)][ntiles(CIN)][4];
  const int g = lane >> 2, t2 = 2 * (lane & 3);  // accumulator row and column pair
  float* hp = reinterpret_cast<float*>(smem);   // pool staging, after the input tile
  for (int s = 0; s < nstep(CIN); ++s) {
    cp_async_wait<RING - 2>();  // this thread's part of slice s (and the tile) landed
    __syncthreads();            // everyone's has; slot (s - 1) % RING is free again
    load_slice(s + RING - 1);
    const bool second = GRAY || s >= NSTEP / 2;  // conv_b
    const int half = GRAY ? s / 9 : (s / 9) & 1, tap = s % 9;
    const int pitch = second ? AP : XP;
    const int nrun = ((second ? NRUN_B : NRUN_A) - warp + NWARPS - 1) / NWARPS;
    if (tap == 0) {
#pragma unroll
      for (int r = 0; r < maxr(CIN); ++r)
#pragma unroll
        for (int nt = 0; nt < ntiles(CIN); ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][nt][e] = 0.0f;
    }
    tap_step(acc, second ? a_s : x_s, warp, NWARPS, nrun, (tap / 3) * pitch + tap % 3,
             ring + (s % RING) * slot_bytes(CIN), lane);
    if (tap != 8) continue;

    // ---- epilogue of one pass over 8 * NT output channels ----
    const int co0 = half * ntiles(CIN) * 8 + t2;  // this lane's first channel in n-tile 0
    if (!second) {
      // conv_a pixel f of the input tile's pitch is conv_a tile pixel (r, c)
      // = image (y0-1+r, x0-1+c); bias + ReLU + bf16 into the conv_a tile.
#pragma unroll
      for (int r = 0; r < maxr(CIN); ++r) {
        if (r >= nrun) break;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int f = (warp + r * NWARPS) * 16 + g + 8 * hr;
          const int rr = f / XP, cc = f - rr * XP;
          if (rr >= TH + 2 || cc >= AP) continue;
          const int gy = y0 - 1 + rr, gx = x0 - 1 + cc;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const int p = rr * AP + cc;
#pragma unroll
          for (int nt = 0; nt < ntiles(CIN); ++nt) {
            const int co = co0 + nt * 8;
            const float v0 = inside ? fmaxf(acc[r][nt][2 * hr] + ba[co], 0.0f) : 0.0f;
            const float v1 = inside ? fmaxf(acc[r][nt][2 * hr + 1] + ba[co + 1], 0.0f) : 0.0f;
            *reinterpret_cast<__nv_bfloat162*>(a_tile + swz(p, co >> 3) + (co & 7) * 2) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    } else {
      // conv_b pixel f of the conv_a tile's pitch is conv tile pixel (r, c).
#pragma unroll
      for (int r = 0; r < maxr(CIN); ++r) {
        if (r >= nrun) break;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int f = (warp + r * NWARPS) * 16 + g + 8 * hr;
          const int rr = f / AP, cc = f - rr * AP;
#pragma unroll
          for (int nt = 0; nt < ntiles(CIN); ++nt) {
            const int co = co0 + nt * 8;
            float v0 = fmaxf(acc[r][nt][2 * hr] + bb[co], 0.0f);
            float v1 = fmaxf(acc[r][nt][2 * hr + 1] + bb[co + 1], 0.0f);
            if constexpr (POOL) {
              // Row g ^ 1 of the run (lane ^ 4) is the horizontal neighbour.
              v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
              v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
              if ((g & 1) == 0 && cc < TW)
                *reinterpret_cast<float2*>(hp + (rr * PW + (cc >> 1)) * HP_PITCH + co) =
                    make_float2(v0, v1);
            } else {
              if (cc < TW && y0 + rr < H && x0 + cc < W)
                store2(out + ((size_t(b) * H + y0 + rr) * W + x0 + cc) * CH + co, v0, v1);
            }
          }
        }
      }
    }
  }
  if constexpr (POOL) {
    // ---- vertical half of the pool: staging rows 2py and 2py+1 ----
    __syncthreads();
    const int Ho = H / 2, Wo = W / 2;
    for (int i = tid; i < (TH / 2) * PW * (CH / 4); i += NTHREADS) {
      const int c4 = (i & 15) * 4, pix = i >> 4;
      const int py = pix / PW, px = pix - py * PW;
      const int oy = y0 / 2 + py, ox = x0 / 2 + px;
      if (oy >= Ho || ox >= Wo) continue;
      const float4 u = *reinterpret_cast<const float4*>(hp + (2 * py * PW + px) * HP_PITCH + c4);
      const float4 v =
          *reinterpret_cast<const float4*>(hp + ((2 * py + 1) * PW + px) * HP_PITCH + c4);
      store4(out + ((size_t(b) * Ho + oy) * Wo + ox) * CH + c4,
             make_float4(fmaxf(u.x, v.x), fmaxf(u.y, v.y), fmaxf(u.z, v.z), fmaxf(u.w, v.w)));
    }
  }
}

template <int CIN, typename TOut, bool POOL>
cudaError_t launch(const void* x, const void* wa, const float* ba, const void* wb,
                   const float* bb, void* out, int B, int H, int W, cudaStream_t stream) {
  auto kernel = conv_pair_mma_kernel<CIN, TOut, POOL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(CIN));
  if (err != cudaSuccess) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NTHREADS, smem_bytes(CIN), stream>>>(
      x, wa, ba, static_cast<const __nv_bfloat16*>(wb), bb, static_cast<TOut*>(out), H, W);
  return cudaGetLastError();
}

template <int CIN, bool POOL>
cudaError_t dispatch(const void* x, const void* wa, const float* ba, const void* wb,
                     const float* bb, void* out, int B, int H, int W, int out_f32,
                     cudaStream_t s) {
  return out_f32 ? launch<CIN, float, POOL>(x, wa, ba, wb, bb, out, B, H, W, s)
                 : launch<CIN, __nv_bfloat16, POOL>(x, wa, ba, wb, bb, out, B, H, W, s);
}

template <bool POOL>
int run(const void* x, const void* wa, const float* ba, const void* wb, const float* bb,
        void* out, int B, int cin, int H, int W, int out_f32, void* stream) {
  // The 16-byte copies and loads: both weights, the output and (CIN = 64)
  // the input; CIN = 1 reads its f32 image 4 bytes at a time.
  const uintptr_t any = reinterpret_cast<uintptr_t>(wa) | reinterpret_cast<uintptr_t>(wb) |
                        reinterpret_cast<uintptr_t>(out) |
                        (cin == 64 ? reinterpret_cast<uintptr_t>(x) : 0);
  if (any % 16 != 0) return int(cudaErrorMisalignedAddress);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return int(cin == 1 ? dispatch<1, POOL>(x, wa, ba, wb, bb, out, B, H, W, out_f32, s)
                      : dispatch<64, POOL>(x, wa, ba, wb, bb, out, B, H, W, out_f32, s));
}

}  // namespace

// x: CIN = 1 -> f32 (B, H, W); CIN = 64 -> bf16 (B, H, W, 64).
// wa: CIN = 1 -> f32 (64, 9); CIN = 64 -> bf16 (9, 64, 64) [tap][co][ci].
// wb: bf16 (9, 64, 64) [tap][co][ci]. ba, bb: f32 (64,).
// out: (B, H/2, W/2, 64), f32 if out_f32 else bf16; H and W even.
// wa, wb, out and (CIN = 64) x must be 16-byte aligned
// (cudaErrorMisalignedAddress).
SSL_EXPORT int ssl_conv_pair_pool(const void* x, const void* wa, const float* ba,
                                  const void* wb, const float* bb, void* out, int B,
                                  int cin, int H, int W, int out_f32, void* stream) {
  if ((cin != 1 && cin != 64) || H % 2 != 0 || W % 2 != 0 || B < 1)
    return int(cudaErrorInvalidValue);
  return run<true>(x, wa, ba, wb, bb, out, B, cin, H, W, out_f32, stream);
}

// The same operands, no pool: out is (B, H, W, 64); H and W >= 1.
SSL_EXPORT int ssl_conv_pair(const void* x, const void* wa, const float* ba, const void* wb,
                             const float* bb, void* out, int B, int cin, int H, int W,
                             int out_f32, void* stream) {
  if ((cin != 1 && cin != 64) || H < 1 || W < 1 || B < 1) return int(cudaErrorInvalidValue);
  return run<false>(x, wa, ba, wb, bb, out, B, cin, H, W, out_f32, stream);
}
