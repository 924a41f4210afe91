// fused_self_block / fused_cross_block: one whole LightGlue transformer
// block per call (projections, rotary, 4-head masked attention, message
// projection, FFN with LayerNorm + GELU, residual).
//
// Replaces superslam_tpu/ops/pallas/lightglue_layer.py::fused_self_block
// (_self_kernel) and ::fused_cross_block (_cross_kernel). Same rounding
// points as those kernel bodies: every product accumulates in f32; the
// biases, the rotary encoding, the softmax, LayerNorm and GELU are f32; q,
// k, v, the attention probabilities, the context, the message and the
// GELU output are rounded to x's type before the product that consumes
// them; the residual adds f32(x). GELU uses erff (the TPU kernel's erf
// polynomial differs from it by < 1.5e-7).
//
// The TPU kernel runs one program per sequence with the whole (K, 768) qkv
// and a (K, K) logits tile per head in fast memory. Here a block has 227 KB
// of shared memory and there are 132 SMs to fill, and attention needs every
// row's k and v before any row's context, so one block call is three
// launches on the caller's stream:
//   (a) the projection per BM-row tile of the flattened (B*K, 256) input,
//       one grid column per 256-wide output group (q, k, v for the self
//       block with the rotary epilogue on q and k; qk, v for the cross
//       block), written head-major as (group, B, 4, K, 64);
//   (b) ssl_attn::launch (attention.cuh): online-softmax attention over key
//       tiles; the cross block reads keys, values and the key mask of the
//       partner row b ^ 1; the context is written as (B, K, 256);
//   (c) the tail per BM-row tile: ctx @ Wout + bout, cat[x, msg] @ W0 + b0,
//       LayerNorm, GELU, @ W3 + b3, residual. msg and h never reach device
//       memory.
// Any K >= 1: tiles run over the flattened rows and mask the ragged edge.
//
// What the TPU kernel keeps out of device memory and this one does not, at
// the main path's (4, 600, 256) bf16: q, k, v written and read once
// (2 * 3 * 1.23 MB self, 2 * 2 * 1.23 MB cross) and the context
// (2 * 1.23 MB): 9.8 MB / 7.4 MB per block call on top of the 2.5 MB of x
// in and out, ~3 us at the HBM rate; they stay in the 50 MB L2 between the
// launches. The block's weights (1.3 MB in bf16) are streamed from L2 by
// every row tile rather than staged whole.
//
// Bound on the H100: operations. One block at (4, 600, 256) is 4.6 GFLOP
// (3.1 in the linears, 1.5 in attention) against ~4 MB of inputs, outputs
// and weights: ~4.7 us at the bf16 tensor-core rate, ~1.2 us at the HBM
// rate. What the design does about it, in bf16 (proj_mma_kernel,
// tail_mma_kernel):
//   * Every linear runs on mma.sync m16n8k16 (bf16, f32 accumulators). The
//     block's row tile sits in shared memory, chunk c of row r at chunk
//     (c & ~7) | ((c ^ r) & 7) (sw), and A fragments come by ldmatrix.
//   * W, row-major (in, out), streams through a RING-slot cp.async ring of
//     SLOT-byte k-slices (64 rows of a 256-wide matrix or 32 of a 512-wide
//     one), swizzled the same way; B fragments come by ldmatrix.trans. The
//     tail's three matrices are one stream of 28 slices, so the next
//     matrix's first slices load under the last one's products and the
//     epilogues between them.
//   * Each of the NWARPS warps owns N / NWARPS columns of a product and all
//     BM rows; the accumulators stay in registers and every epilogue reads
//     them: the bias; the rotary pair (2i, 2i + 1), which is a lane's
//     (c0, c1) of one n-tile, so the rotation is a register operation; the
//     head-major bf16x2 stores of q, k, v; msg rounded into the A tile's
//     second half; LayerNorm over the 512-wide hidden row (a lane's partial
//     sums meet over the four lanes of a row by __shfl_xor and over the
//     warps in a small shared array); erf GELU rounded into the A tile; the
//     residual store. No f32 staging tile.
//   * The address model is lightglue_layer.py::gemm_layout;
//     tests/test_torch_block_gemm_layout.py proves every ldmatrix and
//     cp.async phase conflict-free and in bounds against the constants
//     below.
// Attention runs on mma.sync too (attention.cuh). The f32 route
// (proj_f32_kernel, tail_f32_kernel) keeps FMA loops through an f32
// staging tile: it is a correctness path that holds the kernels to their
// plain version at 1e-3, and no timed route runs it.
#include <math.h>

#include "attention.cuh"
#include "common.cuh"
#include "conv_mma.cuh"

namespace {

using conv_mma::cp_async16;
using conv_mma::ldsm_x4;
using conv_mma::ldsm_x4_trans;
using conv_mma::mma_bf16;
using conv_mma::smem_u32;
using ssl_attn::pack_bf16;
using ssl_attn::store2;
using bf16 = __nv_bfloat16;

constexpr int DIM = 256, HEADS = 4, HD = 64, FF = 512;

// -- bf16 on mma.sync ---------------------------------------------------------

constexpr int BM = 32;                   // rows of the flattened (B*K, 256) input a block
constexpr int NWARPS = 8;                // each owns N / NWARPS columns, all BM rows
constexpr int NTHREADS = 32 * NWARPS;
constexpr int MT = BM / 16;              // m16 row tiles
constexpr int SLOT = 32768;              // bytes of one weight ring slot
constexpr int RING = 3;                  // slots
constexpr int X_BYTES = BM * DIM * 2;    // a (BM, 256) bf16 tile
constexpr int H_BYTES = BM * FF * 2;     // a (BM, 512) bf16 tile
constexpr int RED_BYTES = 2 * NWARPS * BM * 4;                     // LayerNorm's partial sums
constexpr int PROJ_SMEM = X_BYTES + RING * SLOT;                   // x, ring
constexpr int TAIL_SMEM = X_BYTES + H_BYTES + RING * SLOT + RED_BYTES;  // ctx, [x|msg], ring, red
constexpr int PROJ_SLICES = DIM * DIM * 2 / SLOT;   // one 256-wide group of Wqkv
constexpr int OUT_SLICES = DIM * DIM * 2 / SLOT;    // Wout
constexpr int W0_SLICES = FF * FF * 2 / SLOT;       // W0
constexpr int W3_SLICES = FF * DIM * 2 / SLOT;      // W3

static_assert(BM % 16 == 0 && DIM % (16 * NWARPS) == 0, "tiles: an even number of n-tiles a warp");
static_assert(SLOT % (2 * FF * 16) == 0 && RING >= 2, "slices: whole k-steps of both widths");
static_assert(PROJ_SMEM <= 232448 && TAIL_SMEM <= 232448, "shared memory");

// Byte offset of 16-byte chunk c of row r in a tile of cpr chunks a row
// (a multiple of 8): stored at chunk (c & ~7) | ((c ^ r) & 7).
__device__ __forceinline__ uint32_t sw(int r, int c, int cpr) {
  return uint32_t(r * cpr + ((c & ~7) | ((c ^ r) & 7))) << 4;
}

// Rows m0 .. m0 + BM of a (M, 256) bf16 matrix into chunks 0..31 of a
// swizzled tile of cpr chunks a row, by cp.async, zero-filled past M.
__device__ __forceinline__ void load_rows(uint32_t tile, int cpr, const bf16* src, int m0, int M,
                                          int tid) {
  for (int i = tid; i < BM * (DIM / 8); i += NTHREADS) {
    const int r = i >> 5, c = i & 31;
    const bool in = m0 + r < M;
    cp_async16(tile + sw(r, c, cpr), in ? src + size_t(m0 + r) * DIM + 8 * c : src, in);
  }
}

// A (k, n) weight matrix streamed by slices: rows k of width n (256 or
// 512) from w, ld elements apart, SLOT / (2 n) rows a slice.
struct WMat {
  const bf16* w;
  int ld, n, slices;
};

// Slice s of the stream mats[0], mats[1], ... into ring slot s % RING by
// cp.async (nothing past the stream's end); one commit group a call. Copy i
// is chunk i % (n / 8) of slice row i / (n / 8).
template <int NM>
__device__ __forceinline__ void issue(uint32_t ring, int s, const WMat (&mats)[NM], int tid) {
  const uint32_t slot = ring + uint32_t(s % RING) * SLOT;
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    if (s >= 0 && s < mats[j].slices) {
      const int lg = mats[j].n == FF ? 6 : 5, cpr = mats[j].n / 8;
      const int rows = SLOT / (2 * mats[j].n);
      const bf16* w = mats[j].w + size_t(s) * rows * mats[j].ld;
      for (int i = tid; i < SLOT / 16; i += NTHREADS) {
        const int r = i >> lg, c = i & (cpr - 1);
        cp_async16(slot + sw(r, c, cpr), w + size_t(r) * mats[j].ld + 8 * c, true);
      }
    }
    s -= mats[j].slices;
  }
  conv_mma::cp_async_commit();
}

// acc[mt][nt] = A[16 mt + (0..15), k] . W[k, c0 + 8 nt + (0..7)] over the
// stream's slices s0 .. s0 + nslices (one matrix of width N), with c0 =
// warp * N / NWARPS; A is a swizzled tile of acpr chunks a row. Slice s is
// waited for, then slice s + RING - 1 issued into the slot of s - 1 (every
// warp has left it: the barrier), then s's k-steps run: lane l points
// ldmatrix at A row 16 mt + (l & 15), chunk 2 ks + (l >> 4) (a0..a3) and
// ldmatrix.trans at slice row 16 ks + (l & 15), chunk c0 / 8 + 2 h + (l >>
// 4) (b0, b1 of n-tile 2 h, then of 2 h + 1).
template <int N, typename Issue>
__device__ __forceinline__ void gemm(float (&acc)[MT][N / NWARPS / 8][4], uint32_t a, int acpr,
                                     uint32_t ring, int s0, int nslices, Issue&& issue_next,
                                     int warp, int lane) {
  constexpr int NTW = N / NWARPS / 8, KSR = SLOT / (2 * N), CPR = N / 8;
  const int wc = warp * (N / NWARPS) / 8;  // the warp's first chunk of a slice row
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
  for (int s = s0; s < s0 + nslices; ++s) {
    conv_mma::cp_async_wait<RING - 2>();
    __syncthreads();  // slice s landed for everyone; the slot of s - 1 is free
    issue_next(s + RING - 1);
    const uint32_t slot = ring + uint32_t(s % RING) * SLOT;
    const int kc = (s - s0) * (KSR / 8);  // A chunk of the slice's first row
#pragma unroll
    for (int ks = 0; ks < KSR / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a + sw(16 * mt + (lane & 15), kc + 2 * ks + (lane >> 4), acpr), af[mt]);
#pragma unroll
      for (int h = 0; h < NTW / 2; ++h) {
        uint32_t b[4];
        ldsm_x4_trans(slot + sw(16 * ks + (lane & 15), wc + 2 * h + (lane >> 4), CPR), b);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * h], af[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * h + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void st_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// Stage (a). grid (ceil(M / BM), groups); W (256, groups*256) with bias
// (groups*256,) f32; cos, sin (M, 32) f32 (the frequency of rotary pair i of
// every head); out (groups, B, 4, K, 64). Groups below n_rot get the rotary
// epilogue: (t0, t1) -> (t0 cos - t1 sin, t1 cos + t0 sin) per pair, in f32.
__global__ void __launch_bounds__(NTHREADS)
    proj_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W,
                    const float* __restrict__ bias, const float* __restrict__ cosv,
                    const float* __restrict__ sinv, bf16* __restrict__ out, int M, int K,
                    int groups, int n_rot) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t xs = smem_u32(smem), ring = xs + X_BYTES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, grp = blockIdx.y;
  const WMat mats[1] = {{W + grp * DIM, groups * DIM, DIM, PROJ_SLICES}};
  auto issue_next = [&](int s) { issue(ring, s, mats, tid); };

  load_rows(xs, DIM / 8, x, m0, M, tid);  // in the first slice's group
  for (int s = 0; s < RING - 1; ++s) issue_next(s);
  float acc[MT][DIM / NWARPS / 8][4];
  gemm<DIM>(acc, xs, DIM / 8, ring, 0, PROJ_SLICES, issue_next, warp, lane);

  const float* bg = bias + grp * DIM;
  bf16* og = out + size_t(grp) * M * DIM;
#pragma unroll
  for (int nt = 0; nt < DIM / NWARPS / 8; ++nt) {
    const int c = warp * (DIM / NWARPS) + 8 * nt + 2 * t;  // even: rotary pair c / 2 of its head
    const int hh = c / HD, d = c % HD;
    const float2 bb = *reinterpret_cast<const float2*>(bg + c);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + 16 * mt + g + 8 * hr;
        if (m >= M) continue;
        float t0 = acc[mt][nt][2 * hr] + bb.x, t1 = acc[mt][nt][2 * hr + 1] + bb.y;
        if (grp < n_rot) {
          const float cs = cosv[size_t(m) * (HD / 2) + d / 2];
          const float sn = sinv[size_t(m) * (HD / 2) + d / 2];
          const float r0 = t0 * cs - t1 * sn, r1 = t1 * cs + t0 * sn;
          t0 = r0;
          t1 = r1;
        }
        const int b = m / K, kk = m % K;
        store2(og + ((size_t(b) * HEADS + hh) * K + kk) * HD + d, t0, t1);
      }
  }
}

// Stage (c). grid ceil(M / BM); ctx, x, out (M, 256); Wout (256, 256), W0
// (512, 512) over cat[x, msg], W3 (512, 256), all row-major (in, out);
// biases, LayerNorm gain gn and offset be in f32.
__global__ void __launch_bounds__(NTHREADS)
    tail_mma_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ x,
                    const bf16* __restrict__ Wout, const float* __restrict__ bout,
                    const bf16* __restrict__ W0, const float* __restrict__ b0,
                    const float* __restrict__ gn, const float* __restrict__ be,
                    const bf16* __restrict__ W3, const float* __restrict__ b3,
                    bf16* __restrict__ out, int M) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t cs = smem_u32(smem);     // (BM, 256): ctx
  const uint32_t hs = cs + X_BYTES;       // (BM, 512): [x | msg], then gelu(h)
  const uint32_t ring = hs + H_BYTES;
  // LayerNorm's partial sums: 2 x (NWARPS, BM) floats.
  float* red = reinterpret_cast<float*>(smem + X_BYTES + H_BYTES + RING * SLOT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const WMat mats[3] = {{Wout, DIM, DIM, OUT_SLICES}, {W0, FF, FF, W0_SLICES},
                        {W3, DIM, DIM, W3_SLICES}};
  auto issue_next = [&](int s) { issue(ring, s, mats, tid); };

  load_rows(cs, DIM / 8, ctx, m0, M, tid);  // in the first slice's group
  load_rows(hs, FF / 8, x, m0, M, tid);
  for (int s = 0; s < RING - 1; ++s) issue_next(s);

  // msg = ctx Wout + bout, rounded into columns 256..511 of h's tile.
  {
    constexpr int NTW = DIM / NWARPS / 8;
    float acc[MT][NTW][4];
    gemm<DIM>(acc, cs, DIM / 8, ring, 0, OUT_SLICES, issue_next, warp, lane);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int c = warp * (DIM / NWARPS) + 8 * nt + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(bout + c);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * mt + g + 8 * hr;
          st_u32(hs + sw(r, (DIM + c) / 8, FF / 8) + (c & 7) * 2,
                 pack_bf16(acc[mt][nt][2 * hr] + bb.x, acc[mt][nt][2 * hr + 1] + bb.y));
        }
    }
  }

  // h = [x | msg] W0 + b0 (f32), LayerNorm (biased variance, eps 1e-5),
  // erf GELU, rounded into columns 0..511 of h's tile.
  {
    constexpr int NTW = FF / NWARPS / 8;
    float acc[MT][NTW][4];
    gemm<FF>(acc, hs, FF / 8, ring, OUT_SLICES, W0_SLICES, issue_next, warp, lane);
    float part[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) part[mt][0] = part[mt][1] = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int c = warp * (FF / NWARPS) + 8 * nt + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(b0 + c);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mt][nt][e] += (e & 1) ? bb.y : bb.x;
          part[mt][e >> 1] += acc[mt][nt][e];
        }
    }
    // Row sums: over the four lanes of a row, then over the warps.
    auto row_sums = [&](float (&p)[MT][2], float* dst, float (&sum)[MT][2]) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float v = p[mt][hr];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0) dst[warp * BM + 16 * mt + g + 8 * hr] = v;
        }
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float v = 0.0f;
#pragma unroll
          for (int w = 0; w < NWARPS; ++w) v += dst[w * BM + 16 * mt + g + 8 * hr];
          sum[mt][hr] = v;
        }
    };
    float mu[MT][2], var[MT][2];
    row_sums(part, red, mu);  // its barrier also ends every warp's reads of h's tile
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mu[mt][hr] *= 1.0f / FF;
        part[mt][hr] = 0.0f;
      }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dv = acc[mt][nt][e] - mu[mt][e >> 1];
          part[mt][e >> 1] += dv * dv;
        }
    row_sums(part, red + NWARPS * BM, var);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int c = warp * (FF / NWARPS) + 8 * nt + 2 * t;
      const float2 gg = *reinterpret_cast<const float2*>(gn + c);
      const float2 bb = *reinterpret_cast<const float2*>(be + c);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float inv = rsqrtf(var[mt][hr] * (1.0f / FF) + 1e-5f);
          float ge[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float hn = (acc[mt][nt][2 * hr + e] - mu[mt][hr]) * inv * (e ? gg.y : gg.x) +
                             (e ? bb.y : bb.x);
            ge[e] = 0.5f * hn * (1.0f + erff(hn * 0.70710678118654752f));
          }
          st_u32(hs + sw(16 * mt + g + 8 * hr, c / 8, FF / 8) + (c & 7) * 2,
                 pack_bf16(ge[0], ge[1]));
        }
    }
  }

  // y = gelu(h) W3 + b3; out = x + y.
  {
    constexpr int NTW = DIM / NWARPS / 8;
    float acc[MT][NTW][4];
    gemm<DIM>(acc, hs, FF / 8, ring, OUT_SLICES + W0_SLICES, W3_SLICES, issue_next, warp, lane);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int c = warp * (DIM / NWARPS) + 8 * nt + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(b3 + c);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int m = m0 + 16 * mt + g + 8 * hr;
          if (m >= M) continue;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + size_t(m) * DIM + c));
          store2(out + size_t(m) * DIM + c, xv.x + (acc[mt][nt][2 * hr] + bb.x),
                 xv.y + (acc[mt][nt][2 * hr + 1] + bb.y));
        }
    }
  }
}

// -- f32: FMA loops (a correctness path, not timed) ---------------------------

constexpr int FBM = 32;   // rows a block
constexpr int FNT = 512;  // threads: one output column each
constexpr int PAD = 8;    // keeps shared rows 16-byte aligned
constexpr int LD_PROJ = DIM + PAD, LD_TAIL = FF + PAD;

// C_s[FBM x N] = A_s[FBM x kdim] @ W[kdim x N]: thread t < N owns column t
// and all FBM rows. A_s in shared memory (row stride lda), W row-major in
// device memory (row stride ldw), C_s in shared memory. The caller
// synchronises the block before and after.
template <int N>
__device__ __forceinline__ void block_gemm_f32(const float* A_s, int lda, int kdim,
                                               const float* __restrict__ W, int ldw, float* C_s,
                                               int ldc) {
  static_assert(N <= FNT, "one column a thread");
  const int col = threadIdx.x;
  if (col >= N) return;
  float acc[FBM];
#pragma unroll
  for (int r = 0; r < FBM; ++r) acc[r] = 0.0f;
  for (int k = 0; k < kdim; k += 4) {
    float w[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) w[kk] = W[size_t(k + kk) * ldw + col];
#pragma unroll
    for (int r = 0; r < FBM; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A_s + r * lda + k);
      acc[r] = fmaf(a.x, w[0], acc[r]);
      acc[r] = fmaf(a.y, w[1], acc[r]);
      acc[r] = fmaf(a.z, w[2], acc[r]);
      acc[r] = fmaf(a.w, w[3], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < FBM; ++r) C_s[r * ldc + col] = acc[r];
}

// Rows m0 .. m0+FBM of a (M, 256) f32 matrix into dst (row stride ld);
// rows past M are zero.
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* __restrict__ src,
                                              int m0, int M) {
  for (int i = threadIdx.x; i < FBM * DIM / 4; i += FNT) {
    const int r = i / (DIM / 4), c = i % (DIM / 4);
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (m0 + r < M) val = reinterpret_cast<const float4*>(src + size_t(m0 + r) * DIM)[c];
    reinterpret_cast<float4*>(dst + r * ld)[c] = val;
  }
}

// Stage (a) in f32, the arguments of proj_mma_kernel.
__global__ void __launch_bounds__(FNT)
    proj_f32_kernel(const float* __restrict__ x, const float* __restrict__ W,
                    const float* __restrict__ bias, const float* __restrict__ cosv,
                    const float* __restrict__ sinv, float* __restrict__ out, int M, int K,
                    int groups, int n_rot) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* A_s = reinterpret_cast<float*>(smem);
  float* C_s = A_s + FBM * LD_PROJ;
  const int m0 = blockIdx.x * FBM, grp = blockIdx.y;

  load_rows_f32(A_s, LD_PROJ, x, m0, M);
  __syncthreads();
  block_gemm_f32<DIM>(A_s, LD_PROJ, DIM, W + grp * DIM, groups * DIM, C_s, LD_PROJ);
  __syncthreads();

  const float* bg = bias + grp * DIM;
  float* og = out + size_t(grp) * M * DIM;
  for (int i = threadIdx.x; i < FBM * (DIM / 2); i += FNT) {
    const int r = i / (DIM / 2), c = 2 * (i % (DIM / 2));
    const int m = m0 + r;
    if (m >= M) continue;
    float t0 = C_s[r * LD_PROJ + c] + bg[c];
    float t1 = C_s[r * LD_PROJ + c + 1] + bg[c + 1];
    const int h = c / HD, d = c % HD;
    if (grp < n_rot) {
      const float cs = cosv[size_t(m) * (HD / 2) + d / 2];
      const float sn = sinv[size_t(m) * (HD / 2) + d / 2];
      const float r0 = t0 * cs - t1 * sn, r1 = t1 * cs + t0 * sn;
      t0 = r0;
      t1 = r1;
    }
    const int b = m / K, kk = m % K;
    store2(og + ((size_t(b) * HEADS + h) * K + kk) * HD + d, t0, t1);
  }
}

// Stage (c) in f32, the arguments of tail_mma_kernel.
__global__ void __launch_bounds__(FNT)
    tail_f32_kernel(const float* __restrict__ ctx, const float* __restrict__ x,
                    const float* __restrict__ Wout, const float* __restrict__ bout,
                    const float* __restrict__ W0, const float* __restrict__ b0,
                    const float* __restrict__ g, const float* __restrict__ be,
                    const float* __restrict__ W3, const float* __restrict__ b3,
                    float* __restrict__ out, int M) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* A_s = reinterpret_cast<float*>(smem);  // (FBM, 512): ctx, then [x | msg], then gelu(h)
  float* C_s = A_s + FBM * LD_TAIL;
  const int m0 = blockIdx.x * FBM;
  const int tid = threadIdx.x;

  load_rows_f32(A_s, LD_TAIL, ctx, m0, M);
  __syncthreads();
  block_gemm_f32<DIM>(A_s, LD_TAIL, DIM, Wout, DIM, C_s, LD_TAIL);
  __syncthreads();

  for (int i = tid; i < FBM * DIM; i += FNT) {
    const int r = i / DIM, c = i % DIM;
    A_s[r * LD_TAIL + DIM + c] = C_s[r * LD_TAIL + c] + bout[c];
  }
  load_rows_f32(A_s, LD_TAIL, x, m0, M);
  __syncthreads();
  block_gemm_f32<FF>(A_s, LD_TAIL, FF, W0, FF, C_s, LD_TAIL);
  __syncthreads();

  // LayerNorm (biased variance, eps 1e-5) + erf GELU, one warp per row.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < FBM; r += FNT / 32) {
    float hv[FF / 32];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < FF / 32; ++i) {
      const int c = lane + 32 * i;
      hv[i] = C_s[r * LD_TAIL + c] + b0[c];
      sum += hv[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum * (1.0f / FF);
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < FF / 32; ++i) sq += (hv[i] - mu) * (hv[i] - mu);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float inv = rsqrtf(sq * (1.0f / FF) + 1e-5f);
#pragma unroll
    for (int i = 0; i < FF / 32; ++i) {
      const int c = lane + 32 * i;
      const float hn = (hv[i] - mu) * inv * g[c] + be[c];
      A_s[r * LD_TAIL + c] = 0.5f * hn * (1.0f + erff(hn * 0.70710678118654752f));
    }
  }
  __syncthreads();
  block_gemm_f32<DIM>(A_s, LD_TAIL, FF, W3, DIM, C_s, LD_TAIL);
  __syncthreads();

  for (int i = tid; i < FBM * DIM; i += FNT) {
    const int r = i / DIM, c = i % DIM;
    const int m = m0 + r;
    if (m >= M) continue;
    const float y = C_s[r * LD_TAIL + c] + b3[c];
    out[size_t(m) * DIM + c] = x[size_t(m) * DIM + c] + y;
  }
}

// -- the three launches ---------------------------------------------------------

struct BlockArgs {
  const void *x, *wproj, *wout, *w0, *w3;
  const float *cosv, *sinv, *bproj, *bout, *b0, *g, *be, *b3;
  const uint8_t* mask;
  void *proj, *ctx, *out;
  int B, K, cross;
};

template <typename T>
cudaError_t run_block(const BlockArgs& a, cudaStream_t stream) {
  constexpr bool is_bf16 = std::is_same<T, bf16>::value;
  const int M = a.B * a.K;
  const int groups = a.cross ? 2 : 3;
  const int tiles = (M + (is_bf16 ? BM : FBM) - 1) / (is_bf16 ? BM : FBM);
  const T* x = reinterpret_cast<const T*>(a.x);
  T* proj = reinterpret_cast<T*>(a.proj);
  const int n_rot = a.cross ? 0 : 2;
  cudaError_t err;
  if constexpr (is_bf16) {
    err = cudaFuncSetAttribute(proj_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               PROJ_SMEM);
    if (err != cudaSuccess) return err;
    proj_mma_kernel<<<dim3(tiles, groups), NTHREADS, PROJ_SMEM, stream>>>(
        x, reinterpret_cast<const T*>(a.wproj), a.bproj, a.cosv, a.sinv, proj, M, a.K, groups,
        n_rot);
  } else {
    constexpr int smem = FBM * LD_PROJ * 8;
    err = cudaFuncSetAttribute(proj_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    proj_f32_kernel<<<dim3(tiles, groups), FNT, smem, stream>>>(
        x, reinterpret_cast<const T*>(a.wproj), a.bproj, a.cosv, a.sinv, proj, M, a.K, groups,
        n_rot);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // Self: q, k, v are groups 0, 1, 2. Cross: group 0 is both q and k (of the
  // partner row), group 1 is v.
  const T* q = proj;
  const T* k = a.cross ? proj : proj + size_t(M) * DIM;
  const T* v = proj + size_t(a.cross ? 1 : 2) * M * DIM;
  err = ssl_attn::launch<T>(q, k, v, a.mask, a.ctx, nullptr, a.B, HEADS, a.K, a.cross, 1, stream);
  if (err != cudaSuccess) return err;

  const T* ctx = reinterpret_cast<const T*>(a.ctx);
  const T* wout = reinterpret_cast<const T*>(a.wout);
  const T* w0 = reinterpret_cast<const T*>(a.w0);
  const T* w3 = reinterpret_cast<const T*>(a.w3);
  T* out = reinterpret_cast<T*>(a.out);
  if constexpr (is_bf16) {
    err = cudaFuncSetAttribute(tail_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TAIL_SMEM);
    if (err != cudaSuccess) return err;
    tail_mma_kernel<<<tiles, NTHREADS, TAIL_SMEM, stream>>>(ctx, x, wout, a.bout, w0, a.b0, a.g,
                                                            a.be, w3, a.b3, out, M);
  } else {
    constexpr int smem = FBM * LD_TAIL * 8;
    err = cudaFuncSetAttribute(tail_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    tail_f32_kernel<<<tiles, FNT, smem, stream>>>(ctx, x, wout, a.bout, w0, a.b0, a.g, a.be, w3,
                                                  a.b3, out, M);
  }
  return cudaGetLastError();
}

int run(const BlockArgs& a, int is_bf16, void* stream) {
  if (a.B < 1 || a.K < 1 || (a.cross && a.B % 2)) return int(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return int(is_bf16 ? run_block<bf16>(a, s) : run_block<float>(a, s));
}

}  // namespace

// x, out (B, K, 256) and the weights in bf16 if is_bf16 else f32; cos, sin
// (B, K, 32) f32; mask (B, K) bytes, nonzero = real key; wqkv (256, 768) with
// columns [q | k | v], each head-major with natural channel order; qkv
// scratch (3, B, 4, K, 64); ctx scratch (B, K, 256).
SSL_EXPORT int ssl_fused_self_block(
    const void* x, const float* cosv, const float* sinv, const uint8_t* mask,
    const void* wqkv, const float* bqkv, const void* wout, const float* bout,
    const void* w0, const float* b0, const float* g, const float* be, const void* w3,
    const float* b3, void* qkv, void* ctx, void* out, int B, int K, int is_bf16,
    void* stream) {
  BlockArgs a{x, wqkv, wout, w0, w3, cosv, sinv, bqkv, bout, b0, g, be, b3, mask,
              qkv, ctx, out, B, K, 0};
  return run(a, is_bf16, stream);
}

// As above without the rotary inputs; x rows (2p, 2p+1) attend each other;
// wqkv (256, 512) with columns [to_qk | to_v]; qkv scratch (2, B, 4, K, 64).
SSL_EXPORT int ssl_fused_cross_block(
    const void* x, const uint8_t* mask, const void* wqkv, const float* bqkv,
    const void* wout, const float* bout, const void* w0, const float* b0, const float* g,
    const float* be, const void* w3, const float* b3, void* qkv, void* ctx, void* out,
    int B, int K, int is_bf16, void* stream) {
  BlockArgs a{x, wqkv, wout, w0, w3, nullptr, nullptr, bqkv, bout, b0, g, be, b3, mask,
              qkv, ctx, out, B, K, 1};
  return run(a, is_bf16, stream);
}
