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
//   (a) proj_kernel: x @ W + bias per 32-row tile of the flattened (B*K, 256)
//       input, one grid column per 256-wide output group (q, k, v for the
//       self block with the rotary epilogue on q and k; qk, v for the cross
//       block), written head-major as (group, B, 4, K, 64);
//   (b) ssl_attn::launch (attention.cuh): online-softmax attention over key
//       tiles; the cross block reads keys, values and the key mask of the
//       partner row b ^ 1; the context is written as (B, K, 256);
//   (c) tail_kernel per 32-row tile: ctx @ Wout + bout, cat[x, msg] @ W0 + b0
//       into a (32, 512) f32 tile in shared memory, LayerNorm, GELU, @ W3 +
//       b3, residual. msg and h never reach device memory.
// Any K >= 1: tiles run over the flattened rows and mask the ragged edge.
//
// What the TPU kernel keeps out of device memory and this one does not, at
// the main path's (4, 600, 256) bf16: q, k, v written and read once
// (2 * 3 * 1.23 MB self, 2 * 2 * 1.23 MB cross) and the context
// (2 * 1.23 MB): 9.8 MB / 7.4 MB per block call on top of the 2.5 MB of x
// in and out, ~3 us at the HBM rate; they stay in the 50 MB L2 between the
// launches. The block's weights (1.3 MB in bf16) are re-read from L2 by
// every row tile rather than staged whole.
//
// Bound on the H100: operations. One block at (4, 600, 256) is 4.6 GFLOP
// (3.1 in the linears, 1.5 in attention) against ~4 MB of inputs, outputs
// and weights: ~4.7 us at the bf16 tensor-core rate, ~1.2 us at the HBM
// rate. What the design does about it: in bf16 every linear runs on the
// tensor cores (WMMA m16n16k16, f32 accumulators; each of the 16 warps owns
// a column strip of the output and both 16-row tiles, reads its B fragments
// straight from L2 and the A fragments from the shared row tile); in f32
// the same tiles run as FMA loops (the f32 path exists to hold the kernel
// to its plain version at 1e-3, not for speed). Attention runs on the
// tensor cores too (attention.cuh).
#include <math.h>
#include <mma.h>

#include "attention.cuh"
#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int DIM = 256, HEADS = 4, HD = 64, FF = 512;
constexpr int BM = 32;  // rows of the flattened (B*K, 256) input per block
constexpr int NT = 512, NWARPS = NT / 32;
constexpr int PAD = 8;  // keeps shared rows 16-byte aligned and off one bank
constexpr int LD_PROJ = DIM + PAD, LD_TAIL = FF + PAD;

// C_s[BM x N] = A_s[BM x kdim] @ W[kdim x N]. A_s in shared memory (row
// stride lda), W row-major in device memory (row stride ldw), C_s f32 in
// shared memory. The caller synchronises the block before and after.
template <int N>
__device__ __forceinline__ void block_gemm(const __nv_bfloat16* A_s, int lda, int kdim,
                                           const __nv_bfloat16* __restrict__ W, int ldw,
                                           float* C_s, int ldc) {
  constexpr int CT = N / NWARPS / 16;  // 16-column tiles per warp
  const int c0 = (threadIdx.x / 32) * (N / NWARPS);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BM / 16][CT];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
#pragma unroll 4
  for (int k = 0; k < kdim; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[BM / 16];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) wmma::load_matrix_sync(a[i], A_s + i * 16 * lda + k, lda);
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(b, W + size_t(k) * ldw + c0 + j * 16, ldw);
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j)
      wmma::store_matrix_sync(C_s + i * 16 * ldc + c0 + j * 16, acc[i][j], ldc,
                              wmma::mem_row_major);
}

// The f32 form: thread t < N owns column t and all BM rows.
template <int N>
__device__ __forceinline__ void block_gemm(const float* A_s, int lda, int kdim,
                                           const float* __restrict__ W, int ldw,
                                           float* C_s, int ldc) {
  static_assert(N <= NT, "one column a thread");
  const int col = threadIdx.x;
  if (col >= N) return;
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.0f;
  for (int k = 0; k < kdim; k += 4) {
    float w[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) w[kk] = W[size_t(k + kk) * ldw + col];
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A_s + r * lda + k);
      acc[r] = fmaf(a.x, w[0], acc[r]);
      acc[r] = fmaf(a.y, w[1], acc[r]);
      acc[r] = fmaf(a.z, w[2], acc[r]);
      acc[r] = fmaf(a.w, w[3], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) C_s[r * ldc + col] = acc[r];
}

// Rows m0 .. m0+BM of a (M, 256) matrix into dst (row stride ld), 16 bytes
// a thread; rows past M are zero.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* __restrict__ src, int m0,
                                          int M) {
  constexpr int VPR = DIM * sizeof(T) / 16;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < BM * VPR; i += NT) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) val = reinterpret_cast<const uint4*>(src + size_t(m0 + r) * DIM)[c];
    reinterpret_cast<uint4*>(dst + r * ld)[c] = val;
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Stage (a). grid (ceil(M / BM), groups); W (256, groups*256) with bias
// (groups*256,) f32; cos, sin (M, 32) f32 (the frequency of rotary pair i of
// every head); out (groups, B, 4, K, 64). Groups below n_rot get the rotary
// epilogue: (t0, t1) -> (t0 cos - t1 sin, t1 cos + t0 sin) per pair, in f32.
template <typename T>
__global__ void __launch_bounds__(NT)
    proj_kernel(const T* __restrict__ x, const T* __restrict__ W,
                const float* __restrict__ bias, const float* __restrict__ cosv,
                const float* __restrict__ sinv, T* __restrict__ out, int M, int K,
                int groups, int n_rot) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* A_s = reinterpret_cast<T*>(smem);
  float* C_s = reinterpret_cast<float*>(smem + BM * LD_PROJ * sizeof(T));
  const int m0 = blockIdx.x * BM, g = blockIdx.y;

  load_rows(A_s, LD_PROJ, x, m0, M);
  __syncthreads();
  block_gemm<DIM>(A_s, LD_PROJ, DIM, W + g * DIM, groups * DIM, C_s, LD_PROJ);
  __syncthreads();

  const float* bg = bias + g * DIM;
  T* og = out + size_t(g) * M * DIM;
  for (int i = threadIdx.x; i < BM * (DIM / 2); i += NT) {
    const int r = i / (DIM / 2), c = 2 * (i % (DIM / 2));
    const int m = m0 + r;
    if (m >= M) continue;
    float t0 = C_s[r * LD_PROJ + c] + bg[c];
    float t1 = C_s[r * LD_PROJ + c + 1] + bg[c + 1];
    const int h = c / HD, d = c % HD;
    if (g < n_rot) {
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

// Stage (c). grid ceil(M / BM); ctx, x, out (M, 256); Wout (256, 256), W0
// (512, 512) over cat[x, msg], W3 (512, 256), all row-major (in, out);
// biases, LayerNorm gain g and offset be in f32.
template <typename T>
__global__ void __launch_bounds__(NT)
    tail_kernel(const T* __restrict__ ctx, const T* __restrict__ x,
                const T* __restrict__ Wout, const float* __restrict__ bout,
                const T* __restrict__ W0, const float* __restrict__ b0,
                const float* __restrict__ g, const float* __restrict__ be,
                const T* __restrict__ W3, const float* __restrict__ b3, T* __restrict__ out,
                int M) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* A_s = reinterpret_cast<T*>(smem);  // (BM, 512): ctx, then [x | msg], then gelu(h)
  float* C_s = reinterpret_cast<float*>(smem + BM * LD_TAIL * sizeof(T));
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;

  load_rows(A_s, LD_TAIL, ctx, m0, M);
  __syncthreads();
  block_gemm<DIM>(A_s, LD_TAIL, DIM, Wout, DIM, C_s, LD_TAIL);
  __syncthreads();

  for (int i = tid; i < BM * DIM; i += NT) {
    const int r = i / DIM, c = i % DIM;
    A_s[r * LD_TAIL + DIM + c] = ssl_from_float<T>(C_s[r * LD_TAIL + c] + bout[c]);
  }
  load_rows(A_s, LD_TAIL, x, m0, M);
  __syncthreads();
  block_gemm<FF>(A_s, LD_TAIL, FF, W0, FF, C_s, LD_TAIL);
  __syncthreads();

  // LayerNorm (biased variance, eps 1e-5) + erf GELU, one warp per row.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BM; r += NWARPS) {
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
      const float ge = 0.5f * hn * (1.0f + erff(hn * 0.70710678118654752f));
      A_s[r * LD_TAIL + c] = ssl_from_float<T>(ge);
    }
  }
  __syncthreads();
  block_gemm<DIM>(A_s, LD_TAIL, FF, W3, DIM, C_s, LD_TAIL);
  __syncthreads();

  for (int i = tid; i < BM * DIM; i += NT) {
    const int r = i / DIM, c = i % DIM;
    const int m = m0 + r;
    if (m >= M) continue;
    const float y = C_s[r * LD_TAIL + c] + b3[c];
    out[size_t(m) * DIM + c] = ssl_from_float<T>(ssl_to_float(x[size_t(m) * DIM + c]) + y);
  }
}

struct BlockArgs {
  const void *x, *wproj, *wout, *w0, *w3;
  const float *cosv, *sinv, *bproj, *bout, *b0, *g, *be, *b3;
  const uint8_t* mask;
  void *proj, *ctx, *out;
  int B, K, cross;
};

template <typename T>
cudaError_t run_block(const BlockArgs& a, cudaStream_t stream) {
  const int M = a.B * a.K;
  const int groups = a.cross ? 2 : 3;
  const size_t proj_smem = BM * LD_PROJ * (sizeof(T) + sizeof(float));
  const size_t tail_smem = BM * LD_TAIL * (sizeof(T) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      proj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(proj_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(tail_smem));
  if (err != cudaSuccess) return err;

  const int tiles = (M + BM - 1) / BM;
  T* proj = reinterpret_cast<T*>(a.proj);
  proj_kernel<T><<<dim3(tiles, groups), NT, proj_smem, stream>>>(
      reinterpret_cast<const T*>(a.x), reinterpret_cast<const T*>(a.wproj), a.bproj,
      a.cosv, a.sinv, proj, M, a.K, groups, a.cross ? 0 : 2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // Self: q, k, v are groups 0, 1, 2. Cross: group 0 is both q and k (of the
  // partner row), group 1 is v.
  const T* q = proj;
  const T* k = a.cross ? proj : proj + size_t(M) * DIM;
  const T* v = proj + size_t(a.cross ? 1 : 2) * M * DIM;
  err = ssl_attn::launch<T>(q, k, v, a.mask, a.ctx, nullptr, a.B, HEADS, a.K, a.cross, 1, stream);
  if (err != cudaSuccess) return err;

  tail_kernel<T><<<tiles, NT, tail_smem, stream>>>(
      reinterpret_cast<const T*>(a.ctx), reinterpret_cast<const T*>(a.x),
      reinterpret_cast<const T*>(a.wout), a.bout, reinterpret_cast<const T*>(a.w0), a.b0,
      a.g, a.be, reinterpret_cast<const T*>(a.w3), a.b3, reinterpret_cast<T*>(a.out), M);
  return cudaGetLastError();
}

int run(const BlockArgs& a, int is_bf16, void* stream) {
  if (a.B < 1 || a.K < 1 || (a.cross && a.B % 2)) return int(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return int(is_bf16 ? run_block<__nv_bfloat16>(a, s) : run_block<float>(a, s));
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
