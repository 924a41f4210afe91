// The key-masked attention kernels shared by masked_attention.cu (its own
// entry point) and lightglue_layer.cu (stage b of the fused blocks).
//
// softmax(q k^T / 8 with masked keys REPLACED by -1e9) v over D = 64, f32
// softmax, probabilities rounded to T before the PV product, f32 sums.
// Flash-style: a block holds a tile of queries in shared memory and walks
// tiles of k and v through shared memory with an online softmax, so the
// N x N logits never reach device memory. masked_attention.cu's header says
// what bounds it on the H100. Two kernels:
// - bf16 (attention_wmma_kernel): both products on the tensor cores (WMMA
//   m16n16k16, f32 accumulators). A block is 4 warps x 16 query rows and
//   walks 64-key tiles. WMMA fragments have no documented element layout,
//   so each warp passes its 16 x 64 logits and its running 16 x 64 output
//   through its own shared-memory tiles: two lanes own a row there for the
//   mask, the running max and sum, the bf16 probabilities and the rescale
//   of the output by exp(m_old - m_new) before P V accumulates onto it.
// - f32 (attention_kernel): FMA loops, one block per 32-query tile over
//   32-key tiles, eight threads a row. It exists to hold the arithmetic to
//   the plain version at f32 tolerances, not for speed.
//
// Two switches serve the fused blocks:
// - kv_xor = 1 reads keys, values and the key mask of batch row b ^ 1, so
//   pair rows (2p, 2p+1) attend each other (the cross block);
// - merged = 1 writes the context as (B, N, heads*64) rows, the layout the
//   block's tail consumes, instead of (B, heads, N, 64).
// A non-null stats pointer (2, B, heads, N) f32 also receives each query
// row's softmax maximum m (of the scaled, replaced logits) and 1 / l, its
// sum's inverse: the residuals of the backward (attention_bwd.cu). The two
// are kept apart, not as a log-sum-exp: in a row whose keys are all masked
// m = -1e9 would swallow log N in f32. The fused blocks and calls without
// autograd pass null and compute exactly what they computed before.
#pragma once

#include <math.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace ssl_attn {

constexpr int D = 64;
constexpr int QT = 32, KT = 32;
constexpr int NTHREADS = 256;  // 8 threads per query row
constexpr float NEG = -1e9f;

template <typename T>
__device__ __forceinline__ float round_to(float p) {
  return ssl_to_float(ssl_from_float<T>(p));
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ stats, int heads, int N,
                     float scale, int kv_xor, int merged) {
  __shared__ float q_s[QT][D + 1];
  __shared__ float k_s[KT][D + 1];
  __shared__ float v_s[KT][D];
  __shared__ float p_s[QT][KT + 1];
  __shared__ float valid_s[KT];

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int bk = b ^ kv_xor;
  const int q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, row = tid / 8, sub = tid % 8;
  const size_t base = size_t(bh) * N * D;
  const size_t base_kv = (size_t(bk) * heads + h) * N * D;
  const uint8_t* m = mask + size_t(bk) * N;

  for (int i = tid; i < QT * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    q_s[r][d] = (q0 + r < N) ? ssl_to_float(q[base + size_t(q0 + r) * D + d]) : 0.0f;
  }

  float m_run = -INFINITY, l_run = 0.0f;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < N; k0 += KT) {
    __syncthreads();  // previous tile's k_s / v_s / p_s are consumed
    for (int i = tid; i < KT * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < N;
      k_s[r][d] = in ? ssl_to_float(k[base_kv + size_t(k0 + r) * D + d]) : 0.0f;
      v_s[r][d] = in ? ssl_to_float(v[base_kv + size_t(k0 + r) * D + d]) : 0.0f;
    }
    if (tid < KT) valid_s[tid] = (k0 + tid < N) ? (m[k0 + tid] ? 1.0f : 0.0f) : -1.0f;
    __syncthreads();

    float s[4];
    float tmax = -INFINITY;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = sub + 8 * t;
      float dot = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += q_s[row][d] * k_s[j][d];
      const float vj = valid_s[j];
      // Keys past N do not exist (-inf); masked keys are replaced by -1e9.
      s[t] = vj < 0.0f ? -INFINITY : (vj > 0.0f ? dot * scale : NEG);
      tmax = fmaxf(tmax, s[t]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m_run, tmax);  // finite: every tile has a real key
    const float alpha = expf(m_run - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float p = expf(s[t] - m_new);
      psum += p;
      p_s[row][sub + 8 * t] = round_to<T>(p);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();  // the row's 8 threads share a warp
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] *= alpha;
    for (int j = 0; j < KT; ++j) {
      const float p = p_s[row][j];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += p * v_s[j][sub + 8 * i];
    }
  }

  if (q0 + row < N) {
    const float inv = 1.0f / l_run;
    T* o = merged ? out + ((size_t(b) * N + q0 + row) * heads + h) * D
                  : out + base + size_t(q0 + row) * D;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[sub + 8 * i] = ssl_from_float<T>(acc[i] * inv);
    if (stats != nullptr && sub == 0) {
      const size_t at = size_t(bh) * N + q0 + row;
      stats[at] = m_run;
      stats[size_t(gridDim.y) * N + at] = inv;
    }
  }
}

// -- bf16 on the tensor cores -------------------------------------------------

constexpr int WQ = 64, WK = 64;      // queries per block (16 a warp), keys per tile
constexpr int WTHREADS = 128;        // 4 warps
constexpr int LDH = D + 8;           // bf16 tiles: 144-byte rows
constexpr int LDF = D + 4;           // f32 tiles: 272-byte rows
constexpr int W_TILE_BYTES = WQ * LDH * 2;                         // q_s, k_s, v_s
constexpr int W_WARP_BYTES = 2 * 16 * LDF * 4 + 16 * LDH * 2;      // s_s, o_s, p_s
constexpr int W_SMEM = 3 * W_TILE_BYTES + 4 * W_WARP_BYTES + WK * 4;

template <typename bf16>
__global__ void __launch_bounds__(WTHREADS)
    attention_wmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                          bf16* __restrict__ out, float* __restrict__ stats, int heads, int N,
                          float scale, int kv_xor, int merged) {
  static_assert(std::is_same<bf16, __nv_bfloat16>::value, "the WMMA kernel is bf16 only");
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = reinterpret_cast<bf16*>(smem + W_TILE_BYTES);
  bf16* v_s = reinterpret_cast<bf16*>(smem + 2 * W_TILE_BYTES);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  unsigned char* mine = smem + 3 * W_TILE_BYTES + warp * W_WARP_BYTES;
  float* s_s = reinterpret_cast<float*>(mine);                       // (16, 64) logits
  float* o_s = reinterpret_cast<float*>(mine + 16 * LDF * 4);        // (16, 64) running output
  bf16* p_s = reinterpret_cast<bf16*>(mine + 2 * 16 * LDF * 4);      // (16, 64) probabilities
  float* valid_s = reinterpret_cast<float*>(smem + 3 * W_TILE_BYTES + 4 * W_WARP_BYTES);

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int bk = b ^ kv_xor;
  const int q0 = blockIdx.x * WQ;
  const size_t base = size_t(bh) * N * D;
  const size_t base_kv = (size_t(bk) * heads + h) * N * D;
  const uint8_t* m = mask + size_t(bk) * N;

  // 64 rows x 128 bytes = 512 16-byte vectors a tile, 4 a thread.
  auto load_tile = [&](bf16* dst, const bf16* src, int r0) {
    for (int i = tid; i < WQ * 8; i += WTHREADS) {
      const int r = i / 8, c = i % 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < N) val = reinterpret_cast<const uint4*>(src + size_t(r0 + r) * D)[c];
      reinterpret_cast<uint4*>(dst + r * LDH)[c] = val;
    }
  };
  load_tile(q_s, q + base, q0);
  for (int i = lane; i < 16 * LDF; i += 32) o_s[i] = 0.0f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], q_s + warp * 16 * LDH + kk * 16, LDH);

  // Two lanes own a row of the warp's tiles: columns half, half + 2, ...
  const int row = lane / 2, half = lane % 2;
  float m_run = -INFINITY, l_run = 0.0f;

  for (int k0 = 0; k0 < N; k0 += WK) {
    __syncthreads();  // the previous tile's k_s / v_s are consumed
    load_tile(k_s, k + base_kv, k0);
    load_tile(v_s, v + base_kv, k0);
    if (tid < WK) valid_s[tid] = (k0 + tid < N) ? (m[k0 + tid] ? 1.0f : 0.0f) : -1.0f;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: K^T is k_s read column-major.
#pragma unroll
    for (int j = 0; j < WK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, k_s + j * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(s_s + j * 16, acc, LDF, wmma::mem_row_major);
    }
    __syncwarp();

    float sv[WK / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < WK / 2; ++i) {
      const int c = half + 2 * i;
      const float vj = valid_s[c];
      // Keys past N do not exist (-inf); masked keys are replaced by -1e9.
      sv[i] = vj < 0.0f ? -INFINITY : (vj > 0.0f ? s_s[row * LDF + c] * scale : NEG);
      tmax = fmaxf(tmax, sv[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);  // finite: every tile has a real key
    const float alpha = expf(m_run - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < WK / 2; ++i) {
      const float p = expf(sv[i] - m_new);
      psum += p;
      p_s[row * LDH + half + 2 * i] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_s[row * LDF + half + 2 * i] *= alpha;
    __syncwarp();

    // O += P V on top of the rescaled running output.
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_s + j * 16, LDF, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, p_s + kk * 16, LDH);
        wmma::load_matrix_sync(vb, v_s + kk * 16 * LDH + j * 16, LDH);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(o_s + j * 16, acc, LDF, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int qrow = q0 + warp * 16 + row;
  if (qrow < N) {
    const float inv = 1.0f / l_run;
    bf16* o = merged ? out + ((size_t(b) * N + qrow) * heads + h) * D
                     : out + base + size_t(qrow) * D;
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      o[half + 2 * i] = __float2bfloat16(o_s[row * LDF + half + 2 * i] * inv);
    if (stats != nullptr && half == 0) {
      const size_t at = size_t(bh) * N + qrow;
      stats[at] = m_run;
      stats[size_t(gridDim.y) * N + at] = inv;
    }
  }
}

// q, k, v: (B, heads, N, 64); mask: (B, N) bytes, nonzero = real key; out:
// (B, heads, N, 64), or (B, N, heads*64) when merged; stats: null, or (2, B,
// heads, N) f32 for m and 1 / l.
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* mask,
                   void* out, float* stats, int B, int heads, int N, int kv_xor, int merged,
                   cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_wmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid((N + WQ - 1) / WQ, B * heads);
    attention_wmma_kernel<T><<<grid, WTHREADS, W_SMEM, stream>>>(
        reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
        reinterpret_cast<const T*>(v), mask, reinterpret_cast<T*>(out), stats, heads, N,
        0.125f /* 1/sqrt(64) */, kv_xor, merged);
    return cudaGetLastError();
  } else {
    dim3 grid((N + QT - 1) / QT, B * heads);
    attention_kernel<T><<<grid, NTHREADS, 0, stream>>>(
        reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
        reinterpret_cast<const T*>(v), mask, reinterpret_cast<T*>(out), stats, heads, N,
        0.125f /* 1/sqrt(64) */, kv_xor, merged);
    return cudaGetLastError();
  }
}

}  // namespace ssl_attn
