// masked_attention backward: dq, dk, dv of
//   out = softmax(q k^T / 8 with masked keys REPLACED by -1e9) v,  D = 64.
//
// Replaces superslam_tpu/ops/pallas/attention.py::_sdpa_bwd (the custom VJP
// of masked_attention, which rematerialises the probabilities):
//   p  = softmax(s)            s = q k^T / 8, masked keys at -1e9
//   dv = p^T dO
//   dp = dO v^T
//   ds = p * (dp - rowsum(dp * p))
//   dq = ds k / 8,  dk = ds^T q / 8
// It is the gradient of the port's own forward: a masked logit is a
// constant (replaced, not offset), so ds of a masked key is 0 even in a
// batch row whose keys are all masked, where p is uniform over N and only dv
// is non-zero. Wherever a row has one real key, p of a masked key underflows
// to exactly 0 in f32 and this equals _sdpa_bwd.
//
// Residuals: q, k, v and the mask, as the JAX VJP saves them; the forward
// emits no log-sum-exp, so the backward recomputes the row maximum and sum
// (kept apart, not as their log-sum-exp: in a fully-masked row the maximum
// is -1e9, which would swallow log N in f32).
// Everything inside is f32 (inputs may be bf16 or f32; results are cast to
// the inputs' type).
//
// Bound on the H100: operations. Training calls are (16, 4, 256, 64) f32:
// five N x N x 64 products per head = 2.7 GFLOP against 29 MB of q, k, v,
// dO, dq, dk, dv. f32 at 1e-4 of the plain version rules out the tensor
// cores (TF32 keeps three digits), so the products are FMA loops.
// What the design does: flash-style, two kernels, no atomics, so the result
// does not depend on block order and the N x N probabilities never reach
// device memory.
//   1. attention_bwd_dq_kernel, one block per (batch row, head, 32-query
//      tile), walks the key tiles twice: first an online softmax that also
//      carries sum_j e_ij dp_ij, giving the row's maximum, 1 / sum and
//      delta_i = rowsum(dp * p) (all three written to scratch for kernel 2);
//      then p, dp, ds again and dq += ds k.
//   2. attention_bwd_dkv_kernel, one block per (batch row, head, 32-key
//      tile), walks the query tiles with those row statistics:
//      dv += p^T dO and dk += ds^T q in registers.
// That is nine tile products where five are needed: what holds it back is
// the recomputation and the CUDA-core FMA rate. Later work: keep the
// forward's log-sum-exp and O (delta = rowsum(dO * O) then needs no
// product), skip key tiles past the last real key, 3xTF32 or bf16 tensor
// core products.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int TQ = 32, TK = 32;  // tile rows; eight threads own a row
constexpr int NTHREADS = 256;
constexpr float NEG = -1e9f;
constexpr float SCALE = 0.125f;  // 1/sqrt(64)

template <typename T>
__device__ __forceinline__ void load_tile(float (*dst)[D + 1], const T* __restrict__ src,
                                          int r0, int N, int tid) {
  for (int i = tid; i < TQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    dst[r][d] = (r0 + r < N) ? ssl_to_float(src[size_t(r0 + r) * D + d]) : 0.0f;
  }
}

__device__ __forceinline__ float dot64(const float* a, const float* b) {
  float s = 0.0f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

// Sum / max over the eight lanes that own a row (they share a warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const uint8_t* __restrict__ mask,
                            const T* __restrict__ dout, T* __restrict__ dq,
                            float* __restrict__ stats, int heads, int N) {
  __shared__ float q_s[TQ][D + 1];
  __shared__ float do_s[TQ][D + 1];
  __shared__ float k_s[TK][D + 1];
  __shared__ float v_s[TK][D + 1];
  __shared__ float ds_s[TQ][TK + 1];
  __shared__ float valid_s[TK];  // 1 real key, 0 masked key, -1 past N

  const int bh = blockIdx.y, b = bh / heads;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, row = tid / 8, sub = tid % 8;
  const size_t base = size_t(bh) * N * D;
  const uint8_t* m = mask + size_t(b) * N;

  load_tile(q_s, q + base, q0, N, tid);
  load_tile(do_s, dout + base, q0, N, tid);

  // Pass 1: the row's maximum and sum, and delta = sum_j p_ij dp_ij.
  float m_run = -INFINITY, l_run = 0.0f, dl_run = 0.0f;
  for (int k0 = 0; k0 < N; k0 += TK) {
    __syncthreads();  // the previous tile is consumed (and q_s, do_s are loaded)
    load_tile(k_s, k + base, k0, N, tid);
    load_tile(v_s, v + base, k0, N, tid);
    if (tid < TK) valid_s[tid] = (k0 + tid < N) ? (m[k0 + tid] ? 1.0f : 0.0f) : -1.0f;
    __syncthreads();
    float s[4], dp[4];
    float tmax = -INFINITY;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = sub + 8 * t;
      const float vj = valid_s[j];
      const float dot = dot64(q_s[row], k_s[j]);
      dp[t] = dot64(do_s[row], v_s[j]);
      s[t] = vj < 0.0f ? -INFINITY : (vj > 0.0f ? dot * SCALE : NEG);
      tmax = fmaxf(tmax, s[t]);
    }
    const float m_new = fmaxf(m_run, row_max(tmax));  // finite: the tile has a key < N
    const float alpha = expf(m_run - m_new);
    float esum = 0.0f, edp = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float e = expf(s[t] - m_new);
      esum += e;
      edp += e * dp[t];
    }
    l_run = l_run * alpha + row_sum(esum);
    dl_run = dl_run * alpha + row_sum(edp);
    m_run = m_new;
  }
  const float inv_l = 1.0f / l_run;
  const float delta_i = dl_run * inv_l;
  if (sub == 0 && q0 + row < N) {
    const size_t plane = size_t(gridDim.y) * N, at = size_t(bh) * N + q0 + row;
    stats[at] = m_run;
    stats[plane + at] = inv_l;
    stats[2 * plane + at] = delta_i;
  }

  // Pass 2: dq = sum_j ds_ij k_j / 8.
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < N; k0 += TK) {
    __syncthreads();
    load_tile(k_s, k + base, k0, N, tid);
    load_tile(v_s, v + base, k0, N, tid);
    if (tid < TK) valid_s[tid] = (k0 + tid < N) ? (m[k0 + tid] ? 1.0f : 0.0f) : -1.0f;
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = sub + 8 * t;
      float ds = 0.0f;
      if (valid_s[j] > 0.0f) {  // a masked logit is a constant: no gradient
        const float p = expf(dot64(q_s[row], k_s[j]) * SCALE - m_run) * inv_l;
        ds = p * (dot64(do_s[row], v_s[j]) - delta_i);
      }
      ds_s[row][j] = ds;
    }
    __syncwarp();  // the row's eight threads share a warp
    for (int j = 0; j < TK; ++j) {
      const float ds = ds_s[row][j];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += ds * k_s[j][sub + 8 * i];
    }
  }
  if (q0 + row < N) {
    T* o = dq + base + size_t(q0 + row) * D;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[sub + 8 * i] = ssl_from_float<T>(acc[i] * SCALE);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const uint8_t* __restrict__ mask,
                             const T* __restrict__ dout, const float* __restrict__ stats,
                             T* __restrict__ dk, T* __restrict__ dv, int heads, int N) {
  __shared__ float k_s[TK][D + 1];
  __shared__ float v_s[TK][D + 1];
  __shared__ float q_s[TQ][D + 1];
  __shared__ float do_s[TQ][D + 1];
  __shared__ float p_s[TK][TQ + 1];   // p^T: [key][query]
  __shared__ float ds_s[TK][TQ + 1];  // ds^T
  __shared__ float max_s[TQ], inv_s[TQ], delta_s[TQ];

  const int bh = blockIdx.y, b = bh / heads;
  const int k0 = blockIdx.x * TK;
  const int tid = threadIdx.x, row = tid / 8, sub = tid % 8;  // row = this thread's key
  const size_t base = size_t(bh) * N * D;
  const bool in = k0 + row < N;
  const bool real = in && mask[size_t(b) * N + k0 + row] != 0;

  load_tile(k_s, k + base, k0, N, tid);
  load_tile(v_s, v + base, k0, N, tid);

  float acc_k[8], acc_v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc_k[i] = acc_v[i] = 0.0f;

  for (int q0 = 0; q0 < N; q0 += TQ) {
    __syncthreads();
    load_tile(q_s, q + base, q0, N, tid);
    load_tile(do_s, dout + base, q0, N, tid);
    if (tid < TQ) {
      const bool qin = q0 + tid < N;
      const size_t plane = size_t(gridDim.y) * N, at = size_t(bh) * N + q0 + tid;
      max_s[tid] = qin ? stats[at] : 0.0f;
      inv_s[tid] = qin ? stats[plane + at] : 0.0f;  // p = 0 past N
      delta_s[tid] = qin ? stats[2 * plane + at] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = sub + 8 * t;
      const float s = real ? dot64(q_s[i], k_s[row]) * SCALE : NEG;
      const float p = in ? expf(s - max_s[i]) * inv_s[i] : 0.0f;
      p_s[row][i] = p;
      ds_s[row][i] = real ? p * (dot64(do_s[i], v_s[row]) - delta_s[i]) : 0.0f;
    }
    __syncwarp();  // the key's eight threads share a warp
    for (int i = 0; i < TQ; ++i) {
      const float p = p_s[row][i], ds = ds_s[row][i];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc_v[c] += p * do_s[i][sub + 8 * c];
        acc_k[c] += ds * q_s[i][sub + 8 * c];
      }
    }
  }
  if (in) {
    T* ok = dk + base + size_t(k0 + row) * D;
    T* ov = dv + base + size_t(k0 + row) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      ok[sub + 8 * c] = ssl_from_float<T>(acc_k[c] * SCALE);
      ov[sub + 8 * c] = ssl_from_float<T>(acc_v[c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* mask,
                   const void* dout, void* dq, void* dk, void* dv, float* stats, int B,
                   int heads, int N, cudaStream_t stream) {
  const T* qt = reinterpret_cast<const T*>(q);
  const T* kt = reinterpret_cast<const T*>(k);
  const T* vt = reinterpret_cast<const T*>(v);
  const T* gt = reinterpret_cast<const T*>(dout);
  dim3 grid((N + TQ - 1) / TQ, B * heads);
  attention_bwd_dq_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      qt, kt, vt, mask, gt, reinterpret_cast<T*>(dq), stats, heads, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      qt, kt, vt, mask, gt, stats, reinterpret_cast<T*>(dk), reinterpret_cast<T*>(dv), heads,
      N);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (B, heads, N, 64), bf16 if is_bf16 else f32;
// mask: (B, N) bytes, nonzero = real key; stats: (3, B, heads, N) f32 scratch
// that the call fills and reads (row maximum, 1 / row sum, delta).
SSL_EXPORT int ssl_masked_attention_bwd(const void* q, const void* k, const void* v,
                                        const uint8_t* mask, const void* dout, void* dq,
                                        void* dk, void* dv, float* stats, int B, int heads,
                                        int N, int is_bf16, void* stream) {
  if (B < 1 || heads < 1 || N < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return int(is_bf16
                 ? launch<__nv_bfloat16>(q, k, v, mask, dout, dq, dk, dv, stats, B, heads, N, s)
                 : launch<float>(q, k, v, mask, dout, dq, dk, dv, stats, B, heads, N, s));
}
