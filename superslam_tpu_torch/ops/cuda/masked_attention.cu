// masked_attention: softmax(q k^T / 8 with masked keys at -1e9) v, D = 64.
//
// Replaces the forward of superslam_tpu/ops/pallas/attention.py::
// masked_attention (_sdpa_kernel). Same semantics as the XLA route of
// superslam_tpu/models/lightglue.py::_attention: masked logits are REPLACED
// by -1e9, the softmax runs in f32, the probabilities are cast to v's type
// before the PV product, and the sum accumulates in f32. A row whose keys
// are all masked (the keyframe side on the first frame) therefore gets the
// uniform mean of v over the N real keys. The Pallas kernel adds the bias
// instead and pads N to a multiple of 128 with masked zero keys, so there
// such a row gets n/n_pad times that mean.
//
// Bound on the H100: operations. LightGlue's calls are (4, 4, 600, 64):
// 4*B*H*N^2*D = 1.47 GFLOP against 4.9 MB of q, k, v and output in bf16:
// ~1.5 us either way at the bf16 tensor-core rate and the HBM rate, and
// operations by far at the f32 CUDA-core rate this first kernel runs its
// products at.
// What the design does about it: flash-style. One block per (batch*head,
// 32-query tile) holds its queries in shared memory and walks 32-key
// tiles of k and v through shared memory with an online f32 softmax, so
// the N x N logits never reach device memory. Eight threads own a query
// row: each computes 4 of the tile's 32 logits and 8 of the 64 output
// channels. Moving the two products onto the tensor cores (mma or wgmma)
// is later work (ROADMAP queue 2).
#include <math.h>

#include "common.cuh"

namespace {

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
                     T* __restrict__ out, int heads, int N, float scale) {
  __shared__ float q_s[QT][D + 1];
  __shared__ float k_s[KT][D + 1];
  __shared__ float v_s[KT][D];
  __shared__ float p_s[QT][KT + 1];
  __shared__ float valid_s[KT];

  const int bh = blockIdx.y, b = bh / heads;
  const int q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, row = tid / 8, sub = tid % 8;
  const size_t base = size_t(bh) * N * D;
  const uint8_t* m = mask + size_t(b) * N;

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
      k_s[r][d] = in ? ssl_to_float(k[base + size_t(k0 + r) * D + d]) : 0.0f;
      v_s[r][d] = in ? ssl_to_float(v[base + size_t(k0 + r) * D + d]) : 0.0f;
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
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[base + size_t(q0 + row) * D + sub + 8 * i] = ssl_from_float<T>(acc[i] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* mask,
                   void* out, int B, int heads, int N, cudaStream_t stream) {
  dim3 grid((N + QT - 1) / QT, B * heads);
  attention_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), mask, reinterpret_cast<T*>(out), heads, N,
      0.125f /* 1/sqrt(64) */);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, heads, N, 64), bf16 if is_bf16 else f32; mask: (B, N)
// bytes, nonzero = real key.
SSL_EXPORT int ssl_masked_attention(const void* q, const void* k, const void* v,
                                    const uint8_t* mask, void* out, int B, int heads,
                                    int N, int is_bf16, void* stream) {
  if (B < 1 || heads < 1 || N < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return int(is_bf16 ? launch<__nv_bfloat16>(q, k, v, mask, out, B, heads, N, s)
                     : launch<float>(q, k, v, mask, out, B, heads, N, s));
}
