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
// Residuals: q, k, v, the mask, the forward's output O and, per query row,
// the forward's softmax maximum m and 1 / l (attention.cuh writes them when
// asked), kept apart as two f32 planes: in a fully-masked row m = -1e9 would
// swallow log N in a log-sum-exp. So p = exp(s - m) / l needs no softmax
// pass, and rowsum(dp * p) = dO . O (delta) needs no product: each kernel
// takes the 64-long dot of its own query rows while it stages dO.
// Inputs may be bf16 or f32; everything inside is f32 and results are cast
// to the inputs' type.
//
// Bound on the H100: operations. Training calls are (16, 4, 256, 64) f32:
// five N x N x 64 products per head over the real keys, ~1.9 GFLOP at f32
// precision, i.e. ~5.8 GFLOP of TF32 in 3xTF32 (0.0117 ms at 495 TFLOP/s),
// plus ~0.02 GFLOP of f32 per logit; 0.0121 ms in all, against 34 MB of q,
// k, v, dO, O, the row statistics, dq, dk, dv (0.0101 ms at 3.35 TB/s). What the design does about it (two kernels, no atomics, so the result
// does not depend on block order and the N x N probabilities never reach
// device memory):
//   1. attn_bwd_dkv_kernel, one block per (batch row, head, BR-key tile),
//      walks the query tiles: S^T = K Q^T, P^T from (m, 1/l), dV += P^T dO,
//      dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.
//   2. attn_bwd_dq_kernel, one block per (batch row, head, BR-query tile),
//      walks the key tiles: S = Q K^T, P, dP = dO V^T, dS, dQ += dS K.
//   Seven tile products where the earlier FMA kernels ran nine.
//   * Key tiles that hold no real key are skipped. The dq kernel tests each
//     key tile's mask bytes (a warp vote) and skips it: its ds is 0. In
//     the dk/dv kernel such a tile has dk = 0, and dv = 0 wherever the batch
//     row has a real key (p underflows to exactly 0 in f32), so the block
//     writes zeros and leaves; only a fully-masked batch row computes dv (p
//     = 1/N there; dq = dk = 0).
//   * The products run on the tensor cores in 3xTF32: mma.sync m16n8k8
//     tf32 with f32 accumulators; each operand x is split into big =
//     tf32(x) and small = tf32(x - big) (cvt.rna.tf32.f32) and the product
//     is big*big + big*small + small*big, about f32's accuracy (one TF32
//     product keeps three digits and misses the 1e-4 limit:
//     tests/test_torch_attention_bwd_model.py). The helpers (split,
//     staging, mm_rows, mm_acc) are tf32_mma.cuh, shared with the f32
//     forward in attention.cuh. The staged q, k, v and dO
//     tiles are split once, on their way into shared memory (big and small
//     planes side by side); P and dS are split in registers. A bf16 input
//     is exact in TF32 (its small part is 0): one code path for both types.
//   * Fragment layouts: the m16n8 accumulator (c0..c3 at (g, 2t), (g, 2t+1),
//     (g+8, 2t), (g+8, 2t+1)) is not the m16n8k8 A layout ((g, t), (g+8, t),
//     (g, t+4), (g+8, t+4)). Neither shuffles nor a staging tile are used:
//     the k index of a product is permuted instead (k slot t is column 2t,
//     slot t + 4 is column 2t + 1), so a lane's P or dS accumulators are
//     its A fragment as they stand, and the B operand reads rows 2t and 2t
//     + 1 of the staged tile (pattern (row 2t, col g)). mm_acc below.
//   * Bank conflicts: the staged tiles are read in two patterns, (row g,
//     col t) for S-type products and (row 2t (+1), col g) for the permuted
//     ones. A pitch of 68 floats keeps both conflict-free (4g + t and 8t +
//     g (+ 4) are 32 distinct banks); the cross-warp reduction of the
//     partial sums uses a pitch of 72 for its float2 stores. The model is
//     attention.py::bwd_layout; tests/test_torch_attention_bwd_model.py
//     enumerates every fragment load on the CPU, proves each conflict-free
//     and in bounds, and checks it against the constants below.
//   * Staging: the next walked tile arrives raw (f32 or bf16,
//     zero-filled past N) by cp.async into a staging buffer while this
//     tile's products run; the split into big and small planes (and, in
//     the dk/dv kernel, delta) reads it back from shared memory. About 12%
//     faster than staging straight from device memory between two barriers
//     (one 190 KB block per SM: nothing else overlaps the loads). The dq
//     kernel finds the next key tile with a real key by a warp vote over
//     its mask bytes, so a skipped tile is never loaded.
//   * Grid: a block is BR / 16 x WC warps, each owning 16 of the block's rows
//     and BC / WC of a walked tile's; the WC partial sums of a row meet in
//     shared memory at the end. At (16, 4, 256, 64), BR = 64 gives 256
//     blocks a kernel and BR = 32 512; BR = 32 (two blocks per SM) and WC =
//     1 (4 warps) were slower (scripts/kernel_variants_torch.py, variants
//     "r32:BR=32", "wc1:WC=1"; PERF.md has the times).
#include <math.h>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int D = 64;
constexpr int LD = D + 4;     // floats a staged row: 68 (conflict-free in both patterns)
constexpr int RLD = D + 8;    // floats a row of the reduction scratch: 72
constexpr int BR = 64;        // the block's own rows (queries for dq, keys for dk/dv)
constexpr int BC = 64;        // rows of a walked tile (keys for dq, queries for dk/dv)
constexpr int WC = 2;         // warps across a walked tile (1 or 2)
constexpr int WR = BR / 16;   // warps across the own rows
constexpr int NWARPS = WR * WC;
constexpr int NTHREADS = NWARPS * 32;
constexpr int CW = BC / WC;   // walked rows (logit columns) of one warp
constexpr int NTC = CW / 8;   // n-tiles of a warp's logits
constexpr int OWN = 4 * BR * LD;    // floats: two own tensors, big and small planes
constexpr int WALK = 4 * BC * LD;   // floats: two walked tensors, big and small planes
constexpr int RAW = 3 * BC * D;      // floats: the raw staging buffer (f32 at most)
constexpr int SMEM_FLOATS = OWN + WALK + RAW + 3 * BC + 3 * BR;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;  // 189,952 at BR = BC = 64
constexpr float NEG = -1e9f;
constexpr float SCALE = 0.125f;  // 1/sqrt(64)

static_assert(BR % 16 == 0 && BC % (8 * WC) == 0 && (WC == 1 || WC == 2), "tiles");
static_assert((BR * 16) % NTHREADS == 0 && (BC * 16) % NTHREADS == 0, "uniform staging loops");
static_assert(BC <= NTHREADS && BR <= NTHREADS, "one thread a row for the vectors");
static_assert(WC == 1 || 2 * BR * RLD <= WALK, "the reduction scratch fits the walked tiles");
static_assert(SMEM_BYTES <= 232448, "shared memory");

using tf32_mma::load4;
using tf32_mma::prefetch_wait;
using tf32_mma::split_store;

template <int ROWS, typename T>
__device__ __forceinline__ void stage(float* big, float* small, const T* src, int r0, int N,
                                      int tid) {
  tf32_mma::stage<ROWS, NTHREADS, LD>(big, small, src, r0, N, tid);
}

// The same for dO, and delta_s[r] = dO_r . O_r in f32: the 16 lanes of a
// row's chunks are one half-warp.
template <int ROWS, typename T>
__device__ __forceinline__ void stage_delta(float* big, float* small, float* delta_s,
                                            const T* dout, const T* o, int r0, int N, int tid) {
  for (int i = tid; i < ROWS * 16; i += NTHREADS) {
    const int r = i >> 4, c = (i & 15) * 4;
    const bool in = r0 + r < N;
    const float4 g = in ? load4(dout + size_t(r0 + r) * D + c) : make_float4(0, 0, 0, 0);
    const float4 y = in ? load4(o + size_t(r0 + r) * D + c) : make_float4(0, 0, 0, 0);
    float part = g.x * y.x + g.y * y.y + g.z * y.z + g.w * y.w;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if ((i & 15) == 0) delta_s[r] = part;
    split_store(big, small, r * LD + c, g);
  }
}

// The next walked tile's rows of NT tensors (src[t] + r0 rows, N x 64)
// into the raw staging buffer (NT x BC x 64 elements of T) by cp.async.
template <int NT, typename T>
__device__ __forceinline__ void prefetch(T* raw, const T* const (&src)[NT], int r0, int N,
                                         int tid) {
  tf32_mma::prefetch<NT, BC, NTHREADS>(raw, src, r0, N, tid);
}

// c[p] = X_p Y_p^T for the warp's two S-type products p (tf32_mma::mm_rows).
__device__ __forceinline__ void mm_rows(float (&c)[2][NTC][4], const float* const (&x)[2][2],
                                        int m0, const float* const (&y)[2][2], int n0,
                                        int lane) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
    tf32_mma::mm_rows<LD, NTC>(c[p], x[p][0], x[p][1], m0, y[p][0], y[p][1], n0, lane);
}

__device__ __forceinline__ void mm_acc(float (&acc)[8][4], const float (&p)[NTC][4],
                                       const float* zb, const float* zs, int n0, int lane) {
  tf32_mma::mm_acc<LD, NTC>(acc, p, zb, zs, n0, lane);
}

__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// Adds the partial sums of the warps with wc > 0 onto those of wc = 0
// through red (pitch RLD floats, float2 at (row g (+8), col 8 nt + 2t):
// banks 8g + 2t of a half-warp phase), then warps wc = 0 write rows r0 + m0
// + g (+ 8) < N of out (scaled).
template <typename T>
__device__ __forceinline__ void reduce_store(float (&acc)[8][4], float* red, int wc, int m0,
                                             T* __restrict__ out, int r0, int N, float scale,
                                             int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  if (WC > 1) {
    if (wc == 1) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<float2*>(red + (m0 + g) * RLD + 8 * nt + t2) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(red + (m0 + g + 8) * RLD + 8 * nt + t2) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    __syncthreads();
    if (wc != 0) return;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 lo = *reinterpret_cast<const float2*>(red + (m0 + g) * RLD + 8 * nt + t2);
      const float2 hi = *reinterpret_cast<const float2*>(red + (m0 + g + 8) * RLD + 8 * nt + t2);
      acc[nt][0] += lo.x, acc[nt][1] += lo.y, acc[nt][2] += hi.x, acc[nt][3] += hi.y;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + m0 + g + 8 * hr;
    if (row >= N) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      store2(out + size_t(row) * D + 8 * nt + t2, acc[nt][2 * hr] * scale,
             acc[nt][2 * hr + 1] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ mask,
                       const T* __restrict__ dout, const T* __restrict__ o,
                       const float* __restrict__ stats, T* __restrict__ dq, int heads, int N) {
  extern __shared__ __align__(16) float sm[];
  float *qb = sm, *qs = qb + BR * LD, *gb = qs + BR * LD, *gs = gb + BR * LD;
  float *kb = sm + OWN, *ks = kb + BC * LD, *vb = ks + BC * LD, *vs = vb + BC * LD;
  T* raw = reinterpret_cast<T*>(sm + OWN + WALK);  // k, v of the next key tile
  float* valid_s = sm + OWN + WALK + RAW;          // BC: 1 real key, 0 masked or past N
  float *m_s = valid_s + BC, *inv_s = m_s + BR, *delta_s = inv_s + BR;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp % WR, wc = warp / WR, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, r0 = blockIdx.x * BR;
  const size_t base = size_t(bh) * N * D;
  const uint8_t* mrow = mask + size_t(b) * N;
  const T* const kv[2] = {k + base, v + base};

  // The next key tile from k0 on that holds a real key (N if none): every
  // warp votes over the tile's mask bytes, so the answer is block-uniform.
  auto next_real = [&](int k0) {
    for (; k0 < N; k0 += BC) {
      bool any = false;
      for (int i = lane; i < BC; i += 32) any |= k0 + i < N && __ldg(mrow + k0 + i) != 0;
      if (__any_sync(0xffffffffu, any)) break;
    }
    return k0;
  };
  int k0 = next_real(0);
  prefetch<2>(raw, kv, k0, N, tid);
  stage<BR>(qb, qs, q + base, r0, N, tid);
  stage_delta<BR>(gb, gs, delta_s, dout + base, o + base, r0, N, tid);
  if (tid < BR) {
    const bool in = r0 + tid < N;
    m_s[tid] = in ? stats[size_t(bh) * N + r0 + tid] : 0.0f;
    inv_s[tid] = in ? stats[size_t(gridDim.y) * N + size_t(bh) * N + r0 + tid] : 0.0f;
  }
  __syncthreads();
  const int m0 = 16 * wr, n0 = CW * wc;
  const float rm[2] = {m_s[m0 + g], m_s[m0 + g + 8]};
  const float rinv[2] = {inv_s[m0 + g], inv_s[m0 + g + 8]};
  const float rdelta[2] = {delta_s[m0 + g], delta_s[m0 + g + 8]};
  const float* const x[2][2] = {{qb, qs}, {gb, gs}};
  const float* const y[2][2] = {{kb, ks}, {vb, vs}};

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  // Key tiles without a real key add nothing (ds = 0) and are never loaded.
  while (k0 < N) {
    const int kn = next_real(k0 + BC);
    prefetch_wait();
    __syncthreads();  // tile k0 landed for everyone; the planes are free
    stage<BC>(kb, ks, raw, 0, BC, tid);
    stage<BC>(vb, vs, raw + BC * D, 0, BC, tid);
    if (tid < BC) valid_s[tid] = (k0 + tid < N && mrow[k0 + tid] != 0) ? 1.0f : 0.0f;
    __syncthreads();
    prefetch<2>(raw, kv, kn, N, tid);  // under this tile's products
    float sdp[2][NTC][4];  // S, then ds; dP
    mm_rows(sdp, x, m0, y, n0, lane);
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = valid_s[n0 + 8 * nt + 2 * t + (e & 1)] > 0.0f
                            ? expf(sdp[0][nt][e] * SCALE - rm[hr]) * rinv[hr]
                            : 0.0f;
        sdp[0][nt][e] = p * (sdp[1][nt][e] - rdelta[hr]);  // ds
      }
    mm_acc(acc, sdp[0], kb, ks, n0, lane);
    k0 = kn;
  }
  __syncthreads();  // the walked tiles are free: the reduction scratch
  reduce_store(acc, sm + OWN, wc, m0, dq + base, r0, N, SCALE, lane);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ mask,
                        const T* __restrict__ dout, const T* __restrict__ o,
                        const float* __restrict__ stats, T* __restrict__ dk,
                        T* __restrict__ dv, int heads, int N) {
  extern __shared__ __align__(16) float sm[];
  float *kb = sm, *ks = kb + BR * LD, *vb = ks + BR * LD, *vs = vb + BR * LD;
  float *qb = sm + OWN, *qs = qb + BC * LD, *gb = qs + BC * LD, *gs = gb + BC * LD;
  T* raw = reinterpret_cast<T*>(sm + OWN + WALK);  // q, dO, O of the next query tile
  float *qm_s = sm + OWN + WALK + RAW, *qinv_s = qm_s + BC, *qdelta_s = qinv_s + BC;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp % WR, wc = warp / WR, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, r0 = blockIdx.x * BR;
  const size_t base = size_t(bh) * N * D;
  const size_t plane = size_t(gridDim.y) * N;
  const uint8_t* mrow = mask + size_t(b) * N;
  const T* const qgo[3] = {q + base, dout + base, o + base};

  int row_real = 0, tile_real = 0;
  for (int i = tid; i < N; i += NTHREADS)
    if (mrow[i]) row_real = 1, tile_real |= int(i >= r0 && i < r0 + BR);
  row_real = __syncthreads_or(row_real);
  tile_real = __syncthreads_or(tile_real);
  if (row_real && !tile_real) {  // p = 0 and ds = 0 for every key here
    for (int i = tid; i < BR * D; i += NTHREADS) {
      if (r0 + i / D >= N) break;
      dk[base + size_t(r0) * D + i] = ssl_from_float<T>(0.0f);
      dv[base + size_t(r0) * D + i] = ssl_from_float<T>(0.0f);
    }
    return;
  }
  prefetch<3>(raw, qgo, 0, N, tid);
  stage<BR>(kb, ks, k + base, r0, N, tid);
  stage<BR>(vb, vs, v + base, r0, N, tid);
  const int m0 = 16 * wr, n0 = CW * wc;
  const bool real[2] = {r0 + m0 + g < N && mrow[r0 + m0 + g] != 0,
                        r0 + m0 + g + 8 < N && mrow[r0 + m0 + g + 8] != 0};
  const float* const x[2][2] = {{kb, ks}, {vb, vs}};
  const float* const y[2][2] = {{qb, qs}, {gb, gs}};

  float acc_k[8][4], acc_v[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nt][e] = acc_v[nt][e] = 0.0f;
  for (int q0 = 0; q0 < N; q0 += BC) {
    prefetch_wait();
    __syncthreads();  // tile q0 landed for everyone; the planes are free
    stage<BC>(qb, qs, raw, 0, BC, tid);
    stage_delta<BC>(gb, gs, qdelta_s, raw + BC * D, raw + 2 * BC * D, 0, BC, tid);
    if (tid < BC) {
      const bool in = q0 + tid < N;  // p = 0 past N
      qm_s[tid] = in ? stats[size_t(bh) * N + q0 + tid] : 0.0f;
      qinv_s[tid] = in ? stats[plane + size_t(bh) * N + q0 + tid] : 0.0f;
    }
    __syncthreads();
    prefetch<3>(raw, qgo, q0 + BC, N, tid);  // under this tile's products
    float sdp[2][NTC][4];  // S^T, then p^T; dP^T, then ds^T
    mm_rows(sdp, x, m0, y, n0, lane);  // own keys x walked queries
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = n0 + 8 * nt + 2 * t + (e & 1);
        const float sv = real[e >> 1] ? sdp[0][nt][e] * SCALE : NEG;
        const float p = expf(sv - qm_s[i]) * qinv_s[i];
        sdp[0][nt][e] = p;
        sdp[1][nt][e] = real[e >> 1] ? p * (sdp[1][nt][e] - qdelta_s[i]) : 0.0f;
      }
    mm_acc(acc_v, sdp[0], gb, gs, n0, lane);  // dV += P^T dO
    mm_acc(acc_k, sdp[1], qb, qs, n0, lane);  // dK += dS^T Q
  }
  __syncthreads();  // the walked tiles are free: the reduction scratch
  reduce_store(acc_v, sm + OWN, wc, m0, dv + base, r0, N, 1.0f, lane);
  __syncthreads();
  reduce_store(acc_k, sm + OWN + BR * RLD, wc, m0, dk + base, r0, N, SCALE, lane);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* mask,
                   const void* dout, const void* o, const float* stats, void* dq, void* dk,
                   void* dv, int B, int heads, int N, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const T* ot = static_cast<const T*>(o);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BR - 1) / BR, B * heads);
  attn_bwd_dkv_kernel<T><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      qt, kt, vt, mask, gt, ot, stats, static_cast<T*>(dk), static_cast<T*>(dv), heads, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<T><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      qt, kt, vt, mask, gt, ot, stats, static_cast<T*>(dq), heads, N);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, out, dq, dk, dv: (B, heads, N, 64), bf16 if is_bf16 else
// f32, 16-byte aligned; mask: (B, N) bytes, nonzero = real key; out and
// stats are the forward's output and its (2, B, heads, N) f32 row
// statistics (maximum, 1 / sum), as ssl_masked_attention writes them.
SSL_EXPORT int ssl_masked_attention_bwd(const void* q, const void* k, const void* v,
                                        const uint8_t* mask, const void* dout, const void* out,
                                        const float* stats, void* dq, void* dk, void* dv,
                                        int B, int heads, int N, int is_bf16, void* stream) {
  if (B < 1 || heads < 1 || N < 1) return int(cudaErrorInvalidValue);
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                        reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(dq) |
                        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (any % 16 != 0) return int(cudaErrorMisalignedAddress);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return int(is_bf16 ? launch<__nv_bfloat16>(q, k, v, mask, dout, out, stats, dq, dk, dv, B,
                                             heads, N, s)
                     : launch<float>(q, k, v, mask, dout, out, stats, dq, dk, dv, B, heads, N,
                                     s));
}
