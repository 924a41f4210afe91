// The key-masked attention forward kernels shared by masked_attention.cu
// (its own entry point) and lightglue_layer.cu (stage b of the fused blocks).
//
// softmax(q k^T / 8 with masked keys REPLACED by -1e9) v over D = 64, f32
// softmax, probabilities rounded to T before the PV product (the sum is
// taken over the unrounded f32 values), f32 sums. Flash-style: each warp
// owns 16 query rows and walks 64-key tiles with an online softmax held in
// registers, so the N x N logits never leave the register file.
// masked_attention.cu's header says what bounds them on the H100. Two
// kernels, both on mma.sync:
// - bf16 (attn_fwd_bf16_kernel): m16n8k16 bf16 with f32 accumulators. The
//   warp's Q fragments are loaded once by ldmatrix from a swizzled tile and
//   kept in registers. K and V tiles (64 keys x 128 bytes, chunk j of row r
//   at chunk j ^ (r & 7), as conv_mma.cuh's swz) stream through a ring of
//   KSTAGES slots by cp.async, KSTAGES - 1 tiles ahead of the one in use,
//   zero-filled past N. S = Q K^T takes K's B fragments by
//   ldmatrix; the scale, the mask replacement, the running maximum and sum
//   stay in registers (the four lanes of a row reduce with __shfl_xor 1 and
//   2). P becomes bf16 A fragments straight from the S accumulators (two
//   adjacent n8 tiles are one k16 fragment) and V's B fragments come by
//   ldmatrix.trans. O stays in registers (8 n-tiles x 4 floats a lane), is
//   rescaled there and written as bf16x2 from the accumulator layout.
// - f32 (attn_fwd_f32_kernel): 3xTF32 m16n8k8 (tf32_mma.cuh), the dq
//   kernel of attention_bwd.cu's first half: Q split into big and small A
//   fragments in registers once; each key tile arrives raw by cp.async
//   under the previous tile's products and is split into big and small
//   planes of pitch 68; S by mm_rows_reg, the online softmax in registers,
//   O += P V by mm_acc with its permuted k (no shuffles, no staging tile).
// Key tiles that hold no real key are skipped (a warp vote over their mask
// bytes): exact wherever the batch row has a real key, since then the
// probability of a masked key underflows to exactly 0 in f32. A batch row
// with no real key walks every tile: its keys all sit at -1e9 and it
// averages v over all N keys.
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
// m = -1e9 would swallow log N in f32. The output is the same, bit for bit,
// with or without them. The address models of both kernels are
// attention.py::fwd_layout; tests/test_torch_attention_fwd_model.py checks
// them against the constants below and models the arithmetic on the CPU.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "conv_mma.cuh"
#include "tf32_mma.cuh"

namespace ssl_attn {

constexpr int D = 64;
constexpr int KT = 64;           // keys a tile (both kernels)
constexpr float NEG = -1e9f;
constexpr float SCALE = 0.125f;  // 1/sqrt(64)

// bf16: query rows a block (16 a warp) and the swizzled tiles.
constexpr int BQ = 64;
constexpr int BWARPS = BQ / 16;
constexpr int BTHREADS = 32 * BWARPS;
constexpr int ROW_BYTES = D * 2;                     // 128: one bf16 row, 8 chunks
constexpr int KV_BYTES = KT * ROW_BYTES;             // one k or v tile
constexpr int KSTAGES = 2;                           // slots of the key/value ring
constexpr int B_SMEM = BQ * ROW_BYTES + 2 * KSTAGES * KV_BYTES;  // q, then (k, v) x KSTAGES

// f32: query rows a block and the staged planes (floats).
constexpr int FQ = 64;
constexpr int FWARPS = FQ / 16;
constexpr int FTHREADS = 32 * FWARPS;
constexpr int FLD = D + 4;                            // 68: conflict-free in both patterns
constexpr int F_PLANE = KT * FLD;                     // one staged plane
constexpr int F_RAW = 2 * KT * D;                     // the next tile's k and v, raw
constexpr int F_SMEM = (4 * F_PLANE + F_RAW) * 4;     // k big, k small, v big, v small, raw

static_assert(FQ <= 2 * KT && BQ % 16 == 0 && FQ % 16 == 0, "query tiles");
static_assert(KSTAGES >= 2, "the ring holds the tile in use and the next");
static_assert(B_SMEM <= 232448 && F_SMEM <= 232448, "shared memory");

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Bit j: key k0 + j of the tile is real (inside N and not masked).
__device__ __forceinline__ uint64_t key_bits(const uint8_t* mrow, int k0, int N, int lane) {
  const bool lo = k0 + lane < N && __ldg(mrow + k0 + lane) != 0;
  const bool hi = k0 + 32 + lane < N && __ldg(mrow + k0 + 32 + lane) != 0;
  return uint64_t(__ballot_sync(0xffffffffu, lo)) |
         (uint64_t(__ballot_sync(0xffffffffu, hi)) << 32);
}

// The first key tile from k0 on that holds a real key (>= N if none); the
// same answer in every warp.
__device__ __forceinline__ int first_real(const uint8_t* mrow, int k0, int N, int lane) {
  for (; k0 < N; k0 += KT)
    if (key_bits(mrow, k0, N, lane) != 0) break;
  return k0;
}

// One key tile's online softmax on the warp's logits s (the m16n8
// accumulators of S = Q K^T over the tile's 64 keys, unscaled): keys past N
// are -inf, masked keys are replaced by -1e9, the running maximum m and sum
// l of rows g and g + 8 are updated, o is rescaled, and s becomes the
// unnormalised f32 probabilities exp(logit - m).
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&o)[8][4],
                                               float (&m_run)[2], float (&l_run)[2],
                                               uint64_t bits, int k0, int N, int t) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * nt + 2 * t + (e & 1);
      const float x =
          k0 + c >= N ? -INFINITY : (((bits >> c) & 1) ? s[nt][e] * SCALE : NEG);
      s[nt][e] = x;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
    }
  float alpha[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    tmax[hr] = fmaxf(tmax[hr], __shfl_xor_sync(0xffffffffu, tmax[hr], 1));
    tmax[hr] = fmaxf(tmax[hr], __shfl_xor_sync(0xffffffffu, tmax[hr], 2));
    const float m_new = fmaxf(m_run[hr], tmax[hr]);  // finite: the tile has a key below N
    alpha[hr] = expf(m_run[hr] - m_new);
    m_run[hr] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[nt][e] - m_run[e >> 1]);
      psum[e >> 1] += p;
      s[nt][e] = p;
      o[nt][e] *= alpha[e >> 1];
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    psum[hr] += __shfl_xor_sync(0xffffffffu, psum[hr], 1);
    psum[hr] += __shfl_xor_sync(0xffffffffu, psum[hr], 2);
    l_run[hr] = l_run[hr] * alpha[hr] + psum[hr];
  }
}

// Rows row0 + g (+ 8) < N of the output, o / l from the accumulator layout,
// and their statistics when asked.
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ out, float* __restrict__ stats,
                                           const float (&o)[8][4], const float (&m_run)[2],
                                           const float (&l_run)[2], int b, int h, int heads,
                                           int N, int row0, int merged, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int bh = b * heads + h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + g + 8 * hr;
    if (row >= N) continue;
    const float inv = 1.0f / l_run[hr];
    T* dst = merged ? out + ((size_t(b) * N + row) * heads + h) * D
                    : out + (size_t(bh) * N + row) * D;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      store2(dst + 8 * nt + 2 * t, o[nt][2 * hr] * inv, o[nt][2 * hr + 1] * inv);
    if (stats != nullptr && t == 0) {
      const size_t at = size_t(bh) * N + row;
      stats[at] = m_run[hr];
      stats[size_t(gridDim.y) * N + at] = inv;
    }
  }
}

// -- bf16 -----------------------------------------------------------------

// Rows r0 .. r0 + ROWS of src (N x 64 bf16) into a swizzled tile by
// cp.async, zero-filled past N: copy i is chunk i & 7 of row i >> 3.
template <int ROWS>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src, int r0, int N,
                                          int tid) {
  for (int i = tid; i < ROWS * 8; i += BTHREADS) {
    const int r = i >> 3, c = i & 7;
    const bool in = r0 + r < N;
    conv_mma::cp_async16(tile + conv_mma::swz(r, c), in ? src + size_t(r0 + r) * D + 8 * c : src,
                         in);
  }
}

template <typename bf16>
__global__ void __launch_bounds__(BTHREADS)
    attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                         bf16* __restrict__ out, float* __restrict__ stats, int heads, int N,
                         int kv_xor, int merged) {
  static_assert(std::is_same<bf16, __nv_bfloat16>::value, "the bf16 kernel");
  using conv_mma::ldsm_x4;
  using conv_mma::ldsm_x4_trans;
  using conv_mma::mma_bf16;
  using conv_mma::swz;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = conv_mma::smem_u32(smem);
  const uint32_t kv_s = q_s + BQ * ROW_BYTES;  // slot u: k at + 2u KV_BYTES, v after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads, bk = b ^ kv_xor;
  const int q0 = blockIdx.x * BQ;
  const bf16* kp = k + (size_t(bk) * heads + h) * N * D;
  const bf16* vp = v + (size_t(bk) * heads + h) * N * D;
  const uint8_t* mrow = mask + size_t(bk) * N;

  // Without a real key in the batch row every key counts (at -1e9).
  int k0 = first_real(mrow, 0, N, lane);
  const bool all = k0 >= N;
  if (all) k0 = 0;
  auto next = [&](int k) { return all ? k + KT : first_real(mrow, k + KT, N, lane); };
  // Key tile kt (nothing past N) into ring slot u; one commit group a call.
  auto load_kv = [&](int u, int kt) {
    if (kt < N) {
      const uint32_t dst = kv_s + 2 * u * KV_BYTES;
      load_tile<KT>(dst, kp, kt, N, tid);
      load_tile<KT>(dst + KV_BYTES, vp, kt, N, tid);
    }
    conv_mma::cp_async_commit();
  };

  // The query tile rides in the first tile's group; kf, the prefetch front,
  // runs KSTAGES - 1 tiles ahead of k0.
  load_tile<BQ>(q_s, q + size_t(bh) * N * D, q0, N, tid);
  int kf = k0;
  load_kv(0, kf);
  for (int u = 1; u < KSTAGES - 1; ++u) load_kv(u, kf = next(kf));
  conv_mma::cp_async_wait<KSTAGES - 2>();
  __syncthreads();
  // The warp's 16 rows as A fragments, k-steps of 16 columns: lane l points
  // at row l & 15, chunk 2 ks + (l >> 4).
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(q_s + swz(16 * warp + (lane & 15), 2 * ks + (lane >> 4)), qa[ks]);

  float o[8][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
  int slot = 0;
  while (k0 < N) {
    conv_mma::cp_async_wait<KSTAGES - 2>();
    __syncthreads();  // tile k0 landed for everyone; the slot of the tile before it is consumed
    kf = next(kf);
    load_kv((slot + KSTAGES - 1) % KSTAGES, kf);  // under this tile's products
    const uint64_t bits = key_bits(mrow, k0, N, lane);
    const uint32_t ks_ = kv_s + 2 * slot * KV_BYTES, vs_ = ks_ + KV_BYTES;

    // S = Q K^T: lane l points at key row 16 hh + 8 (l >> 4) + (l & 7),
    // chunk 2 ks + ((l >> 3) & 1): b0, b1 of n-tile 2 hh, then of 2 hh + 1.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        uint32_t kb[4];
        ldsm_x4(ks_ + swz(16 * hh + 8 * (lane >> 4) + (lane & 7), 2 * ks + ((lane >> 3) & 1)), kb);
        mma_bf16(s[2 * hh], qa[ks], kb[0], kb[1]);
        mma_bf16(s[2 * hh + 1], qa[ks], kb[2], kb[3]);
      }
    online_softmax(s, o, m_run, l_run, bits, k0, N, t);

    // O += P V over k-steps of 16 keys: n-tiles 2 kk and 2 kk + 1 of P are
    // the A fragment; lane l points ldmatrix.trans at key row 16 kk + (l &
    // 15), chunk 2 j + (l >> 4): b0, b1 of output n-tile 2 j, then of 2 j + 1.
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t vb[4];
        ldsm_x4_trans(vs_ + swz(16 * kk + (lane & 15), 2 * j + (lane >> 4)), vb);
        mma_bf16(o[2 * j], pa, vb[0], vb[1]);
        mma_bf16(o[2 * j + 1], pa, vb[2], vb[3]);
      }
    }
    k0 = next(k0);
    slot = slot + 1 == KSTAGES ? 0 : slot + 1;
  }
  store_rows(out, stats, o, m_run, l_run, b, h, heads, N, q0 + 16 * warp, merged, lane);
}

// -- f32 (3xTF32) -------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(FTHREADS)
    attn_fwd_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ mask,
                        T* __restrict__ out, float* __restrict__ stats, int heads, int N,
                        int kv_xor, int merged) {
  static_assert(std::is_same<T, float>::value, "the f32 kernel");
  using tf32_mma::lds;
  extern __shared__ __align__(16) float fsm[];
  float *kb = fsm, *ks = kb + F_PLANE, *vb = ks + F_PLANE, *vs = vb + F_PLANE;
  float* raw = fsm + 4 * F_PLANE;  // k, v of the next key tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads, bk = b ^ kv_xor;
  const int q0 = blockIdx.x * FQ;
  const size_t base_kv = (size_t(bk) * heads + h) * N * D;
  const uint8_t* mrow = mask + size_t(bk) * N;
  const T* const kv[2] = {k + base_kv, v + base_kv};

  int k0 = first_real(mrow, 0, N, lane);
  const bool all = k0 >= N;
  if (all) k0 = 0;
  uint64_t bits = key_bits(mrow, k0, N, lane);
  tf32_mma::prefetch<2, KT, FTHREADS>(raw, kv, k0, N, tid);

  // Q through the k and v planes, free until the first tile: big rows from
  // kb on, small rows from vb on; then each warp's A fragments (row g, col
  // t) etc. into registers.
  tf32_mma::stage<FQ, FTHREADS, FLD>(kb, vb, q + size_t(bh) * N * D, q0, N, tid);
  __syncthreads();
  uint32_t qb[D / 8][4], qs[D / 8][4];
  {
    const int a_lo = (16 * warp + g) * FLD + t, a_hi = a_lo + 8 * FLD;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = 8 * kk;
      qb[kk][0] = lds(kb + a_lo + c), qb[kk][1] = lds(kb + a_hi + c);
      qb[kk][2] = lds(kb + a_lo + c + 4), qb[kk][3] = lds(kb + a_hi + c + 4);
      qs[kk][0] = lds(vb + a_lo + c), qs[kk][1] = lds(vb + a_hi + c);
      qs[kk][2] = lds(vb + a_lo + c + 4), qs[kk][3] = lds(vb + a_hi + c + 4);
    }
  }

  float o[8][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
  while (k0 < N) {
    const int kn = all ? k0 + KT : first_real(mrow, k0 + KT, N, lane);
    const uint64_t bits_next = kn < N ? key_bits(mrow, kn, N, lane) : 0;
    tf32_mma::prefetch_wait();
    __syncthreads();  // tile k0 landed for everyone; Q's or the last tile's planes are read
    tf32_mma::stage<KT, FTHREADS, FLD>(kb, ks, raw, 0, KT, tid);
    tf32_mma::stage<KT, FTHREADS, FLD>(vb, vs, raw + KT * D, 0, KT, tid);
    __syncthreads();
    tf32_mma::prefetch<2, KT, FTHREADS>(raw, kv, kn, N, tid);  // under this tile's products
    float s[8][4];
    tf32_mma::mm_rows_reg<FLD, 8>(s, qb, qs, kb, ks, 0, lane);
    online_softmax(s, o, m_run, l_run, bits, k0, N, t);
    tf32_mma::mm_acc<FLD, 8>(o, s, vb, vs, 0, lane);
    k0 = kn;
    bits = bits_next;
  }
  store_rows(out, stats, o, m_run, l_run, b, h, heads, N, q0 + 16 * warp, merged, lane);
}

// q, k, v: (B, heads, N, 64), 16-byte aligned; mask: (B, N) bytes, nonzero
// = real key; out: (B, heads, N, 64), or (B, N, heads*64) when merged;
// stats: null, or (2, B, heads, N) f32 for m and 1 / l.
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* mask,
                   void* out, float* stats, int B, int heads, int N, int kv_xor, int merged,
                   cudaStream_t stream) {
  const T* qt = reinterpret_cast<const T*>(q);
  const T* kt = reinterpret_cast<const T*>(k);
  const T* vt = reinterpret_cast<const T*>(v);
  T* ot = reinterpret_cast<T*>(out);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_bf16_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, B_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + BQ - 1) / BQ, B * heads);
    attn_fwd_bf16_kernel<T><<<grid, BTHREADS, B_SMEM, stream>>>(qt, kt, vt, mask, ot, stats,
                                                                heads, N, kv_xor, merged);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_f32_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + FQ - 1) / FQ, B * heads);
    attn_fwd_f32_kernel<T><<<grid, FTHREADS, F_SMEM, stream>>>(qt, kt, vt, mask, ot, stats,
                                                               heads, N, kv_xor, merged);
  }
  return cudaGetLastError();
}

}  // namespace ssl_attn
