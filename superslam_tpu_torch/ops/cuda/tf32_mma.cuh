// 3xTF32 on the tensor cores: f32-accurate tile products with mma.sync
// m16n8k8 (tf32 in, f32 accumulate), shared by the attention forward in f32
// (attention.cuh) and the attention backward (attention_bwd.cu).
//
// Each operand x is split into big = tf32(x) and small = tf32(x - big)
// (cvt.rna.tf32.f32) and a product is big*big + big*small + small*big,
// about f32's accuracy (one TF32 product keeps three digits). Staged tiles
// are split once, on their way into shared memory (big and small planes of
// pitch LD floats side by side); register operands are split where they
// are made. A bf16 input is exact in TF32 (its small part is 0).
//
// Fragment layouts (g = lane / 4, t = lane % 4): the m16n8 accumulator
// holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), the m16n8k8 A fragment
// (g, t), (g+8, t), (g, t+4), (g+8, t+4), B (k = t, n = g), (t + 4, g).
// mm_acc permutes k within each 8-step (slot t is column 2t, slot t + 4
// column 2t + 1) so that a lane's accumulators of one product are its A
// fragment of the next as they stand: no shuffles, no staging tile. At a
// pitch of 68 floats both read patterns, (row g, col t) and (row 2t (+1),
// col g), hit 32 distinct banks (attention.py's bwd_layout and fwd_layout
// model them; the CPU tests prove it).
#pragma once

#include "common.cuh"

namespace tf32_mma {

constexpr int D = 64;  // the head dimension: columns of every staged row

__device__ __forceinline__ float tf32_big(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// c (16 x 8) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col).
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 3xTF32: c += (ab + as)(bb + bs) less the small x small term.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                     uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as[0], as[1], as[2], as[3], bb0, bb1);
  mma_tf32(c, ab[0], ab[1], ab[2], ab[3], bs0, bs1);
  mma_tf32(c, ab[0], ab[1], ab[2], ab[3], bb0, bb1);
}

__device__ __forceinline__ uint32_t lds(const float* p) { return __float_as_uint(*p); }

// 4 elements from global or shared memory, as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void split_store(float* big, float* small, int at, float4 v) {
  const float4 hb = make_float4(tf32_big(v.x), tf32_big(v.y), tf32_big(v.z), tf32_big(v.w));
  *reinterpret_cast<float4*>(big + at) = hb;
  *reinterpret_cast<float4*>(small + at) = make_float4(
      tf32_big(v.x - hb.x), tf32_big(v.y - hb.y), tf32_big(v.z - hb.z), tf32_big(v.w - hb.w));
}

// Rows r0 .. r0 + ROWS of src (N x 64, global or a raw staging buffer)
// into big and small planes of pitch LD, zero past N. Thread i of a round
// takes the 4-element chunk i & 15 of row i >> 4.
template <int ROWS, int NTHREADS, int LD, typename T>
__device__ __forceinline__ void stage(float* big, float* small, const T* src, int r0, int N,
                                      int tid) {
  for (int i = tid; i < ROWS * 16; i += NTHREADS) {
    const int r = i >> 4, c = (i & 15) * 4;
    const float4 v = r0 + r < N ? load4(src + size_t(r0 + r) * D + c) : make_float4(0, 0, 0, 0);
    split_store(big, small, r * LD + c, v);
  }
}

// Rows r0 .. r0 + ROWS of NT tensors (src[t], N x 64) into a raw staging
// buffer (NT x ROWS x 64 elements of T, unpadded) by cp.async, 4 elements
// a copy, zero-filled past N; nothing when r0 >= N. One commit group a call.
template <int NT, int ROWS, int NTHREADS, typename T>
__device__ __forceinline__ void prefetch(T* raw, const T* const (&src)[NT], int r0, int N,
                                         int tid) {
  for (int i = tid; r0 < N && i < ROWS * 16; i += NTHREADS) {
    const int r = i >> 4, c = (i & 15) * 4;
    const bool in = r0 + r < N;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const uint32_t dst = uint32_t(__cvta_generic_to_shared(raw + (t * ROWS + r) * D + c));
      const T* from = in ? src[t] + size_t(r0 + r) * D + c : src[t];
      if constexpr (sizeof(T) == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(from),
                     "r"(in ? 16 : 0));
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(from),
                     "r"(in ? 8 : 0));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void prefetch_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// c[nt] = X[m0 .. m0+16, :] . Y[n0 + 8 nt .. n0 + 8 nt + 8, :]^T over the
// 64 columns (k = d), X and Y staged (big, small) at pitch LD. A: (row g,
// col t) and (g + 8, t + 4) etc.; B: (row g, col t): banks 4g + t at LD 68.
template <int LD, int NTC>
__device__ __forceinline__ void mm_rows(float (&c)[NTC][4], const float* xb, const float* xs,
                                        int m0, const float* yb, const float* ys, int n0,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int a_lo = (m0 + g) * LD + t, a_hi = a_lo + 8 * LD;
#pragma unroll
  for (int nt = 0; nt < NTC; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 8) {
    const uint32_t ab[4] = {lds(xb + a_lo + k0), lds(xb + a_hi + k0), lds(xb + a_lo + k0 + 4),
                            lds(xb + a_hi + k0 + 4)};
    const uint32_t as[4] = {lds(xs + a_lo + k0), lds(xs + a_hi + k0), lds(xs + a_lo + k0 + 4),
                            lds(xs + a_hi + k0 + 4)};
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt) {
      const int bi = (n0 + 8 * nt + g) * LD + t + k0;
      mma3(c[nt], ab, as, lds(yb + bi), lds(yb + bi + 4), lds(ys + bi), lds(ys + bi + 4));
    }
  }
}

// The same with X's A fragments held in registers (ab[kk], as[kk]: the
// fragment of columns 8 kk .. 8 kk + 8, loaded once by the caller).
template <int LD, int NTC>
__device__ __forceinline__ void mm_rows_reg(float (&c)[NTC][4], const uint32_t (&ab)[D / 8][4],
                                            const uint32_t (&as)[D / 8][4], const float* yb,
                                            const float* ys, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NTC; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt) {
      const int bi = (n0 + 8 * nt + g) * LD + t + 8 * kk;
      mma3(c[nt], ab[kk], as[kk], lds(yb + bi), lds(yb + bi + 4), lds(ys + bi), lds(ys + bi + 4));
    }
  }
}

// acc[nt] += P . Z[n0 .. n0 + 8 NTC, 8 nt .. 8 nt + 8], P (16 x 8 NTC) the
// warp's accumulators of an S-type product (register A operand), Z staged
// (big, small) at pitch LD. k is permuted within each 8-step: slot t is
// column 2t, slot t + 4 column 2t + 1, so A = (p0, p2, p1, p3) of the lane
// as it stands and B reads Z rows n0 + 8 kk + 2t and + 1 at column 8 nt + g:
// banks 8t + g (+ 4) at LD 68.
template <int LD, int NTC>
__device__ __forceinline__ void mm_acc(float (&acc)[8][4], const float (&p)[NTC][4],
                                       const float* zb, const float* zs, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NTC; ++kk) {
    uint32_t ab[4], as[4];
    const float pv[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float hb = tf32_big(pv[e]);
      ab[e] = __float_as_uint(hb);
      as[e] = __float_as_uint(tf32_big(pv[e] - hb));
    }
    const int row = (n0 + 8 * kk + 2 * t) * LD + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int bi = row + 8 * nt;
      mma3(acc[nt], ab, as, lds(zb + bi), lds(zb + bi + LD), lds(zs + bi), lds(zs + bi + LD));
    }
  }
}

}  // namespace tf32_mma
