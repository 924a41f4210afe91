// The tensor-core engine of the port's 3x3 convs over 64-channel NHWC tiles
// in shared memory: warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate)
// fed by ldmatrix.x4 from XOR-swizzled tiles, and the cp.async copies that
// fill the tiles and the weight ring. Its users are conv_pair_mma.cu, both
// conv pairs of SuperPoint's encoder, and conv3x3_mma.cu, the single conv;
// the bf16 attention forward (attention.cuh) and the fused LightGlue
// blocks' linears (lightglue_layer.cu) use its primitives (swz for 128-byte
// rows, cp_async16, ldsm_x4, ldsm_x4_trans, mma_bf16). The address model
// it implements is mirrored by
// superslam_tpu_torch/ops/cuda/conv.py::mma_layout, which
// tests/test_torch_conv_layout.py enumerates on the CPU.
//
// Tile layout: a pixel is 64 bf16 channels = 8 chunks of 16 bytes at a
// pitch of 128 bytes; chunk j of pixel p is stored at chunk j ^ (p & 7)
// (swz). An ldmatrix phase reads one chunk of 8 consecutive pixels (8 rows
// of a flat run at one tap), which the swizzle spreads over all 32 banks
// whatever the tap's pixel offset. A weight slice of the ring is 32 (or 64)
// output channels x 64 input channels, one 128-byte row per output channel
// (the B operand "col"-major, as mma.sync wants it), swizzled the same way
// by row.
#pragma once

#include "common.cuh"

namespace conv_mma {

constexpr int CH = 64;                            // channels of every tile pixel
constexpr int PIX_BYTES = CH * 2;                 // 128
constexpr int SLICE_CO = 32;                      // output channels of one ring slice
constexpr int SLICE_BYTES = SLICE_CO * PIX_BYTES;  // 4,096

// Byte offset of 16-byte chunk j (channels 8j..8j+7) of tile pixel (or
// weight row) p.
__device__ __forceinline__ uint32_t swz(int p, int j) {
  return uint32_t(p) * PIX_BYTES + (uint32_t((j ^ p) & 7) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; valid = false zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared (for rows that start off 16-byte alignment);
// valid = false zero-fills.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// The same, each 8 x 8 matrix transposed: lane l receives (row 2 (l % 4),
// column l / 4) and (row 2 (l % 4) + 1, column l / 4), the B fragment of a
// row-major (k, n) tile.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, col-major).
// Lane l holds c rows l/4 and l/4 + 8, columns 2*(l%4) + {0, 1}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One tap of one ring slice for the runs of one warp:
//   acc[r][nt] += tile[run_r * 16 + tap_off + i, :] x slice[nt * 8 + n, :]^T
// over the 64 input channels, for run_r = run0 + r * run_stride, r < nrun
// (warp-uniform), i < 16 the GEMM row, n < 8 the column of n-tile nt < NT
// (the slice has 8 * NT weight rows).
// A: lane l points ldmatrix at pixel run*16 + tap_off + (l & 15), chunk
// 2*ks + (l >> 4): the four 8 x 8 matrices are a0..a3 of the m16k16 fragment.
// B: lane l points at slice row 16*h + 8*(l >> 4) + (l & 7), chunk 2*ks +
// ((l >> 3) & 1): b0, b1 of n-tile 2h, then of n-tile 2h + 1.
template <int MAXR, int NT>
__device__ __forceinline__ void tap_step(float (&acc)[MAXR][NT][4], uint32_t tile, int run0,
                                         int run_stride, int nrun, int tap_off, uint32_t slice,
                                         int lane) {
  uint32_t arow[MAXR], axor[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int p = (run0 + r * run_stride) * 16 + tap_off + (lane & 15);
    arow[r] = tile + uint32_t(p) * PIX_BYTES;
    axor[r] = uint32_t((p ^ (lane >> 4)) & 7);
  }
  const int brow = 8 * (lane >> 4) + (lane & 7);
  const uint32_t bbase = slice + uint32_t(brow) * PIX_BYTES;
  const uint32_t bxor = uint32_t((brow ^ ((lane >> 3) & 1)) & 7);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t b[NT / 2][4];
#pragma unroll
    for (int h = 0; h < NT / 2; ++h)
      ldsm_x4(bbase + h * 16 * PIX_BYTES + ((bxor ^ (2 * ks)) << 4), b[h]);
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < nrun) {
        uint32_t a[4];
        ldsm_x4(arow[r] + ((axor[r] ^ (2 * ks)) << 4), a);
#pragma unroll
        for (int h = 0; h < NT / 2; ++h) {
          mma_bf16(acc[r][2 * h], a, b[h][0], b[h][1]);
          mma_bf16(acc[r][2 * h + 1], a, b[h][2], b[h][3]);
        }
      }
    }
  }
}

}  // namespace conv_mma
