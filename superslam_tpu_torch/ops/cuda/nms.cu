// nms: keep s where s equals the (2r+1) x (2r+1) window max, else 0; and the
// same from SuperPoint's detector logits in one pass.
//
// Replaces superslam_tpu/ops/pallas/nms.py::nms_suppress (_nms_kernel) and,
// in logits mode, what superslam_tpu/models/superpoint.py::superpoint_dense
// composes before it (:236-240): the softmax over the 65 detector channels,
// the dustbin dropped, the depth-to-space of each cell's 64 probabilities
// (channel cy * 8 + cx -> pixel (8y + cy, 8x + cx)). Zero padding outside
// the map, ties keep their score; probabilities are >= 0, so zero padding
// equals the -inf padding of a max pool.
//
// Two modes, one tile and one suppression:
// - map mode (ssl_nms): s (B, H, W) f32 -> out;
// - logits mode (ssl_scores_nms): logits (B, h, w, 65) f32, NHWC (the
//   channels_last (B, 65, h, w) tensor the detector head gives) -> pre, the
//   probability map (B, 8h, 8w), skipped when null, and out, its NMS.
//
// Bound on the H100: bytes. At the serving shape (2 x 48 x 156 cells) the
// logits are 3.9 MB and each map 3.8 MB: 11.6 MB, ~3.5 us at 3.35 TB/s;
// ~1 M exponentials and the 2 x 9 compares a pixel are far below the f32
// rate. The composition this replaces ran a softmax over a non-last
// dimension of a strided view, a slice and depth-to-space copies and a
// separate NMS launch that read the map back.
// What the design does about it: a block owns TCY x TCX cells and stages
// them with a ring of one cell (the halo of radius <= 8 is one cell). Each
// staged row of cells is one contiguous span of (TCX + 2) x 65 floats in
// NHWC, read coalesced into shared memory; one warp then takes one cell:
// lanes take channels lane and lane + 32, every lane the dustbin, max and
// sum by a fixed shuffle butterfly, expf (not __expf) and an IEEE divide,
// and the 64 probabilities go by depth-to-space straight into the staged
// pixel tile. One device function and one reduction order for every block:
// a ring cell is bit for bit its own tile's interior cell, so s == max
// decides the same way on both sides of a seam. Cells outside the map stage
// as zero probability. Then the separable max: a row pass into a second
// tile (which reuses the logits' space), a column pass four pixels a thread,
// and 16-byte stores of pre and out where the rows are 16-byte aligned
// (always in logits mode, where W = 8w). The pixel tile's pitch is 8 mod 16
// floats, so a warp's depth-to-space stores (4 rows x 8 pixels) and both
// max passes are free of bank conflicts (tests/test_torch_nms_model.py
// proves it and models the block decomposition in numpy).
#include "common.cuh"

namespace {

constexpr int CELL = 8;  // pixels a cell side; the halo is one cell: radius <= 8
constexpr int NCH = 65;  // detector channels: the cell's 64 pixels and the dustbin
constexpr int TCY = 4;
constexpr int TCX = 8;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TH = TCY * CELL;  // a block's output tile, pixels
constexpr int TW = TCX * CELL;
constexpr int SCY = TCY + 2;  // staged cells, with the ring
constexpr int SCX = TCX + 2;
constexpr int SH = SCY * CELL;  // staged pixel tile
constexpr int SW = SCX * CELL;
constexpr int XP = SW + 8 - SW % 16;  // its pitch, 8 mod 16 floats
constexpr int SPAN = SCX * NCH;  // floats of one staged row of cells' logits
constexpr int X_FLOATS = SH * XP;  // the pixel tile
constexpr int L_FLOATS = SCY * SPAN;  // the logits tile, later the row-max tile
constexpr int SMEM_BYTES = (X_FLOATS + L_FLOATS) * 4;
static_assert(SH * TW <= L_FLOATS, "the row-max tile (pitch TW) fits the logits' space");
static_assert(TW % 32 == 0 && XP % 4 == 0 && X_FLOATS % 4 == 0, "float4 alignment");

// One cell's 65 logits l (shared memory) -> its 64 probabilities at x, the
// cell's corner in the staged pixel tile; one warp, every lane. A cell
// outside the map gets zeros.
__device__ __forceinline__ void cell_softmax(const float* l, float* x, bool inside, int lane) {
  float pa = 0.0f, pb = 0.0f;
  if (inside) {  // warp-uniform
    const float a = l[lane], b = l[lane + 32], d = l[64];
    float m = fmaxf(a, b);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    m = fmaxf(m, d);
    const float ea = expf(a - m), eb = expf(b - m);
    float s = ea + eb;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    s += expf(d - m);
    pa = ea / s;
    pb = eb / s;
  }
  const int cy = lane >> 3, cx = lane & 7;  // channel lane = cy * 8 + cx
  x[cy * XP + cx] = pa;
  x[(cy + 4) * XP + cx] = pb;
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

__device__ __forceinline__ float keep(float v, float m) { return v == m ? v : 0.0f; }

// The staged tile x_s (SH x XP) -> out (and pre) of the block's TH x TW
// pixels at (y0, x0); h_s takes the row maxima (SH x TW).
__device__ __forceinline__ void suppress(const float* x_s, float* h_s, float* __restrict__ pre,
                                         float* __restrict__ out, int b, int H, int W, int y0,
                                         int x0, int radius) {
  const int tid = threadIdx.x;
  // Row pass over the staged rows the column pass reads.
  const int r0 = CELL - radius;
  for (int i = tid; i < (TH + 2 * radius) * TW; i += NTHREADS) {
    const int r = r0 + i / TW, c = i % TW;
    const float* p = x_s + r * XP + c + CELL - radius;
    float m = p[0];
    for (int d = 1; d <= 2 * radius; ++d) m = fmaxf(m, p[d]);
    h_s[r * TW + c] = m;
  }
  __syncthreads();
  // Column pass, compare and stores, four pixels a thread.
  for (int i = tid; i < TH * TW / 4; i += NTHREADS) {
    const int r = i / (TW / 4), c = (i % (TW / 4)) * 4;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    const float4* hp = reinterpret_cast<const float4*>(h_s + (r0 + r) * TW + c);
    float4 m = hp[0];
    for (int d = 1; d <= 2 * radius; ++d) m = max4(m, hp[d * (TW / 4)]);
    const float4 v = *reinterpret_cast<const float4*>(x_s + (r + CELL) * XP + c + CELL);
    const float4 o = make_float4(keep(v.x, m.x), keep(v.y, m.y), keep(v.z, m.z), keep(v.w, m.w));
    const size_t at = (size_t(b) * H + gy) * W + gx;
    if (W % 4 == 0) {  // 16-byte rows, and gx % 4 == 0: all four pixels lie in the map
      *reinterpret_cast<float4*>(out + at) = o;
      if (pre) *reinterpret_cast<float4*>(pre + at) = v;
    } else {
      const float ov[4] = {o.x, o.y, o.z, o.w}, vv[4] = {v.x, v.y, v.z, v.w};
      for (int k = 0; k < 4 && gx + k < W; ++k) {
        out[at + k] = ov[k];
        if (pre) pre[at + k] = vv[k];
      }
    }
  }
}

// LOGITS: src is the (B, H / 8, W / 8, 65) logits; else the (B, H, W) map.
template <bool LOGITS>
__global__ void __launch_bounds__(NTHREADS)
    nms_tile_kernel(const float* __restrict__ src, float* __restrict__ pre,
                    float* __restrict__ out, int H, int W, int radius) {
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);
  float* l_s = x_s + X_FLOATS;  // the logits tile, then the row maxima
  const int tid = threadIdx.x, b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  if (LOGITS) {
    const int h = H / CELL, w = W / CELL;
    const int cy0 = blockIdx.y * TCY - 1, cx0 = blockIdx.x * TCX - 1;
    // The staged cells of a row that lie in the map are one contiguous run
    // of the row's span: floats [lo, hi).
    const int lo = cx0 < 0 ? NCH : 0, hi = min(SPAN, (w - cx0) * NCH);
    for (int r = 0; r < SCY; ++r) {
      const int gy = cy0 + r;
      if (gy < 0 || gy >= h) continue;
      const float* row = src + ((ptrdiff_t(b) * h + gy) * w + cx0) * NCH;  // cx0 may be -1
      for (int o = lo + tid; o < hi; o += NTHREADS) l_s[r * SPAN + o] = row[o];
    }
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    for (int q = warp; q < SCY * SCX; q += NWARPS) {
      const int r = q / SCX, c = q - r * SCX;
      const int gy = cy0 + r, gx = cx0 + c;
      cell_softmax(l_s + q * NCH, x_s + r * CELL * XP + c * CELL,
                   gy >= 0 && gy < h && gx >= 0 && gx < w, lane);
    }
  } else {
    const float* map = src + size_t(b) * H * W;
    for (int i = tid; i < X_FLOATS; i += NTHREADS) {
      const int r = i / XP, c = i - r * XP;
      const int gy = y0 - CELL + r, gx = x0 - CELL + c;
      if (c < SW)
        x_s[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? map[size_t(gy) * W + gx] : 0.0f;
    }
  }
  __syncthreads();
  suppress(x_s, l_s, pre, out, b, H, W, y0, x0, radius);
}

template <bool LOGITS>
int launch(const float* src, float* pre, float* out, int B, int H, int W, int radius,
           void* stream) {
  if (radius < 0 || radius > CELL || B < 1 || H < 1 || W < 1) return int(cudaErrorInvalidValue);
  auto kernel = nms_tile_kernel<LOGITS>;
  if (SMEM_BYTES > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return int(err);
  }
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NTHREADS, SMEM_BYTES, reinterpret_cast<cudaStream_t>(stream)>>>(src, pre, out,
                                                                                 H, W, radius);
  return int(cudaGetLastError());
}

}  // namespace

// s, out: f32 (B, H, W); 0 <= radius <= 8.
SSL_EXPORT int ssl_nms(const float* s, float* out, int B, int H, int W, int radius,
                       void* stream) {
  return launch<false>(s, nullptr, out, B, H, W, radius, stream);
}

// logits: f32 (B, h, w, 65); pre (or null), out: f32 (B, 8h, 8w); 0 <= radius <= 8.
SSL_EXPORT int ssl_scores_nms(const float* logits, float* pre, float* out, int B, int h, int w,
                              int radius, void* stream) {
  return launch<true>(logits, pre, out, B, h * CELL, w * CELL, radius, stream);
}
