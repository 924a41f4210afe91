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
// ~1.5 us either way at the bf16 tensor-core rate and the HBM rate.
// What the design does about it: flash-style, so the N x N logits never
// reach device memory, with both products on the tensor cores in bf16
// (WMMA; the kernels are in attention.cuh, shared with the fused LightGlue
// blocks, whose header describes them). wgmma with TMA-fed tiles and
// register-resident softmax is later work (ROADMAP queue 2).
#include "attention.cuh"

// q, k, v, out: (B, heads, N, 64), bf16 if is_bf16 else f32; mask: (B, N)
// bytes, nonzero = real key; stats: null, or (2, B, heads, N) f32 that
// receives each query row's softmax maximum and 1 / sum (the backward's
// residuals).
SSL_EXPORT int ssl_masked_attention(const void* q, const void* k, const void* v,
                                    const uint8_t* mask, void* out, float* stats, int B,
                                    int heads, int N, int is_bf16, void* stream) {
  if (B < 1 || heads < 1 || N < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return int(is_bf16
                 ? ssl_attn::launch<__nv_bfloat16>(q, k, v, mask, out, stats, B, heads, N, 0, 0, s)
                 : ssl_attn::launch<float>(q, k, v, mask, out, stats, B, heads, N, 0, 0, s));
}
