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
// Bound on the H100: operations. LightGlue's serving calls are (4, 4, 600,
// 64) bf16: 4*B*H*N*keys*D = 1.47 GFLOP over all keys against 4.9 MB of q,
// k, v and output, ~1.5 us either way at the bf16 tensor-core rate and the
// HBM rate. The training calls are (16, 4, 256, 64) f32: the two products,
// f32-accurate, are three TF32 products each (3xTF32) on the tensor cores,
// ~2.1 GFLOP of TF32 over the real keys. What the design does about it
// (the kernels are in attention.cuh, shared with the fused LightGlue
// blocks, whose header describes them): flash-style, so the N x N logits
// never reach device memory; both products on mma.sync with the softmax,
// the running statistics and the output accumulators in registers; the
// next key tile copied by cp.async under the current one's products; key
// tiles without a real key skipped.
#include "attention.cuh"

// q, k, v, out: (B, heads, N, 64), bf16 if is_bf16 else f32, 16-byte
// aligned; mask: (B, N) bytes, nonzero = real key; stats: null, or (2, B,
// heads, N) f32 that receives each query row's softmax maximum and 1 / sum
// (the backward's residuals).
SSL_EXPORT int ssl_masked_attention(const void* q, const void* k, const void* v,
                                    const uint8_t* mask, void* out, float* stats, int B,
                                    int heads, int N, int is_bf16, void* stream) {
  if (B < 1 || heads < 1 || N < 1) return int(cudaErrorInvalidValue);
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (any % 16 != 0) return int(cudaErrorMisalignedAddress);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return int(is_bf16
                 ? ssl_attn::launch<__nv_bfloat16>(q, k, v, mask, out, stats, B, heads, N, 0, 0, s)
                 : ssl_attn::launch<float>(q, k, v, mask, out, stats, B, heads, N, 0, 0, s));
}
