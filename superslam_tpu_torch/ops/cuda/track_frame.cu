// track_frame: the whole per-frame body of the device tracking scans in one
// launch: the constant-velocity prediction, the pose solve of
// pose_solve.cuh, the acceptance, the carry update and, for the scan with
// the keyframe in its carry, the keyframe gate and the promotion.
//
// Replaces what the JAX package runs as XLA in the step of each of its two
// tracking scans (superslam_tpu/ops/frontend_step.py):
// - track_kf_scan's step (:719-849; KF = true): the prediction, the solve
//   (_frame_solve :381), the support count and the acceptance (:782-793),
//   the carry (:795-798), the keyframe gate (:800-809) and the promotion
//   (:811-823);
// - track_scan's step (:539-580; KF = false): the prediction, the solve,
//   coast below min_matches and the carry, a 13-column row; for Q
//   sequences at once (parallel/batched_tracking.py::batched_track_scan,
//   the JAX package's vmap of track_scan) one block a sequence in a grid of
//   Q (ssl_track_frame_batched): the card's other SMs take the other
//   sequences' chains, so Q frames cost about one frame's latency.
// Its plain twin is ops/cuda/track_frame.py::track_frame_plain.
//
// In the JAX step's order, on rank 0's block of THREADS threads:
// - R_pred = R_prev Rr, t_pred = R_prev tr + t_prev (every thread: the
//   solve keeps its poses in every thread's registers);
// - the solve (pose_solve.cuh), from (R_prev, t_prev), gated at the
//   prediction;
// - KF: support = #(ok & z > 0.1 & reprojection < support_px) at the solve
//   and nref = max(#kf_depth_ok, 1), by ballots and one block reduction;
// - on one thread, once a frame: finite, accept (KF: n >= min_matches,
//   finite, support >= max(accept_frac n, min_matches); scan: n >=
//   min_matches), the select with the prediction, Gram-Schmidt (its 1e-20,
//   and a select that drops the other side's NaN as torch.where does), the
//   new Rr and tr, and for KF the gate on since + 1, n and n / nref, promo,
//   the new since and the hybrid's fresh bit; the row of TRACK_KF_COLS or
//   TRACK_COLS.
// - KF: the new keyframe state (nk, desc, valid, xw, depth_ok) into fresh
//   buffers: the frame's features, their world points Xw = R_new Xc +
//   t_new from the disparity, where promo is set; the old keyframe's where
//   it is not.
//
// Bound on the H100: latency. The solve reads ~20 KB; the promotion reads
// and writes the keyframe state (600 x 256 f32 descriptors: 0.61 MB each
// way, ~0.4 us at 3.35 TB/s); the arithmetic, ~2 M f32 operations a frame,
// is ~0.03 us at 67 TFLOP/s. What a frame pays is the solve's chain of up
// to 60 dependent LM iterations on one SM, each one pass over the points,
// one block reduction with one barrier, and a 6 x 6 LU and an SE(3)
// exponential that every thread runs on the same bits (pose_solve.cuh):
// ~2.6 us an iteration on an H100, against ~110 launches of small
// PyTorch ops it replaces. The copy is kept off that chain: the KF kernel is a cluster of
// CLUSTER blocks. Rank 0 solves. Ranks 1.. copy the old keyframe into the
// new buffers while it does (the state of most frames), each its own share,
// then wait at the cluster barrier for rank 0's decision, read promo, R_new
// and t_new from rank 0's shared memory (distributed shared memory) and,
// when promo is set, overwrite the same share with the frame's features. A
// rank rewrites only what it wrote itself, so program order keeps the last
// write. One block alone would copy at the rate of its own loads in
// flight: ~10-30 us for 1.2 MB; seven copy at seven SMs' rate.
//
// Arithmetic is f32, as in the JAX program; the 3 x 3 algebra and the
// comparisons follow the PyTorch twin's operations, so with the same solve
// the counts and bits agree exactly and the poses to rounding.
#include <cooperative_groups.h>

#include "pose_solve.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pose;

constexpr int CLUSTER = 8;  // rank 0 solves, ranks 1..7 copy the keyframe state

struct Gate {
  float accept_frac, support_px, covis_ratio, fxb;  // fxb = fx * baseline
  int kf_min_frames, kf_max_frames, kf_min_matches;
};

// What rank 0 decides and the copying ranks read.
struct Decision {
  float Rt[12];  // R_new row-major, t_new
  int promo;
};

struct KfIn {
  const float* nkl;  // the frame: (K, 2) normalized keypoints
  const uint8_t* dl;  // (K, D) descriptors, desc_bytes in all
  const uint8_t* vl;  // (K,)
  const float* nk;    // the keyframe
  const uint8_t* desc;
  const uint8_t* valid;
  const float* xw;
  const uint8_t* dok;
  const int* since;
  const uint8_t* fresh;  // null: the entry keyframe
};

struct KfOut {
  float* nk;
  uint8_t* desc;
  uint8_t* valid;
  float* xw;
  uint8_t* dok;
  uint8_t* fresh;
};

// track_scan mode over Q sequences in one grid (the JAX package's vmap of
// track_scan, superslam_tpu/parallel/batched_tracking.py:80-117): block q
// reads sequence q's carry, frame and keyframe rows and writes its own row,
// carry and stats, each at its elements' stride. A single launch has Q = 1
// and its strides are never applied.
struct SeqStrides {
  long long carry, kl, disp, stereo_ok, tm, kf_xw, kf_dok, row, small, stats;
};

// C = A B, 3 x 3 row-major.
__device__ __forceinline__ void mat3_mul(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// y = A x (tr = false) or A^T x (tr = true).
__device__ __forceinline__ void mat3_vec(const float* A, const float* x, float* y, bool tr) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = tr ? A[i] * x[0] + A[3 + i] * x[1] + A[6 + i] * x[2]
              : A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}

// frontend_step's _reorthonormalize: Gram-Schmidt on the columns.
__device__ __forceinline__ void reorthonormalize(const float* R, float* out) {
  float c0[3] = {R[0], R[3], R[6]}, r1[3] = {R[1], R[4], R[7]}, c1[3];
  const float n0 = sqrtf(c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2] + 1e-20f);
#pragma unroll
  for (int i = 0; i < 3; ++i) c0[i] = c0[i] / n0;
  const float d = c0[0] * r1[0] + c0[1] * r1[1] + c0[2] * r1[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) c1[i] = r1[i] - d * c0[i];
  const float n1 = sqrtf(c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2] + 1e-20f);
#pragma unroll
  for (int i = 0; i < 3; ++i) c1[i] = c1[i] / n1;
  const float c2[3] = {c0[1] * c1[2] - c0[2] * c1[1], c0[2] * c1[0] - c0[0] * c1[2],
                       c0[0] * c1[1] - c0[1] * c1[0]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[3 * i] = c0[i];
    out[3 * i + 1] = c1[i];
    out[3 * i + 2] = c2[i];
  }
}

// A copying rank's share of the keyframe state: from the frame (promo) or
// from the old keyframe. worker / workers split every array the same way
// in both passes.
__device__ void copy_state(const Params& q, const KfIn& in, const KfOut& out, int desc_bytes,
                           bool promo, int worker, int workers) {
  const int first = worker * THREADS + threadIdx.x, stride = workers * THREADS;
  const uint8_t* src = promo ? in.dl : in.desc;
  // One split for both passes: 16-byte vectors only when every buffer takes them.
  const uintptr_t addr = reinterpret_cast<uintptr_t>(in.dl) |
                         reinterpret_cast<uintptr_t>(in.desc) |
                         reinterpret_cast<uintptr_t>(out.desc);
  const bool vec = (addr & 15) == 0 && desc_bytes % 16 == 0;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(out.desc);
    const int n = desc_bytes / 16;
    constexpr int U = 8;  // 16-byte loads in flight a thread
    for (int base = first; base < n; base += U * stride) {
      uint4 r[U];
#pragma unroll
      for (int j = 0; j < U; ++j)
        if (base + j * stride < n) r[j] = s4[base + j * stride];
#pragma unroll
      for (int j = 0; j < U; ++j)
        if (base + j * stride < n) d4[base + j * stride] = r[j];
    }
  } else {
    for (int b = first; b < desc_bytes; b += stride) out.desc[b] = src[b];
  }
  for (int i = first; i < q.K; i += stride) {
    if (promo) {
      out.nk[2 * i] = in.nkl[2 * i];
      out.nk[2 * i + 1] = in.nkl[2 * i + 1];
      out.valid[i] = in.vl[i];
    } else {
      out.nk[2 * i] = in.nk[2 * i];
      out.nk[2 * i + 1] = in.nk[2 * i + 1];
      out.valid[i] = in.valid[i];
      out.dok[i] = in.dok[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) out.xw[3 * i + j] = in.xw[3 * i + j];
    }
  }
}

// The promoted world points and depth mask (the frame's disparity and
// keypoints, grounded through R_new, t_new); the frame's stereo_ok.
__device__ void promote_points(const Params& q, const Gate& g, const float* kl,
                               const float* disp, const uint8_t* stereo_ok, const KfOut& out,
                               const float* Rt, int worker, int workers) {
  const int first = worker * THREADS + threadIdx.x, stride = workers * THREADS;
  for (int i = first; i < q.K; i += stride) {
    const float z = g.fxb / clamp_min(disp[i], 1e-3f);
    const float x = (kl[2 * i] - q.cx) * z / q.fx;
    const float y = (kl[2 * i + 1] - q.cy) * z / q.fy;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out.xw[3 * i + j] = x * Rt[3 * j] + y * Rt[3 * j + 1] + z * Rt[3 * j + 2] + Rt[9 + j];
    out.dok[i] = stereo_ok[i];
  }
}

template <bool KF>
__global__ void __launch_bounds__(THREADS, 1)
    track_frame_kernel(Params q, Gate g, const float* __restrict__ carry_in,
                       const float* __restrict__ kl, const float* __restrict__ disp,
                       const uint8_t* __restrict__ stereo_ok, const int* __restrict__ tm,
                       const int* __restrict__ tm_rematch, const float* __restrict__ kf_xw,
                       const uint8_t* __restrict__ kf_dok, KfIn kin, int desc_bytes,
                       float* __restrict__ row, int* __restrict__ match_out,
                       float* __restrict__ small_out, int* __restrict__ stats_out, KfOut kout,
                       SeqStrides seq) {
  __shared__ Shared s;
  __shared__ Decision dec;
  if constexpr (!KF) {
    // This block's sequence (blockIdx.x = 0 for a single frame).
    const long long b = blockIdx.x;
    carry_in += b * seq.carry;
    kl += b * seq.kl;
    disp += b * seq.disp;
    stereo_ok += b * seq.stereo_ok;
    tm += b * seq.tm;
    kf_xw += b * seq.kf_xw;
    kf_dok += b * seq.kf_dok;
    row += b * seq.row;
    small_out += b * seq.small;
    stats_out += b * seq.stats;
  }
  if constexpr (KF) {
    // Copying ranks: the old keyframe now, the frame if promoted.
    auto cluster = cg::this_cluster();
    const int rank = int(cluster.block_rank());
    if (rank != 0) {
      copy_state(q, kin, kout, desc_bytes, false, rank - 1, CLUSTER - 1);
      cluster.sync();
      const Decision* d = cluster.map_shared_rank(&dec, 0);
      if (d->promo) {
        float Rt[12];
#pragma unroll
        for (int j = 0; j < 12; ++j) Rt[j] = d->Rt[j];
        copy_state(q, kin, kout, desc_bytes, true, rank - 1, CLUSTER - 1);
        promote_points(q, g, kl, disp, stereo_ok, kout, Rt, rank - 1, CLUSTER - 1);
      }
      cluster.sync();  // rank 0's shared memory stays until every rank has read it
      return;
    }
  }

  // The match each keyframe feature uses: the entry keyframe's batched
  // match while the carried keyframe is still that one (the hybrid's fresh
  // bit), else the re-match.
  const bool fresh = !KF || kin.fresh == nullptr || *kin.fresh;
  const int* use = (tm_rematch != nullptr && !fresh) ? tm_rematch : tm;
  Points pt;
  load_points(q, kl, disp, stereo_ok, use, kf_xw, kf_dok, pt);
  bool dok[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * THREADS;
    dok[k] = i < q.K && kf_dok[i];
    if (match_out != nullptr && i < q.K) match_out[i] = use[i];
  }
  // carry_in: R_prev (9, row-major), t_prev, Rr, tr; the poses in every
  // thread's registers.
  const float* Rp = carry_in;
  const float* tp = carry_in + 9;
  float P[12], pred[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) P[j] = carry_in[j];
  mat3_mul(Rp, carry_in + 12, pred);
  float v[3];
  mat3_vec(Rp, carry_in + 21, v, false);
#pragma unroll
  for (int i = 0; i < 3; ++i) pred[9 + i] = v[i] + tp[i];
  Reducer red{s, 0};
  const int n = red.count(pt.ok);
  const int nref = KF ? red.count(dok) : 0;
  const int kept = solve(q, pt, red, pred, P);
  int support = 0;
  if constexpr (KF) {
    bool sup[PPT];
    within(q, pt, P, g.support_px, sup);
    support = red.count(sup);
  }

  if (threadIdx.x == 0) {  // P: R_s row-major, t_s
    bool finite = true;
#pragma unroll
    for (int j = 0; j < 12; ++j) finite = finite && isfinite(P[j]);
    bool accept = n >= q.min_matches;
    if constexpr (KF) {
      accept = accept && finite;
      if (g.accept_frac > 0.f)
        accept = accept && float(support) >= clamp_min(g.accept_frac * float(n),
                                                        float(q.min_matches));
    }
    float Rsel[9], Rn[9], tn[3], Rr[9], tr[3], d[3];
#pragma unroll
    for (int j = 0; j < 9; ++j) Rsel[j] = accept ? P[j] : pred[j];
    reorthonormalize(Rsel, Rn);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      tn[j] = accept ? P[9 + j] : pred[9 + j];
      d[j] = tn[j] - tp[j];
    }
    // Rr = R_prev^T R_new, tr = R_prev^T (t_new - t_prev) when accepted.
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Rr[3 * i + j] = Rp[i] * Rn[j] + Rp[3 + i] * Rn[3 + j] + Rp[6 + i] * Rn[6 + j];
    mat3_vec(Rp, d, tr, true);
    // small_out: R_new, t_new, Rr, tr (the next frame's carry), R_s, t_s.
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      small_out[j] = Rn[j];
      small_out[12 + j] = accept ? Rr[j] : carry_in[12 + j];
      small_out[24 + j] = P[j];
      row[j] = Rn[j];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      small_out[9 + j] = tn[j];
      small_out[21 + j] = accept ? tr[j] : carry_in[21 + j];
      small_out[33 + j] = P[9 + j];
      row[9 + j] = tn[j];
    }
    row[12] = float(n);
    stats_out[0] = n;
    stats_out[1] = kept;
    if constexpr (KF) {
      const int since1 = *kin.since + 1;
      const bool ratio_low = float(n) < g.covis_ratio * float(nref > 1 ? nref : 1);
      const bool gate = since1 >= g.kf_min_frames &&
                        (since1 >= g.kf_max_frames || n < g.kf_min_matches || ratio_low);
      const bool promo = accept && gate;
      row[13] = float(support);
      row[14] = accept ? 1.f : 0.f;
      row[15] = promo ? 1.f : 0.f;
      stats_out[2] = promo ? 0 : since1;
      *kout.fresh = fresh && !promo;
#pragma unroll
      for (int j = 0; j < 9; ++j) dec.Rt[j] = Rn[j];
#pragma unroll
      for (int j = 0; j < 3; ++j) dec.Rt[9 + j] = tn[j];
      dec.promo = promo;
    }
  }
  if constexpr (KF) {
    auto cluster = cg::this_cluster();
    cluster.sync();  // the decision is out: the copying ranks read it
    cluster.sync();
  }
}

}  // namespace

// carry (24,) f32: R_prev (3, 3), t_prev (3,), Rr (3, 3), tr (3,); the
// frame's kl (K, 2) f32, disp (K,) f32, stereo_ok (K,) bool; tm (K,) int32
// (keyframe feature i -> frame keypoint, or -1); tm_rematch (K,) int32 or
// null: used instead of tm when *kf_fresh is false; kf_xw (K, 3) f32, kf_dok
// (K,) bool.
// keyframes = 0 (track_scan's body): nkl, dl, vl, the kf_ inputs other
// than xw and dok, since, kf_fresh and every out_kf_ pointer may be null;
// row (13,). keyframes = 1 (track_kf_scan's): the frame's nkl (K, 2) f32,
// dl (K, D) and vl (K,) bool; the keyframe's nk (K, 2) f32, desc (K, D) of
// dl's type (desc_bytes = K * D * its size), valid (K,) bool, since (int32);
// kf_fresh (bool, or null: the entry keyframe); row (16,); the new state into
// out_kf_nk, out_kf_desc, out_kf_valid, out_kf_xw, out_kf_dok, out_fresh.
// Out: match_out (K,) int32 (the match used, or null), small (36,) f32
// (R_new, t_new, Rr, tr, then the raw solve R_s, t_s), stats (3,) int32
// (n, kept, the new since). K <= 1024.
SSL_EXPORT int ssl_track_frame(
    const float* carry, const float* kl, const float* disp, const uint8_t* stereo_ok,
    const int* tm, const int* tm_rematch, const float* kf_xw, const uint8_t* kf_dok,
    const float* nkl, const void* dl, const uint8_t* vl, const float* kf_nk, const void* kf_desc,
    const uint8_t* kf_valid, const int* since, const uint8_t* kf_fresh, float* row,
    int* match_out, float* small, int* stats, float* out_kf_nk, void* out_kf_desc,
    uint8_t* out_kf_valid, float* out_kf_xw, uint8_t* out_kf_dok, uint8_t* out_fresh, int K,
    int desc_bytes, float fx, float fy, float cx, float cy, float baseline, int min_matches,
    float inv_sig_uLv, float disp_sigma0, float disp_cond, int mono, float gate_px,
    float chi2_px, int chi2_rounds, int track_iters, int keyframes, float accept_frac,
    float support_px, int kf_min_frames, int kf_max_frames, int kf_min_matches,
    float covis_ratio, float fx_baseline, void* stream) {
  if (K < 1 || K > KMAX || track_iters < 0 || chi2_rounds < 0 || desc_bytes < 0)
    return int(cudaErrorInvalidValue);
  const Params q{fx, fy, cx, cy, baseline, inv_sig_uLv, disp_sigma0, disp_cond, gate_px,
                 chi2_px, K, min_matches, mono, chi2_rounds, track_iters};
  const Gate g{accept_frac, support_px, covis_ratio, fx_baseline, kf_min_frames, kf_max_frames,
               kf_min_matches};
  const KfIn kin{nkl, static_cast<const uint8_t*>(dl), vl, kf_nk,
                 static_cast<const uint8_t*>(kf_desc), kf_valid, kf_xw, kf_dok, since, kf_fresh};
  const KfOut kout{out_kf_nk, static_cast<uint8_t*>(out_kf_desc), out_kf_valid, out_kf_xw,
                   out_kf_dok, out_fresh};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!keyframes) {
    track_frame_kernel<false><<<1, THREADS, 0, st>>>(q, g, carry, kl, disp, stereo_ok, tm,
                                                     tm_rematch, kf_xw, kf_dok, kin, desc_bytes,
                                                     row, match_out, small, stats, kout,
                                                     SeqStrides{});
    return int(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, track_frame_kernel<true>, q, g, carry, kl, disp, stereo_ok, tm,
                         tm_rematch, kf_xw, kf_dok, kin, desc_bytes, row, match_out, small, stats,
                         kout, SeqStrides{});
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

// track_scan's body for Q sequences in one grid of Q blocks (one frame
// index of batched_track_scan). Per sequence q, the arguments of
// ssl_track_frame with keyframes = 0 and no re-match or match_out, each at
// its own stride in elements: carry + q * carry_stride (24 f32: a previous
// call's small rows have stride 36), kl (K, 2), disp (K,), stereo_ok (K,),
// tm (K,), kf_xw (K, 3), kf_dok (K,), row (13,), small (36,), stats (3,).
// Rows within a sequence are contiguous. Q >= 1, K <= 1024.
SSL_EXPORT int ssl_track_frame_batched(
    int Q, const float* carry, long long carry_stride, const float* kl, long long kl_stride,
    const float* disp, long long disp_stride, const uint8_t* stereo_ok,
    long long stereo_ok_stride, const int* tm, long long tm_stride, const float* kf_xw,
    long long kf_xw_stride, const uint8_t* kf_dok, long long kf_dok_stride, float* row,
    long long row_stride, float* small, long long small_stride, int* stats,
    long long stats_stride, int K, float fx, float fy, float cx, float cy, float baseline,
    int min_matches, float inv_sig_uLv, float disp_sigma0, float disp_cond, int mono,
    float gate_px, float chi2_px, int chi2_rounds, int track_iters, void* stream) {
  if (Q < 1 || K < 1 || K > KMAX || track_iters < 0 || chi2_rounds < 0)
    return int(cudaErrorInvalidValue);
  const Params q{fx, fy, cx, cy, baseline, inv_sig_uLv, disp_sigma0, disp_cond, gate_px,
                 chi2_px, K, min_matches, mono, chi2_rounds, track_iters};
  const SeqStrides seq{carry_stride, kl_stride, disp_stride, stereo_ok_stride, tm_stride,
                       kf_xw_stride, kf_dok_stride, row_stride, small_stride, stats_stride};
  track_frame_kernel<false><<<Q, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      q, Gate{}, carry, kl, disp, stereo_ok, tm, nullptr, kf_xw, kf_dok, KfIn{}, 0, row, nullptr,
      small, stats, KfOut{}, seq);
  return int(cudaGetLastError());
}
