// Kernels 7 and 8's instances with features
// (csrc/flash_varlen_bwd_sm90.cuh, kFeat != 0; the varlen rules in
// csrc/attn_features.cuh): ALiBi, attention_chunk and dropout. A source of
// its own, so that these instances build beside csrc/flash_bwd.cu's, in
// parallel, and leave that library as it was (kernel 6's are in
// csrc/flash_varlen_features.cu).

#include "flash_varlen_bwd_sm90.cuh"

namespace {

// The feature arguments of both entry points as fa::Features (per-head
// slopes, no segment ids, sink tokens or sink); *feat gets kFeatExt |
// kFeatDrop.
fa::Features features(const float* slopes, int chunk, int dropout,
                      unsigned int seed, unsigned int keep_threshold,
                      float keep_scale, int* feat) {
  const bool ext = slopes != nullptr || chunk > 0;
  *feat = (ext ? fa::kFeatExt : 0) | (dropout ? fa::kFeatDrop : 0);
  return fa::Features{slopes, 0,     nullptr, nullptr, 0,
                      0,      nullptr, chunk,  0,       seed,
                      keep_threshold, keep_scale};
}

}  // namespace

// As csrc/flash_bwd.cu's flash_varlen_bwd_dq (no max_seqlen_q), plus the
// features of csrc/flash_varlen_features.cu's flash_varlen_fwd_features:
// slopes (h,) fp32 or null, chunk, dropout with seed, keep_threshold and
// keep_scale. delta = sum_j P dP Z / (1 - p) with dropout. K and V are read
// in 64-key tiles (dq_walk_tile). Returns as flash_varlen_bwd_dq, or -3
// when no feature is set.
extern "C" int flash_varlen_bwd_dq_features(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, const long long* strides,
    const int* cu_q, const int* cu_k, const int* used_q, const int* used_k,
    int nseq, int total_q, int h, int hk, int d, float scale, int window_left,
    int window_right, float softcap, int is_fp16, const float* slopes,
    int chunk, int dropout, unsigned int seed, unsigned int keep_threshold,
    float keep_scale, void* stream) {
  namespace f = fa::vbwd90;
  if (d != 64 && d != 128) return -1;
  int feat;
  const fa::Features fs = features(slopes, chunk, dropout, seed,
                                   keep_threshold, keep_scale, &feat);
  if (feat == 0) return -3;
  if (nseq <= 0 || total_q <= 0) return 0;
  const int bn = fa::bwd90::dq_walk_tile(d, softcap > 0.f, feat);
  CUtensorMap maps[4];
  if (static_cast<long long>(h) * total_q > 0x7fffffffll ||
      strides[3] > 0x7fffffffll || strides[6] > 0x7fffffffll ||
      fa::sm90::make_map(maps + 0, q, is_fp16, d, total_q, h, 1, strides[2],
                         strides[1], 0, f::kBlockRows) ||
      fa::sm90::make_map(maps + 1, dout, is_fp16, d, total_q, h, 1,
                         strides[11], strides[10], 0, f::kBlockRows) ||
      fa::sm90::make_map(maps + 2, k, is_fp16, d,
                         static_cast<int>(strides[3]), hk, 1, strides[5],
                         strides[4], 0, bn) ||
      fa::sm90::make_map(maps + 3, v, is_fp16, d,
                         static_cast<int>(strides[6]), hk, 1, strides[8],
                         strides[7], 0, bn)) {
    return -2;
  }
  f::FeatParams p = {};
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dq_h = strides[13];
  p.dq_s = strides[14];
  p.total_q = total_q;
  p.h = h;
  p.group = h / hk;
  p.nseq = nseq;
  p.left = window_left;
  p.right = window_right;
  p.scale = scale;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
  p.cap_log2 = softcap * fa::kLog2e;
  p.cu_q = cu_q;
  p.cu_k = cu_k;
  p.used_q = used_q;
  p.used_k = used_k;
  p.f = fs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64 ? f::launch_features<__half, 64>(maps, p, cap, feat, s)
                   : f::launch_features<__half, 128>(maps, p, cap, feat, s);
  }
  return d == 64
             ? f::launch_features<__nv_bfloat16, 64>(maps, p, cap, feat, s)
             : f::launch_features<__nv_bfloat16, 128>(maps, p, cap, feat, s);
}

// As csrc/flash_bwd.cu's flash_varlen_bwd_dkv (no max_seqlen_k), plus the
// features of flash_varlen_bwd_dq_features, whose delta it reads. Returns
// as flash_varlen_bwd_dkv, or -3 when no feature is set.
extern "C" int flash_varlen_bwd_dkv_features(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const long long* strides, const int* cu_q, const int* cu_k,
    const int* used_q, const int* used_k, int nseq, int total_q, int h,
    int hk, int d, float scale, int window_left, int window_right,
    float softcap, int is_fp16, const float* slopes, int chunk, int dropout,
    unsigned int seed, unsigned int keep_threshold, float keep_scale,
    void* stream) {
  namespace f = fa::vbwd90;
  if (d != 64 && d != 128) return -1;
  int feat;
  const fa::Features fs = features(slopes, chunk, dropout, seed,
                                   keep_threshold, keep_scale, &feat);
  if (feat == 0) return -3;
  const long long total_k = strides[3];
  if (nseq <= 0 || total_q <= 0 || total_k <= 0) return 0;
  const int bq = f::walk_tile(d, softcap > 0.f);
  const long long stats = static_cast<long long>(h) * total_q;
  CUtensorMap maps[6];
  if (stats > 0x7fffffffll || total_k > 0x7fffffffll ||
      strides[6] != total_k ||
      fa::sm90::make_map(maps + 0, q, is_fp16, d, total_q, h, 1, strides[2],
                         strides[1], 0, bq) ||
      fa::sm90::make_map(maps + 1, dout, is_fp16, d, total_q, h, 1,
                         strides[11], strides[10], 0, bq) ||
      fa::sm90::make_map(maps + 2, k, is_fp16, d, static_cast<int>(total_k),
                         hk, 1, strides[5], strides[4], 0, f::kBlockRows) ||
      fa::sm90::make_map(maps + 3, v, is_fp16, d, static_cast<int>(total_k),
                         hk, 1, strides[8], strides[7], 0, f::kBlockRows) ||
      fa::sm90::make_map_1d(maps + 4, lse, stats, bq + 4) ||
      fa::sm90::make_map_1d(maps + 5, delta, stats, bq + 4)) {
    return -2;
  }
  f::DkvFeatParams p = {};
  p.dk = dk;
  p.dv = dv;
  p.dk_h = strides[13];
  p.dk_s = strides[14];
  p.dv_h = strides[16];
  p.dv_s = strides[17];
  p.total_q = total_q;
  p.h = h;
  p.group = h / hk;
  p.nseq = nseq;
  p.left = window_left;
  p.right = window_right;
  p.scale = scale;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
  p.cap_log2 = softcap * fa::kLog2e;
  p.cu_q = cu_q;
  p.cu_k = cu_k;
  p.used_q = used_q;
  p.used_k = used_k;
  p.f = fs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64 ? f::launch_dkv_features<__half, 64>(maps, p, cap, feat,
                                                        total_k, hk, s)
                   : f::launch_dkv_features<__half, 128>(maps, p, cap, feat,
                                                         total_k, hk, s);
  }
  return d == 64 ? f::launch_dkv_features<__nv_bfloat16, 64>(
                       maps, p, cap, feat, total_k, hk, s)
                 : f::launch_dkv_features<__nv_bfloat16, 128>(
                       maps, p, cap, feat, total_k, hk, s);
}
