// Kernels 2 and 3's instances with features (csrc/flash_bwd_sm90.cuh,
// kFeat != 0; the rules in csrc/attn_features.cuh): ALiBi, segment ids,
// attention_chunk, sink tokens and dropout (the learnable sink needs
// nothing here: P = exp(S - LSE) carries it). A source of its own, so that
// these instances build beside csrc/flash_bwd.cu's, in parallel, and leave
// that library as it was.

#include "flash_bwd_sm90.cuh"

namespace {

// The feature arguments of both entry points, as fa::Features; *feat gets
// kFeatExt | kFeatDrop.
fa::Features features(const float* slopes, long long slope_b,
                      const int* q_seg, const int* kv_seg, long long q_seg_b,
                      long long kv_seg_b, int chunk, int sink_tokens,
                      int dropout, unsigned int seed,
                      unsigned int keep_threshold, float keep_scale,
                      int* feat) {
  const bool ext = slopes || q_seg || chunk > 0 || sink_tokens > 0;
  *feat = (ext ? fa::kFeatExt : 0) | (dropout ? fa::kFeatDrop : 0);
  return fa::Features{slopes,  slope_b, q_seg, kv_seg,      q_seg_b,
                      kv_seg_b, nullptr, chunk, sink_tokens, seed,
                      keep_threshold, keep_scale};
}

}  // namespace

// As csrc/flash_bwd.cu's flash_bwd_dkv, plus the features of
// csrc/flash_fwd_features.cu's flash_fwd_features but the sink. delta is
// the dQ kernel's (sum_j P dP Z / (1 - p) with dropout). Returns as
// flash_bwd_dkv, or -3 when no feature is set.
extern "C" int flash_bwd_dkv_features(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const long long* strides, int batch, int h, int hk, int sq, int sk, int d,
    float scale, int window_left, int window_right, float softcap,
    int is_fp16, const float* slopes, long long slope_b, const int* q_seg,
    const int* kv_seg, long long q_seg_b, long long kv_seg_b, int chunk,
    int sink_tokens, int dropout, unsigned int seed,
    unsigned int keep_threshold, float keep_scale, void* stream) {
  namespace f = fa::bwd90;
  if (d != 64 && d != 128) return -1;
  int feat;
  const fa::Features fs =
      features(slopes, slope_b, q_seg, kv_seg, q_seg_b, kv_seg_b, chunk,
               sink_tokens, dropout, seed, keep_threshold, keep_scale, &feat);
  if (feat == 0) return -3;
  const int bq = f::walk_tile(d, softcap > 0.f);
  const long long stats = static_cast<long long>(batch) * h * sq;
  CUtensorMap tq, tdo, tk, tv, tl, tdl;
  if (stats > 0x7fffffffll ||  // TMA coordinates are 32-bit
      f::make_map(&tq, q, is_fp16, d, sq, h, batch, strides[2], strides[1],
                  strides[0], bq) ||
      f::make_map(&tdo, dout, is_fp16, d, sq, h, batch, strides[11],
                  strides[10], strides[9], bq) ||
      f::make_map(&tk, k, is_fp16, d, sk, hk, batch, strides[5], strides[4],
                  strides[3], f::kBlockRows) ||
      f::make_map(&tv, v, is_fp16, d, sk, hk, batch, strides[8], strides[7],
                  strides[6], f::kBlockRows) ||
      f::make_map_1d(&tl, lse, stats, bq + 4) ||
      f::make_map_1d(&tdl, delta, stats, bq + 4)) {
    return -2;
  }
  f::FeatParams p = {};
  static_cast<f::Params&>(p) = f::make_params(h, hk, sq, sk, scale,
                                              window_left, window_right,
                                              softcap);
  p.f = fs;
  p.dk = dk;
  p.dv = dv;
  p.dk_b = strides[12];
  p.dk_h = strides[13];
  p.dk_s = strides[14];
  p.dv_b = strides[15];
  p.dv_h = strides[16];
  p.dv_s = strides[17];
  const bool cap = softcap > 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64 ? f::launch_dkv_features<__half, 64>(
                         tq, tdo, tk, tv, tl, tdl, p, cap, feat, batch, s)
                   : f::launch_dkv_features<__half, 128>(
                         tq, tdo, tk, tv, tl, tdl, p, cap, feat, batch, s);
  }
  return d == 64 ? f::launch_dkv_features<__nv_bfloat16, 64>(
                       tq, tdo, tk, tv, tl, tdl, p, cap, feat, batch, s)
                 : f::launch_dkv_features<__nv_bfloat16, 128>(
                       tq, tdo, tk, tv, tl, tdl, p, cap, feat, batch, s);
}

// As csrc/flash_bwd.cu's flash_bwd_dq, plus the features of
// flash_bwd_dkv_features. delta = sum_j P dP Z / (1 - p) with dropout.
extern "C" int flash_bwd_dq_features(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, const long long* strides,
    int batch, int h, int hk, int sq, int sk, int d, float scale,
    int window_left, int window_right, float softcap, int is_fp16,
    const float* slopes, long long slope_b, const int* q_seg,
    const int* kv_seg, long long q_seg_b, long long kv_seg_b, int chunk,
    int sink_tokens, int dropout, unsigned int seed,
    unsigned int keep_threshold, float keep_scale, void* stream) {
  namespace f = fa::bwd90;
  if (d != 64 && d != 128) return -1;
  int feat;
  const fa::Features fs =
      features(slopes, slope_b, q_seg, kv_seg, q_seg_b, kv_seg_b, chunk,
               sink_tokens, dropout, seed, keep_threshold, keep_scale, &feat);
  if (feat == 0) return -3;
  const int bn = f::dq_walk_tile(d, softcap > 0.f, feat);
  CUtensorMap tq, tdo, tk, tv;
  if (f::make_map(&tq, q, is_fp16, d, sq, h, batch, strides[2], strides[1],
                  strides[0], f::kBlockRows) ||
      f::make_map(&tdo, dout, is_fp16, d, sq, h, batch, strides[11],
                  strides[10], strides[9], f::kBlockRows) ||
      f::make_map(&tk, k, is_fp16, d, sk, hk, batch, strides[5], strides[4],
                  strides[3], bn) ||
      f::make_map(&tv, v, is_fp16, d, sk, hk, batch, strides[8], strides[7],
                  strides[6], bn)) {
    return -2;
  }
  f::FeatParams p = {};
  static_cast<f::Params&>(p) = f::make_params(h, hk, sq, sk, scale,
                                              window_left, window_right,
                                              softcap);
  p.f = fs;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dq_b = strides[12];
  p.dq_h = strides[13];
  p.dq_s = strides[14];
  const bool cap = softcap > 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64 ? f::launch_dq_features<__half, 64>(tq, tdo, tk, tv, p, cap,
                                                       feat, batch, s)
                   : f::launch_dq_features<__half, 128>(tq, tdo, tk, tv, p,
                                                        cap, feat, batch, s);
  }
  return d == 64 ? f::launch_dq_features<__nv_bfloat16, 64>(
                       tq, tdo, tk, tv, p, cap, feat, batch, s)
                 : f::launch_dq_features<__nv_bfloat16, 128>(
                       tq, tdo, tk, tv, p, cap, feat, batch, s);
}
