// Kernel 1's instances with features (csrc/flash_fwd_sm90.cuh, kFeat != 0;
// the rules in csrc/attn_features.cuh): ALiBi, segment ids,
// attention_chunk, sink tokens, the learnable sink and dropout. A source of
// its own, so that these instances build beside csrc/flash_fwd.cu's, in
// parallel, and leave that library as it was.

#include "flash_fwd_sm90.cuh"

// As csrc/flash_fwd.cu's flash_fwd, plus the features: slopes (h,) or
// (b, h) fp32 (slope_b = h for the latter, else 0) or null; q_seg (b, sq)
// and kv_seg (b, sk) int32 (batch strides q_seg_b, kv_seg_b) or null; sink
// (h,) fp32 or null; chunk and sink_tokens (0 = none); dropout (0 or 1)
// with seed, keep_threshold and keep_scale = 1 / (1 - p). Returns as
// flash_fwd, or -3 when no feature is set (flash_fwd takes that call).
extern "C" int flash_fwd_features(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const long long* strides, int batch, int h, int hk, int sq, int sk, int d,
    float scale, int window_left, int window_right, float softcap, int is_fp16,
    const float* slopes, long long slope_b, const int* q_seg,
    const int* kv_seg, long long q_seg_b, long long kv_seg_b,
    const float* sink, int chunk, int sink_tokens, int dropout,
    unsigned int seed, unsigned int keep_threshold, float keep_scale,
    void* stream) {
  namespace f = fa::fwd90;
  if (d != 64 && d != 128) return -1;
  const bool ext = slopes || q_seg || sink || chunk > 0 || sink_tokens > 0;
  const int feat = (ext ? fa::kFeatExt : 0) | (dropout ? fa::kFeatDrop : 0);
  if (feat == 0) return -3;
  CUtensorMap tq, tk, tv;
  if (f::make_map(&tq, q, is_fp16, d, sq, h, batch, strides[2], strides[1],
                  strides[0], f::block_m(d)) ||
      f::make_map(&tk, k, is_fp16, d, sk, hk, batch, strides[5], strides[4],
                  strides[3], f::kBlockN) ||
      f::make_map(&tv, v, is_fp16, d, sk, hk, batch, strides[8], strides[7],
                  strides[6], f::kBlockN)) {
    return -2;
  }
  f::FeatParams p = {};
  p.out = out;
  p.lse = lse;
  p.o_b = strides[9];
  p.o_h = strides[10];
  p.o_s = strides[11];
  p.h = h;
  p.group = h / hk;
  p.sq = sq;
  p.sk = sk;
  p.left = window_left;
  p.right = window_right;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
  p.cap_log2 = softcap * fa::kLog2e;
  p.f = fa::Features{slopes, slope_b, q_seg,      kv_seg,
                     q_seg_b, kv_seg_b, sink,     chunk,
                     sink_tokens, seed, keep_threshold, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64
               ? f::launch_features<__half, 64>(tq, tk, tv, p, cap, feat,
                                                batch, s)
               : f::launch_features<__half, 128>(tq, tk, tv, p, cap, feat,
                                                 batch, s);
  }
  return d == 64 ? f::launch_features<__nv_bfloat16, 64>(tq, tk, tv, p, cap,
                                                         feat, batch, s)
                 : f::launch_features<__nv_bfloat16, 128>(tq, tk, tv, p, cap,
                                                          feat, batch, s);
}
