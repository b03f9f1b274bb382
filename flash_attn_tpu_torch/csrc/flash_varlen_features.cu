// Kernel 6's instances with features (csrc/flash_varlen_fwd_sm90.cuh,
// kFeat != 0; the varlen rules in csrc/attn_features.cuh): ALiBi and
// attention_chunk on packed K/V and on page pools, dropout on packed K/V.
// A source of its own, so that these instances build beside
// csrc/flash_fwd.cu's, in parallel, and leave that library as it was;
// kernels 7-8's are in csrc/flash_varlen_bwd_features.cu, a third parallel
// build, so that neither source grows the build's longest compile.

#include "flash_varlen_fwd_sm90.cuh"

// As csrc/flash_fwd.cu's flash_varlen_fwd (no max_seqlen_q: the Hopper
// kernel's flat schedule needs none), plus the features: slopes (h,) fp32
// or null; chunk (0 = none); dropout (0 or 1) with seed, keep_threshold and
// keep_scale = 1 / (1 - p). Returns as flash_varlen_fwd, -3 when no feature
// is set (flash_varlen_fwd takes that call) or for dropout on pools, and
// -4 for pools whose page size is not a multiple of 8 (the sm80 route has
// no feature instances).
extern "C" int flash_varlen_fwd_features(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const long long* strides, const int* cu_q, const int* cu_k,
    const int* used_q, const int* used_k, const int* table,
    long long table_row, int page, int max_pages, int npages, int nseq,
    int total_q, int h, int hk, int d, float scale, int window_left,
    int window_right, float softcap, int is_fp16, const float* slopes,
    int chunk, int dropout, unsigned int seed, unsigned int keep_threshold,
    float keep_scale, void* stream) {
  namespace f = fa::vfwd90;
  if (d != 64 && d != 128) return -1;
  const bool ext = slopes != nullptr || chunk > 0;
  const int feat = (ext ? fa::kFeatExt : 0) | (dropout ? fa::kFeatDrop : 0);
  if (feat == 0) return -3;
  if (table && !f::pages_on_tma(page)) return -4;
  // Q over (d, token, head); packed K/V likewise over their npages tokens;
  // pools over (d, slot, head, page) with boxes of one page piece.
  CUtensorMap maps[3];
  const int rows_k = table ? f::piece_rows(page) : f::kBlockN;
  const int s_k = table ? page : npages;
  const int b_k = table ? npages : 1;
  if (f::make_map(maps + 0, q, is_fp16, d, total_q, h, 1, strides[2],
                  strides[1], 0, f::block_m(d)) ||
      f::make_map(maps + 1, k, is_fp16, d, s_k, hk, b_k, strides[5],
                  strides[4], strides[3], rows_k) ||
      f::make_map(maps + 2, v, is_fp16, d, s_k, hk, b_k, strides[8],
                  strides[7], strides[6], rows_k)) {
    return -2;
  }
  f::FeatParams p = {};
  p.out = out;
  p.lse = lse;
  p.o_h = strides[10];
  p.o_s = strides[11];
  p.total_q = total_q;
  p.h = h;
  p.group = h / hk;
  p.nseq = nseq;
  p.left = window_left;
  p.right = window_right;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
  p.cap_log2 = softcap * fa::kLog2e;
  p.cu_q = cu_q;
  p.cu_k = cu_k;
  p.used_q = used_q;
  p.used_k = used_k;
  p.table = table;
  p.table_row = table_row;
  p.page = page;
  p.max_pages = max_pages;
  p.piece = rows_k;
  p.f = fa::Features{slopes, 0,     nullptr, nullptr, 0,
                     0,      nullptr, chunk,  0,       seed,
                     keep_threshold, keep_scale};
  const bool paged = table != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64
               ? f::dispatch_features<__half, 64>(maps, p, cap, paged, feat, s)
               : f::dispatch_features<__half, 128>(maps, p, cap, paged, feat,
                                                   s);
  }
  return d == 64 ? f::dispatch_features<__nv_bfloat16, 64>(maps, p, cap, paged,
                                                           feat, s)
                 : f::dispatch_features<__nv_bfloat16, 128>(maps, p, cap,
                                                            paged, feat, s);
}
