// Vertical-slash (MInference) sparse attention backward: the C entry points
// of kernels 13 (dK/dV over inverse lists) and 14 (dQ and delta over the
// forward's lists). The kernels, their function, bound and design are in
// csrc/flash_sparse_bwd_sm90.cuh; the lists come from the planner in
// kernels/flash_sparse.py. Deterministic: no atomics.

#include "flash_sparse_bwd_sm90.cuh"

namespace {

namespace f = fa::sparse90;

f::Params make_params(const int* seqlens_q, const int* seqlens_k,
                      const float* alibi, int alibi_b, int h, int hk, int sq,
                      int sk, float scale, int causal, float softcap) {
  f::Params p = {};
  p.used_q = seqlens_q;
  p.used_k = seqlens_k;
  p.alibi = alibi;
  p.alibi_b = alibi_b;
  p.h = h;
  p.group = h / hk;
  p.sq = sq;
  p.sk = sk;
  p.nqb = (sq + f::kTile - 1) / f::kTile;
  p.nkb = (sk + f::kTile - 1) / f::kTile;
  p.causal = causal;
  p.scale = scale;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
  p.cap_log2 = softcap * fa::kLog2e;
  return p;
}

// The tensor maps of q, dout (boxes of q_rows rows), k and v (kv_rows)
// from the (batch, head, seq) strides; 0 or -2.
int make_maps(CUtensorMap* maps, const void* q, const void* k, const void* v,
              const void* dout, const long long* s, int is_fp16, int batch,
              int h, int hk, int sq, int sk, int d, int q_rows, int kv_rows) {
  using fa::sm90::make_map;
  return make_map(maps + 0, q, is_fp16, d, sq, h, batch, s[2], s[1], s[0],
                  q_rows) ||
                 make_map(maps + 1, dout, is_fp16, d, sq, h, batch, s[11],
                          s[10], s[9], q_rows) ||
                 make_map(maps + 2, k, is_fp16, d, sk, hk, batch, s[5], s[4],
                          s[3], kv_rows) ||
                 make_map(maps + 3, v, is_fp16, d, sk, hk, batch, s[8], s[7],
                          s[6], kv_rows)
             ? -2
             : 0;
}

template <typename T, int D, bool kSoftcap, bool kAlibi, bool kDkv>
int launch_one(const CUtensorMap* maps, const f::Params& p, int batch,
               cudaStream_t s) {
  if constexpr (kDkv) {
    return f::launch_dkv<T, D, kSoftcap, kAlibi>(
        maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p, batch, s);
  } else {
    return f::launch_dq<T, D, kSoftcap, kAlibi>(maps[0], maps[1], maps[2],
                                                maps[3], p, batch, s);
  }
}

// The kernel of head dim D and dtype T; the softcap and ALiBi are template
// parameters.
template <typename T, int D, bool kDkv>
int launch(const CUtensorMap* maps, const f::Params& p, bool softcap,
           int batch, cudaStream_t s) {
  const bool alibi = p.alibi != nullptr;
  if (softcap) {
    return alibi ? launch_one<T, D, true, true, kDkv>(maps, p, batch, s)
                 : launch_one<T, D, true, false, kDkv>(maps, p, batch, s);
  }
  return alibi ? launch_one<T, D, false, true, kDkv>(maps, p, batch, s)
               : launch_one<T, D, false, false, kDkv>(maps, p, batch, s);
}

template <bool kDkv>
int dispatch(const CUtensorMap* maps, const f::Params& p, float softcap,
             int batch, int d, int is_fp16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (is_fp16) {
    return d == 64 ? launch<__half, 64, kDkv>(maps, p, cap, batch, s)
                   : launch<__half, 128, kDkv>(maps, p, cap, batch, s);
  }
  return d == 64 ? launch<__nv_bfloat16, 64, kDkv>(maps, p, cap, batch, s)
                 : launch<__nv_bfloat16, 128, kDkv>(maps, p, cap, batch, s);
}

}  // namespace

// q (b, h, sq, d), k and v (b, hk, sk, d), dout as q; strides: 18 element
// strides (batch, head, seq) of q, k, v, dout, dk, dv; those of q, k, v
// and dout and the base pointers must be multiples of 16 bytes (TMA), those
// of dk and dv multiples of 2 elements. lse and delta (b, h, sq) fp32
// contiguous, 16-byte aligned (delta from flash_sparse_bwd_dq). inv_counts
// (b, hk, cdiv(sk, 64)); inv_idx and inv_words hold inv_len entries per
// count. seqlens_q, seqlens_k (b) and alibi (slopes of (b, head) at b *
// alibi_b + head) may be null. Keys past seqlens_k are not written. Returns
// 0, a cudaError_t from the launch, -1 for an unsupported head dim, or -2
// if cuTensorMapEncodeTiled refuses a tensor map.
extern "C" int flash_sparse_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const long long* strides, const int* inv_counts, const int* inv_idx,
    const unsigned long long* inv_words, long long inv_len,
    const int* seqlens_q, const int* seqlens_k, const float* alibi,
    int alibi_b, int batch, int h, int hk, int sq, int sk, int d, float scale,
    int causal, float softcap, int is_fp16, void* stream) {
  if (d != 64 && d != 128) return -1;
  const long long stats = static_cast<long long>(batch) * h * sq;
  CUtensorMap maps[6];
  if (stats > 0x7fffffffll ||  // TMA coordinates are 32-bit
      make_maps(maps, q, k, v, dout, strides, is_fp16, batch, h, hk, sq, sk,
                d, f::kTile, fa::bwd90::kBlockRows) ||
      fa::sm90::make_map_1d(maps + 4, lse, stats, f::kTile + 4) ||
      fa::sm90::make_map_1d(maps + 5, delta, stats, f::kTile + 4)) {
    return -2;
  }
  f::Params p = make_params(seqlens_q, seqlens_k, alibi, alibi_b, h, hk, sq,
                            sk, scale, causal, softcap);
  p.dk = dk;
  p.dv = dv;
  p.dk_b = strides[12];
  p.dk_h = strides[13];
  p.dk_s = strides[14];
  p.dv_b = strides[15];
  p.dv_h = strides[16];
  p.dv_s = strides[17];
  p.inv_counts = inv_counts;
  p.inv_idx = inv_idx;
  p.inv_words = inv_words;
  p.inv_len = inv_len;
  return dispatch<true>(maps, p, softcap, batch, d, is_fp16, stream);
}

// strides: 15 element strides (batch, head, seq) of q, k, v, dout, dq, as
// flash_sparse_bwd_dkv's. counts (b, h, cdiv(sq, 64)); tiles and words hold
// list_len entries per count (the forward's kernel-12 lists). Writes dq and
// delta (b, h, sq) fp32; rows past seqlens_q are not written. Returns as
// flash_sparse_bwd_dkv.
extern "C" int flash_sparse_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, const long long* strides,
    const int* counts, const int* tiles, const unsigned long long* words,
    long long list_len, const int* seqlens_q, const int* seqlens_k,
    const float* alibi, int alibi_b, int batch, int h, int hk, int sq, int sk,
    int d, float scale, int causal, float softcap, int is_fp16, void* stream) {
  if (d != 64 && d != 128) return -1;
  CUtensorMap maps[4];
  if (make_maps(maps, q, k, v, dout, strides, is_fp16, batch, h, hk, sq, sk,
                d, fa::bwd90::kBlockRows, f::kTile)) {
    return -2;
  }
  f::Params p = make_params(seqlens_q, seqlens_k, alibi, alibi_b, h, hk, sq,
                            sk, scale, causal, softcap);
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dq_b = strides[12];
  p.dq_h = strides[13];
  p.dq_s = strides[14];
  p.counts = counts;
  p.tiles = tiles;
  p.words = words;
  p.list_len = list_len;
  return dispatch<false>(maps, p, softcap, batch, d, is_fp16, stream);
}
