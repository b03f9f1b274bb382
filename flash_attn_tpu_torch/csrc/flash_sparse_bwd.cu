// Vertical-slash (MInference) sparse attention backward: the C entry points
// of kernels 13 (dK/dV over inverse lists) and 14 (dQ and delta over the
// forward's lists). The tile steps, their function, bound and design are in
// csrc/flash_bwd_tile.cuh (mode kSparse); the lists come from the planner in
// kernels/flash_sparse.py. Deterministic: no atomics.

#include "flash_bwd_tile.cuh"

namespace {

void set_sparse(BwdParams& p, const int* seqlens_q, const int* seqlens_k,
                const float* alibi, int alibi_b, int sq, int sk) {
  p.sq = sq;
  p.sk = sk;
  p.lse_h = sq;
  p.used_q = seqlens_q;
  p.used_k = seqlens_k;
  p.alibi = alibi;
  p.alibi_b = alibi_b;
  p.nqb = (sq + kTileRows - 1) / kTileRows;
  p.nkb = (sk + kTileRows - 1) / kTileRows;
}

}  // namespace

// q (b, h, sq, d), k and v (b, hk, sk, d), dout as q; strides: 18 element
// strides (batch, head, seq) of q, k, v, dout, dk, dv. lse and delta (b, h,
// sq) fp32 (delta from flash_sparse_bwd_dq). inv_counts (b, hk, cdiv(sk,
// 64)); inv_idx and inv_words hold inv_len entries per count. seqlens_q,
// seqlens_k (b) and alibi (slopes of (b, head) at b * alibi_b + head) may be
// null. Keys past seqlens_k are not written. Returns 0, a cudaError_t from
// the launch, or -1 for an unsupported head dim.
extern "C" int flash_sparse_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const long long* strides, const int* inv_counts, const int* inv_idx,
    const unsigned long long* inv_words, long long inv_len,
    const int* seqlens_q, const int* seqlens_k, const float* alibi,
    int alibi_b, int batch, int h, int hk, int sq, int sk, int d, float scale,
    int causal, float softcap, int is_fp16, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, strides, h, hk, scale,
                            -1, causal ? 0 : -1, softcap);
  set_dkv(p, dk, dv, strides);
  set_sparse(p, seqlens_q, seqlens_k, alibi, alibi_b, sq, sk);
  p.inv_counts = inv_counts;
  p.inv_idx = inv_idx;
  p.inv_words = inv_words;
  p.inv_len = inv_len;
  return dispatch<true, kSparse>(p, p.nkb, hk, batch, d, is_fp16, stream);
}

// strides: 15 element strides (batch, head, seq) of q, k, v, dout, dq.
// counts (b, h, cdiv(sq, 64)); tiles and words hold list_len entries per
// count (the forward's kernel-12 lists). Writes dq and delta (b, h, sq)
// fp32; rows past seqlens_q are not written.
extern "C" int flash_sparse_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, const long long* strides,
    const int* counts, const int* tiles, const unsigned long long* words,
    long long list_len, const int* seqlens_q, const int* seqlens_k,
    const float* alibi, int alibi_b, int batch, int h, int hk, int sq, int sk,
    int d, float scale, int causal, float softcap, int is_fp16, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, nullptr, strides, h, hk,
                            scale, -1, causal ? 0 : -1, softcap);
  set_dq(p, delta, dq, strides);
  set_sparse(p, seqlens_q, seqlens_k, alibi, alibi_b, sq, sk);
  p.counts = counts;
  p.tiles = tiles;
  p.words = words;
  p.list_len = list_len;
  return dispatch<false, kSparse>(p, p.nqb, hk, batch, d, is_fp16, stream);
}
