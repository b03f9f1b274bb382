// Vertical-slash (MInference) sparse attention forward: the C entry point of
// kernels 12 (key-tile list with membership words) and 15 (gathered column
// list). The tile step, its function, bound and design are in
// csrc/flash_fwd_tile.cuh (modes kSparse and kGather); the lists come from
// the planners in kernels/flash_sparse.py and kernels/flash_sparse_gather.py.

#include "flash_fwd_tile.cuh"

// q (b, h, sq, d), k and v (b, hk, sk, d), out as q: strides, 12 element
// strides (batch, head, seq) of q, k, v and out. lse (b, h, sq) fp32.
// counts (b, h, cdiv(sq, 64)); with cols == null (kernel 12) tiles and words
// hold list_len entries per count, else (kernel 15) cols does. seqlens_q,
// seqlens_k (b) and alibi (slopes of (b, head) at b * alibi_b + head) may be
// null. Returns 0, a cudaError_t from the launch, or -1 for an unsupported
// head dim. Launches on `stream`; does not synchronise.
extern "C" int flash_sparse_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const long long* strides, const int* counts, const int* tiles,
    const unsigned long long* words, const int* cols, long long list_len,
    const int* seqlens_q, const int* seqlens_k, const float* alibi,
    int alibi_b, int batch, int h, int hk, int sq, int sk, int d, float scale,
    int causal, float softcap, int is_fp16, void* stream) {
  FwdParams p = make_params(q, k, v, out, lse, strides, h, hk, scale, -1,
                            causal ? 0 : -1, softcap);
  p.sq = sq;
  p.sk = sk;
  p.lse_h = sq;
  p.used_q = seqlens_q;
  p.used_k = seqlens_k;
  p.counts = counts;
  p.tiles = tiles;
  p.words = words;
  p.cols = cols;
  p.list_len = list_len;
  p.nqb = (sq + kTileM - 1) / kTileM;
  p.alibi = alibi;
  p.alibi_b = alibi_b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols) return dispatch<kGather>(p, p.nqb, batch, d, is_fp16, s);
  return dispatch<kSparse>(p, p.nqb, batch, d, is_fp16, s);
}
