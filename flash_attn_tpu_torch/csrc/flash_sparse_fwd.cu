// Vertical-slash (MInference) sparse attention forward: the C entry point of
// kernels 12 (key-tile list with membership words) and 15 (gathered column
// list). Kernel 12's Hopper kernel, its function, bound and design are in
// csrc/flash_sparse_fwd_sm90.cuh; kernel 15's in
// csrc/flash_sparse_gather_sm90.cuh. The lists come from the planners in
// kernels/flash_sparse.py and kernels/flash_sparse_gather.py.

#include "flash_sparse_fwd_sm90.cuh"
#include "flash_sparse_gather_sm90.cuh"

// q (b, h, sq, d), k and v (b, hk, sk, d), out as q: strides, 12 element
// strides (batch, head, seq) of q, k, v and out; those of q, k and v and
// the base pointers must be multiples of 16 bytes (kernel 12's TMA; kernel
// 15's 16-byte copies), those of out multiples of 2 elements. lse (b, h,
// sq) fp32. counts (b, h, cdiv(sq, 64)); with cols == null (kernel 12)
// tiles and words hold list_len entries per count, else (kernel 15) cols
// does. seqlens_q, seqlens_k (b) and alibi (slopes of (b, head) at b *
// alibi_b + head) may be null. Returns 0, a cudaError_t from the launch, -1
// for an unsupported head dim, or -2 if cuTensorMapEncodeTiled refuses a
// tensor map. Launches on `stream`; does not synchronise.
extern "C" int flash_sparse_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const long long* strides, const int* counts, const int* tiles,
    const unsigned long long* words, const int* cols, long long list_len,
    const int* seqlens_q, const int* seqlens_k, const float* alibi,
    int alibi_b, int batch, int h, int hk, int sq, int sk, int d, float scale,
    int causal, float softcap, int is_fp16, void* stream) {
  if (d != 64 && d != 128) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols) {
    namespace f = fa::gather90;
    f::Params p = {};
    p.q = q;
    p.k = k;
    p.v = v;
    p.out = out;
    p.lse = lse;
    p.q_b = strides[0];
    p.q_h = strides[1];
    p.q_s = strides[2];
    p.k_b = strides[3];
    p.k_h = strides[4];
    p.k_s = strides[5];
    p.v_b = strides[6];
    p.v_h = strides[7];
    p.v_s = strides[8];
    p.o_b = strides[9];
    p.o_h = strides[10];
    p.o_s = strides[11];
    p.h = h;
    p.group = h / hk;
    p.sq = sq;
    p.sk = sk;
    p.nqb = (sq + f::kRows - 1) / f::kRows;
    p.causal = causal;
    const bool cap = softcap > 0.f;
    p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
    p.cap_log2 = cap ? softcap * fa::kLog2e : 0.f;
    p.seqlens_q = seqlens_q;
    p.seqlens_k = seqlens_k;
    p.counts = counts;
    p.cols = cols;
    p.list_len = list_len;
    p.alibi = alibi;
    p.alibi_b = alibi_b;
    if (is_fp16) {
      return d == 64 ? f::dispatch<__half, 64>(p, batch, s)
                     : f::dispatch<__half, 128>(p, batch, s);
    }
    return d == 64 ? f::dispatch<__nv_bfloat16, 64>(p, batch, s)
                   : f::dispatch<__nv_bfloat16, 128>(p, batch, s);
  }
  namespace f = fa::sfwd90;
  using fa::sm90::make_map;
  CUtensorMap maps[3];
  if (make_map(maps + 0, q, is_fp16, d, sq, h, batch, strides[2], strides[1],
               strides[0], f::kBlockRows) ||
      make_map(maps + 1, k, is_fp16, d, sk, hk, batch, strides[5], strides[4],
               strides[3], f::kTile) ||
      make_map(maps + 2, v, is_fp16, d, sk, hk, batch, strides[8], strides[7],
               strides[6], f::kTile)) {
    return -2;
  }
  f::Params p = {};
  p.out = out;
  p.lse = lse;
  p.o_b = strides[9];
  p.o_h = strides[10];
  p.o_s = strides[11];
  p.h = h;
  p.group = h / hk;
  p.sq = sq;
  p.sk = sk;
  p.nqb = (sq + f::kTile - 1) / f::kTile;
  p.causal = causal;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
  p.cap_log2 = cap ? softcap * fa::kLog2e : 0.f;
  p.counts = counts;
  p.tiles = tiles;
  p.words = words;
  p.list_len = list_len;
  p.used_q = seqlens_q;
  p.used_k = seqlens_k;
  p.alibi = alibi;
  p.alibi_b = alibi_b;
  if (is_fp16) {
    return d == 64 ? f::dispatch<__half, 64>(maps, p, batch, s)
                   : f::dispatch<__half, 128>(maps, p, batch, s);
  }
  return d == 64 ? f::dispatch<__nv_bfloat16, 64>(maps, p, batch, s)
                 : f::dispatch<__nv_bfloat16, 128>(maps, p, batch, s);
}
