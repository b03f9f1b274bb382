// Block-sparse attention backward: the C entry points of kernel 11 (dQ and
// delta, Q-stationary, over the forward's lists) and kernel 10 (dK/dV,
// KV-stationary, over the inverse lists), from Q, K, V, dO and the
// forward's log-sum-exp. Their function, bound and design are in
// csrc/block_sparse_bwd_sm90.cuh; the lists' format is
// csrc/block_sparse.cuh's.

#include "block_sparse_bwd_sm90.cuh"

// q (b, h, sq, d), k and v (b, hk, sk, d), dout as q; strides: 15 element
// strides (batch, head, seq) of q, k, v, dout, dq; those of q, k, v and
// dout and the base pointers must be multiples of 16 bytes (TMA), those of
// dq multiples of 2 elements. lse (b, h, sq) fp32. counts (b, h, cdiv(sq,
// 64)); tiles and wofs hold list_len entries per count (the forward's
// lists); words the mode-2 groups of 64 words, on a 16-byte aligned base.
// Writes dq and delta (b, h, sq) fp32 = sum_j P dP, every row. Returns 0,
// a cudaError_t from the launch, -1 for an unsupported head dim, or -2 if
// cuTensorMapEncodeTiled refuses a tensor map. Launches on `stream`; does
// not synchronise.
extern "C" int block_sparse_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, const long long* strides,
    const int* counts, const int* tiles, const int* wofs,
    const unsigned long long* words, long long list_len, int batch, int h,
    int hk, int sq, int sk, int d, float scale, float softcap, int is_fp16,
    void* stream) {
  namespace f = fa::bsbwd90;
  using fa::sm90::make_map;
  if (d != 64 && d != 128) return -1;
  CUtensorMap maps[4];
  if (make_map(maps + 0, q, is_fp16, d, sq, h, batch, strides[2], strides[1],
               strides[0], f::kBlockRows) ||
      make_map(maps + 1, dout, is_fp16, d, sq, h, batch, strides[11],
               strides[10], strides[9], f::kBlockRows) ||
      make_map(maps + 2, k, is_fp16, d, sk, hk, batch, strides[5], strides[4],
               strides[3], f::kTile) ||
      make_map(maps + 3, v, is_fp16, d, sk, hk, batch, strides[8], strides[7],
               strides[6], f::kTile)) {
    return -2;
  }
  f::Params p = {};
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dq_b = strides[12];
  p.dq_h = strides[13];
  p.dq_s = strides[14];
  p.h = h;
  p.group = h / hk;
  p.sq = sq;
  p.sk = sk;
  p.nqb = (sq + f::kTile - 1) / f::kTile;
  p.scale = scale;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
  p.cap_log2 = softcap * fa::kLog2e;
  p.counts = counts;
  p.tiles = tiles;
  p.wofs = wofs;
  p.words = words;
  p.list_len = list_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64 ? f::launch_softcap<__half, 64>(maps, p, cap, batch, s)
                   : f::launch_softcap<__half, 128>(maps, p, cap, batch, s);
  }
  return d == 64 ? f::launch_softcap<__nv_bfloat16, 64>(maps, p, cap, batch, s)
                 : f::launch_softcap<__nv_bfloat16, 128>(maps, p, cap, batch,
                                                         s);
}

// q (b, h, sq, d), k and v (b, hk, sk, d), dout as q; strides: 18 element
// strides (batch, head, seq) of q, k, v, dout, dk, dv; those of q, k, v and
// dout and the base pointers must be multiples of 16 bytes (TMA), those of
// dk and dv multiples of 2 elements. lse and delta (b, h, sq) fp32, 16-byte
// aligned (delta from block_sparse_bwd_dq). inv_counts (b, h, cdiv(sk,
// 64)); inv_rows and inv_wofs hold inv_len entries per count: per query
// head, its 64-row blocks that keep any key of the 64-key block; words the
// mode-2 groups of 64 words, on a 16-byte aligned base. Writes every key
// row of dk and dv (b, hk, sk, d), each kv head's group of query heads
// summed. Returns 0, a cudaError_t from the launch, -1 for an unsupported
// head dim, or -2 if b * h * sq passes 2^31 or cuTensorMapEncodeTiled
// refuses a tensor map. Launches on `stream`; does not synchronise.
extern "C" int block_sparse_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dk, void* dv,
    const long long* strides, const int* inv_counts, const int* inv_rows,
    const int* inv_wofs, const unsigned long long* words, long long inv_len,
    int batch, int h, int hk, int sq, int sk, int d, float scale,
    float softcap, int is_fp16, void* stream) {
  namespace f = fa::bsbwd90;
  using fa::sm90::make_map;
  using fa::sm90::make_map_1d;
  if (d != 64 && d != 128) return -1;
  const long long stats = static_cast<long long>(batch) * h * sq;
  CUtensorMap maps[6];
  if (stats > 0x7fffffffll ||  // TMA coordinates are 32-bit
      make_map(maps + 0, q, is_fp16, d, sq, h, batch, strides[2], strides[1],
               strides[0], f::kTile) ||
      make_map(maps + 1, dout, is_fp16, d, sq, h, batch, strides[11],
               strides[10], strides[9], f::kTile) ||
      make_map(maps + 2, k, is_fp16, d, sk, hk, batch, strides[5], strides[4],
               strides[3], f::kBlockRows) ||
      make_map(maps + 3, v, is_fp16, d, sk, hk, batch, strides[8], strides[7],
               strides[6], f::kBlockRows) ||
      make_map_1d(maps + 4, lse, stats, f::DkvCfg<64>::kStatBox) ||
      make_map_1d(maps + 5, delta, stats, f::DkvCfg<64>::kStatBox)) {
    return -2;
  }
  f::DkvParams p = {};
  p.dk = dk;
  p.dv = dv;
  p.dk_b = strides[12];
  p.dk_h = strides[13];
  p.dk_s = strides[14];
  p.dv_b = strides[15];
  p.dv_h = strides[16];
  p.dv_s = strides[17];
  p.h = h;
  p.group = h / hk;
  p.sq = sq;
  p.sk = sk;
  p.nqb = (sq + f::kTile - 1) / f::kTile;
  p.nkb = (sk + f::kTile - 1) / f::kTile;
  p.scale = scale;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
  p.cap_log2 = softcap * fa::kLog2e;
  p.counts = inv_counts;
  p.rows = inv_rows;
  p.wofs = inv_wofs;
  p.words = words;
  p.list_len = inv_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64 ? f::launch_dkv_softcap<__half, 64>(maps, p, cap, batch, s)
                   : f::launch_dkv_softcap<__half, 128>(maps, p, cap, batch, s);
  }
  return d == 64
             ? f::launch_dkv_softcap<__nv_bfloat16, 64>(maps, p, cap, batch, s)
             : f::launch_dkv_softcap<__nv_bfloat16, 128>(maps, p, cap, batch,
                                                         s);
}
