// Block-sparse attention forward (kernel 9): the C entry point. The kernel,
// its function, bound and design are in csrc/block_sparse_fwd_sm90.cuh;
// the execution lists' format is csrc/block_sparse.cuh's.

#include "block_sparse_fwd_sm90.cuh"

namespace {

namespace f = fa::bs90;

template <typename T, int D>
int launch_softcap(const CUtensorMap* maps, const f::Params& p, bool softcap,
                   int batch, cudaStream_t s) {
  return softcap ? f::launch<T, D, true>(maps[0], maps[1], maps[2], p, batch, s)
                 : f::launch<T, D, false>(maps[0], maps[1], maps[2], p, batch,
                                          s);
}

}  // namespace

// q (b, h, sq, d), k and v (b, hk, sk, d), out as q: strides, 12 element
// strides (batch, head, seq) of q, k, v and out; those of q, k and v and
// the base pointers must be multiples of 16 bytes (TMA), those of out
// multiples of 2 elements. lse (b, h, sq) fp32. counts (b, h, cdiv(sq,
// 64)); tiles and wofs hold list_len entries per count; words the mode-2
// groups of 64 words, on a 16-byte aligned base. Every row of out and lse
// is written. Returns 0, a cudaError_t from the launch, -1 for an
// unsupported head dim, or -2 if cuTensorMapEncodeTiled refuses a tensor
// map. Launches on `stream`; does not synchronise.
extern "C" int block_sparse_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const long long* strides, const int* counts, const int* tiles,
    const int* wofs, const unsigned long long* words, long long list_len,
    int batch, int h, int hk, int sq, int sk, int d, float scale,
    float softcap, int is_fp16, void* stream) {
  if (d != 64 && d != 128) return -1;
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
    return d == 64 ? launch_softcap<__half, 64>(maps, p, cap, batch, s)
                   : launch_softcap<__half, 128>(maps, p, cap, batch, s);
  }
  return d == 64 ? launch_softcap<__nv_bfloat16, 64>(maps, p, cap, batch, s)
                 : launch_softcap<__nv_bfloat16, 128>(maps, p, cap, batch, s);
}
