// Flash-attention backward over dense batches or packed variable-length
// sequences: the C entry points of kernels 2-3 (dense dK/dV and dQ) and 7-8
// (varlen). The dense kernels, their function, bound and design are in
// csrc/flash_bwd_sm90.cuh; the varlen tile steps are in
// csrc/flash_bwd_tile.cuh.

#include "flash_bwd_sm90.cuh"
#include "flash_bwd_tile.cuh"

// strides: 18 element strides, (batch, head, seq) of q, k, v, dout, dk, dv;
// those of q, k, v and dout and the base pointers must be multiples of 16
// bytes (TMA), those of dk and dv multiples of 2 elements; lse and delta
// (b, h, sq) contiguous, 16-byte aligned. Returns 0, a cudaError_t from the
// launch, -1 for an unsupported head dim, or -2 if cuTensorMapEncodeTiled
// refuses a tensor map. Launches on `stream`; does not synchronise.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const long long* strides, int batch, int h,
                             int hk, int sq, int sk, int d, float scale,
                             int window_left, int window_right, float softcap,
                             int is_fp16, void* stream) {
  namespace f = fa::bwd90;
  if (d != 64 && d != 128) return -1;
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
      f::make_map_1d(&tl, lse, stats, bq) ||
      f::make_map_1d(&tdl, delta, stats, bq)) {
    return -2;
  }
  f::Params p = f::make_params(h, hk, sq, sk, scale, window_left,
                               window_right, softcap);
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
    return d == 64 ? f::launch_dkv_softcap<__half, 64>(tq, tdo, tk, tv, tl,
                                                       tdl, p, cap, batch, s)
                   : f::launch_dkv_softcap<__half, 128>(tq, tdo, tk, tv, tl,
                                                        tdl, p, cap, batch, s);
  }
  return d == 64 ? f::launch_dkv_softcap<__nv_bfloat16, 64>(
                       tq, tdo, tk, tv, tl, tdl, p, cap, batch, s)
                 : f::launch_dkv_softcap<__nv_bfloat16, 128>(
                       tq, tdo, tk, tv, tl, tdl, p, cap, batch, s);
}

// strides: 15 element strides, (batch, head, seq) of q, k, v, dout, dq, as
// flash_bwd_dkv's. Writes dq and delta (b, h, sq) fp32; lse (b, h, sq)
// contiguous. Returns as flash_bwd_dkv.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, float* delta,
                            void* dq,
                            const long long* strides, int batch, int h, int hk,
                            int sq, int sk, int d, float scale,
                            int window_left, int window_right, float softcap,
                            int is_fp16, void* stream) {
  namespace f = fa::bwd90;
  if (d != 64 && d != 128) return -1;
  const int bn = f::walk_tile(d, softcap > 0.f);
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
  f::Params p = f::make_params(h, hk, sq, sk, scale, window_left,
                               window_right, softcap);
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dq_b = strides[12];
  p.dq_h = strides[13];
  p.dq_s = strides[14];
  const bool cap = softcap > 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64 ? f::launch_dq_softcap<__half, 64>(tq, tdo, tk, tv, p, cap,
                                                      batch, s)
                   : f::launch_dq_softcap<__half, 128>(tq, tdo, tk, tv, p, cap,
                                                       batch, s);
  }
  return d == 64 ? f::launch_dq_softcap<__nv_bfloat16, 64>(tq, tdo, tk, tv, p,
                                                          cap, batch, s)
                 : f::launch_dq_softcap<__nv_bfloat16, 128>(tq, tdo, tk, tv, p,
                                                           cap, batch, s);
}

// Varlen dK/dV over nseq packed sequences. strides: 18 element strides,
// (unused, head, token) of q, k, v, dout, dk, dv; lse and delta are
// (h, total_q). used_q and used_k may be null. max_seqlen_k sizes the grid
// only.
extern "C" int flash_varlen_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const long long* strides, const int* cu_q, const int* cu_k,
    const int* used_q, const int* used_k, int nseq, int max_seqlen_k,
    int total_q, int h, int hk, int d, float scale, int window_left,
    int window_right, float softcap, int is_fp16, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, strides, h, hk, scale,
                            window_left, window_right, softcap);
  set_dkv(p, dk, dv, strides);
  set_varlen(p, cu_q, cu_k, used_q, used_k, total_q);
  const int n_blocks = max((max_seqlen_k + kTileRows - 1) / kTileRows, 1);
  return dispatch<true>(p, n_blocks, hk, nseq, d, is_fp16, stream);
}

// Varlen dQ: strides 15, (unused, head, token) of q, k, v, dout, dq; writes
// dq and delta (h, total_q). max_seqlen_q sizes the grid only.
extern "C" int flash_varlen_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, const long long* strides,
    const int* cu_q, const int* cu_k, const int* used_q, const int* used_k,
    int nseq, int max_seqlen_q, int total_q, int h, int hk, int d,
    float scale, int window_left, int window_right, float softcap,
    int is_fp16, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, nullptr, strides, h, hk,
                            scale, window_left, window_right, softcap);
  set_dq(p, delta, dq, strides);
  set_varlen(p, cu_q, cu_k, used_q, used_k, total_q);
  const int n_blocks = max((max_seqlen_q + kTileRows - 1) / kTileRows, 1);
  return dispatch<false>(p, n_blocks, hk, nseq, d, is_fp16, stream);
}
