// Flash-attention backward over dense batches or packed variable-length
// sequences: the C entry points of kernels 2-3 (dense dK/dV and dQ) and 7-8
// (varlen). The tile steps, their function, bound and design are in
// csrc/flash_bwd_tile.cuh, shared with the sparse mode of
// csrc/flash_sparse_bwd.cu.

#include "flash_bwd_tile.cuh"

// strides: 18 element strides, (batch, head, seq) of q, k, v, dout, dk, dv.
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported head
// dim. Launches on `stream`; does not synchronise.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const long long* strides, int batch, int h,
                             int hk, int sq, int sk, int d, float scale,
                             int window_left, int window_right, float softcap,
                             int is_fp16, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, strides, h, hk, scale,
                            window_left, window_right, softcap);
  set_dkv(p, dk, dv, strides);
  p.sq = sq;
  p.sk = sk;
  p.lse_h = sq;
  return dispatch<true, kDense>(p, (sk + kTileRows - 1) / kTileRows, hk,
                                batch, d, is_fp16, stream);
}

// strides: 15 element strides, (batch, head, seq) of q, k, v, dout, dq.
// Writes dq and delta (b, h, sq) fp32.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, float* delta,
                            void* dq,
                            const long long* strides, int batch, int h, int hk,
                            int sq, int sk, int d, float scale,
                            int window_left, int window_right, float softcap,
                            int is_fp16, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, nullptr, strides, h, hk,
                            scale, window_left, window_right, softcap);
  set_dq(p, delta, dq, strides);
  p.sq = sq;
  p.sk = sk;
  p.lse_h = sq;
  return dispatch<false, kDense>(p, (sq + kTileRows - 1) / kTileRows, hk,
                                 batch, d, is_fp16, stream);
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
  return dispatch<true, kVarlen>(p, n_blocks, hk, nseq, d, is_fp16, stream);
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
  return dispatch<false, kVarlen>(p, n_blocks, hk, nseq, d, is_fp16, stream);
}
