// Flash-attention forward over dense batches (b, h, s, d) or packed
// variable-length sequences (total, h, d), the latter with K/V packed or
// read from page pools through a page table: the C entry points of kernels
// 1 and 6. The tile step, its function, bound and design are in
// csrc/flash_fwd_tile.cuh, shared with the sparse modes of
// csrc/flash_sparse_fwd.cu.

#include "flash_fwd_tile.cuh"

// strides: 12 element strides, (batch, head, seq) of q, k, v and out.
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported head
// dim. Launches on `stream`; does not synchronise.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, const long long* strides,
                         int batch, int h, int hk, int sq, int sk, int d,
                         float scale, int window_left, int window_right,
                         float softcap, int is_fp16, void* stream) {
  FwdParams p = make_params(q, k, v, out, lse, strides, h, hk, scale,
                            window_left, window_right, softcap);
  p.sq = sq;
  p.sk = sk;
  p.lse_h = sq;
  return dispatch<kDense>(p, (sq + kTileM - 1) / kTileM, batch, d, is_fp16,
                          static_cast<cudaStream_t>(stream));
}

// Varlen forward over nseq packed sequences. strides: 12 element strides,
// (unused, head, token) of q, k, v and out, except that with a page table
// (table != null) k's and v's are (page, head, slot) of their pools and
// cu_k is unused. used_q and used_k may be null (used_k not with a table).
// lse is (h, total_q). max_seqlen_q sizes the grid only.
extern "C" int flash_varlen_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const long long* strides, const int* cu_q, const int* cu_k,
    const int* used_q, const int* used_k, const int* table,
    long long table_row, int page, int max_pages, int npages, int nseq,
    int max_seqlen_q, int total_q, int h, int hk, int d, float scale,
    int window_left, int window_right, float softcap, int is_fp16,
    void* stream) {
  FwdParams p = make_params(q, k, v, out, lse, strides, h, hk, scale,
                            window_left, window_right, softcap);
  p.lse_h = total_q;
  p.cu_q = cu_q;
  p.cu_k = cu_k;
  p.used_q = used_q;
  p.used_k = used_k;
  p.table = table;
  p.table_row = table_row;
  p.page = page;
  p.max_pages = max_pages;
  p.npages = npages;
  p.page_shift = -1;
  if (page > 0 && (page & (page - 1)) == 0) {
    p.page_shift = 0;
    while ((1 << p.page_shift) < page) ++p.page_shift;
  }
  const int m_blocks = max((max_seqlen_q + kTileM - 1) / kTileM, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table) return dispatch<kPaged>(p, m_blocks, nseq, d, is_fp16, s);
  return dispatch<kVarlen>(p, m_blocks, nseq, d, is_fp16, s);
}
