// Flash-attention forward over dense batches (b, h, s, d) or packed
// variable-length sequences (total, h, d), the latter with K/V packed or
// read from page pools through a page table: the C entry points of kernels
// 1 and 6. The dense kernel, its function, bound and design are in
// csrc/flash_fwd_sm90.cuh, the varlen kernel's in
// csrc/flash_varlen_fwd_sm90.cuh; pools whose page size is not a multiple
// of 8 keep the paged mode of csrc/flash_fwd_tile.cuh's step.

#include "flash_fwd_sm90.cuh"
#include "flash_fwd_tile.cuh"
#include "flash_varlen_fwd_sm90.cuh"

// strides: 12 element strides, (batch, head, seq) of q, k, v and out; those
// of q, k and v and the base pointers must be multiples of 16 bytes (TMA),
// those of out multiples of 8 elements. Returns 0, a cudaError_t from the
// launch, -1 for an unsupported head dim, or -2 if cuTensorMapEncodeTiled
// refuses a tensor map. Launches on `stream`; does not synchronise.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, const long long* strides,
                         int batch, int h, int hk, int sq, int sk, int d,
                         float scale, int window_left, int window_right,
                         float softcap, int is_fp16, void* stream) {
  namespace f = fa::fwd90;
  if (d != 64 && d != 128) return -1;
  CUtensorMap tq, tk, tv;
  if (f::make_map(&tq, q, is_fp16, d, sq, h, batch, strides[2], strides[1],
                  strides[0], f::block_m(d)) ||
      f::make_map(&tk, k, is_fp16, d, sk, hk, batch, strides[5], strides[4],
                  strides[3], f::kBlockN) ||
      f::make_map(&tv, v, is_fp16, d, sk, hk, batch, strides[8], strides[7],
                  strides[6], f::kBlockN)) {
    return -2;
  }
  f::Params p;
  p.out = out;
  p.lse = lse;
  p.o_b = strides[9];
  p.o_h = strides[10];
  p.o_s = strides[11];
  p.h = h;
  p.group = h / hk;
  p.sq = sq;
  p.sk = sk;
  p.left = window_left;
  p.right = window_right;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
  p.cap_log2 = softcap * fa::kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64 ? f::launch_softcap<__half, 64>(tq, tk, tv, p, cap, batch, s)
                   : f::launch_softcap<__half, 128>(tq, tk, tv, p, cap, batch, s);
  }
  return d == 64
             ? f::launch_softcap<__nv_bfloat16, 64>(tq, tk, tv, p, cap, batch, s)
             : f::launch_softcap<__nv_bfloat16, 128>(tq, tk, tv, p, cap, batch, s);
}

// The trace buffer of the Hopper varlen kernel's schedule (see
// fa::vfwd90::Params::trace) that later flash_varlen_fwd launches write, or
// none (trace null): for checks on the card.
static int* g_varlen_trace = nullptr;
static long long g_varlen_trace_len = 0;

extern "C" void flash_varlen_fwd_trace(int* trace, long long len) {
  g_varlen_trace = trace;
  g_varlen_trace_len = trace ? len : 0;
}

// Varlen forward over nseq packed sequences. strides: 12 element strides,
// (unused, head, token) of q, k, v and out, except that with a page table
// (table != null) k's and v's are (page, head, slot) of their pools and
// cu_k is unused. used_q and used_k may be null (used_k not with a table).
// npages: the pool's pages with a table, else the token count of packed k
// and v (the extent of their tensor maps). lse is (h, total_q). q, packed
// k and v, and pools whose page size is a multiple of 8 go to the Hopper
// kernel (TMA: base pointers and strides multiples of 16 bytes, out's
// strides multiples of 8 elements); max_seqlen_q then goes unread. Pools
// of other page sizes take the paged mode of csrc/flash_fwd_tile.cuh, whose
// grid max_seqlen_q sizes. Returns 0, a cudaError_t from the launch, -1 for
// an unsupported head dim, or -2 if cuTensorMapEncodeTiled refuses a
// tensor map. Launches on `stream`; does not synchronise.
extern "C" int flash_varlen_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const long long* strides, const int* cu_q, const int* cu_k,
    const int* used_q, const int* used_k, const int* table,
    long long table_row, int page, int max_pages, int npages, int nseq,
    int max_seqlen_q, int total_q, int h, int hk, int d, float scale,
    int window_left, int window_right, float softcap, int is_fp16,
    void* stream) {
  if (d != 64 && d != 128) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  namespace f = fa::vfwd90;
  if (table && !f::pages_on_tma(page)) {
    FwdParams p = make_params(q, k, v, out, lse, strides, h, hk, scale,
                              window_left, window_right, softcap);
    p.lse_h = total_q;
    p.cu_q = cu_q;
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
    return dispatch(p, m_blocks, nseq, d, is_fp16, s);
  }
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
  f::Params p = {};
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
  p.trace = g_varlen_trace;
  p.trace_len = g_varlen_trace_len;
  const bool paged = table != nullptr;
  if (is_fp16) {
    return d == 64 ? f::dispatch<__half, 64>(maps, p, cap, paged, s)
                   : f::dispatch<__half, 128>(maps, p, cap, paged, s);
  }
  return d == 64 ? f::dispatch<__nv_bfloat16, 64>(maps, p, cap, paged, s)
                 : f::dispatch<__nv_bfloat16, 128>(maps, p, cap, paged, s);
}
