// Flash-attention backward over dense batches or packed variable-length
// sequences: the C entry points of kernels 2-3 (dense dK/dV and dQ) and 7-8
// (varlen dK/dV and dQ). The dense kernels, their function, bound and
// design are in csrc/flash_bwd_sm90.cuh, the varlen ones in
// csrc/flash_varlen_bwd_sm90.cuh.

#include "flash_bwd_sm90.cuh"
#include "flash_varlen_bwd_sm90.cuh"

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
      f::make_map_1d(&tl, lse, stats, bq + 4) ||
      f::make_map_1d(&tdl, delta, stats, bq + 4)) {
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

// The trace buffer of the varlen dK/dV kernel's schedule (see
// fa::vbwd90::DkvParams::trace) that later flash_varlen_bwd_dkv launches
// write, or none (trace null): for checks on the card.
static int* g_dkv_trace = nullptr;
static long long g_dkv_trace_len = 0;

extern "C" void flash_varlen_bwd_dkv_trace(int* trace, long long len) {
  g_dkv_trace = trace;
  g_dkv_trace_len = trace ? len : 0;
}

// Varlen dK/dV over nseq packed sequences: strides 18, (extent, head,
// token) element strides of q, k, v, dout, dk and dv, where the first of
// k's and of v's is their packed token count (the extent of their tensor
// maps) and the others' first is unused; those of q, k, v and dout and the
// base pointers must be multiples of 16 bytes (TMA), those of dk and dv
// multiples of 2 elements; lse and delta (h, total_q) contiguous, 16-byte
// aligned (delta from flash_varlen_bwd_dq). Writes dk and dv, each kv
// head's group of query heads summed, on the keys below each sequence's
// used keys that some row sees (the caller zero-fills the others). used_q
// and used_k may be null. max_seqlen_k goes unread: the flat schedule's
// grid comes from the packed key count and nseq. Returns 0, a cudaError_t
// from the launch, -1 for an unsupported head dim, or -2 if h * total_q
// passes 2^31 or cuTensorMapEncodeTiled refuses a tensor map. Launches on
// `stream`; does not synchronise.
extern "C" int flash_varlen_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const long long* strides, const int* cu_q, const int* cu_k,
    const int* used_q, const int* used_k, int nseq, int max_seqlen_k,
    int total_q, int h, int hk, int d, float scale, int window_left,
    int window_right, float softcap, int is_fp16, void* stream) {
  namespace f = fa::vbwd90;
  (void)max_seqlen_k;
  if (d != 64 && d != 128) return -1;
  const long long total_k = strides[3];
  if (nseq <= 0 || total_q <= 0 || total_k <= 0) return 0;
  const int bq = f::walk_tile(d, softcap > 0.f);
  const long long stats = static_cast<long long>(h) * total_q;
  CUtensorMap maps[6];
  if (stats > 0x7fffffffll || total_k > 0x7fffffffll ||
      strides[6] != total_k ||
      fa::sm90::make_map(maps + 0, q, is_fp16, d, total_q, h, 1, strides[2],
                         strides[1], 0, bq) ||
      fa::sm90::make_map(maps + 1, dout, is_fp16, d, total_q, h, 1,
                         strides[11], strides[10], 0, bq) ||
      fa::sm90::make_map(maps + 2, k, is_fp16, d, static_cast<int>(total_k),
                         hk, 1, strides[5], strides[4], 0, f::kBlockRows) ||
      fa::sm90::make_map(maps + 3, v, is_fp16, d, static_cast<int>(total_k),
                         hk, 1, strides[8], strides[7], 0, f::kBlockRows) ||
      fa::sm90::make_map_1d(maps + 4, lse, stats, bq + 4) ||
      fa::sm90::make_map_1d(maps + 5, delta, stats, bq + 4)) {
    return -2;
  }
  f::DkvParams p = {};
  p.dk = dk;
  p.dv = dv;
  p.dk_h = strides[13];
  p.dk_s = strides[14];
  p.dv_h = strides[16];
  p.dv_s = strides[17];
  p.total_q = total_q;
  p.h = h;
  p.group = h / hk;
  p.nseq = nseq;
  p.left = window_left;
  p.right = window_right;
  p.scale = scale;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
  p.cap_log2 = softcap * fa::kLog2e;
  p.cu_q = cu_q;
  p.cu_k = cu_k;
  p.used_q = used_q;
  p.used_k = used_k;
  p.trace = g_dkv_trace;
  p.trace_len = g_dkv_trace_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64
               ? f::launch_dkv_softcap<__half, 64>(maps, p, cap, total_k, hk, s)
               : f::launch_dkv_softcap<__half, 128>(maps, p, cap, total_k, hk,
                                                    s);
  }
  return d == 64 ? f::launch_dkv_softcap<__nv_bfloat16, 64>(maps, p, cap,
                                                           total_k, hk, s)
                 : f::launch_dkv_softcap<__nv_bfloat16, 128>(maps, p, cap,
                                                            total_k, hk, s);
}

// The trace buffer of the varlen dQ kernel's schedule (see
// fa::vbwd90::Params::trace) that later flash_varlen_bwd_dq launches write,
// or none (trace null): for checks on the card.
static int* g_dq_trace = nullptr;
static long long g_dq_trace_len = 0;

extern "C" void flash_varlen_bwd_dq_trace(int* trace, long long len) {
  g_dq_trace = trace;
  g_dq_trace_len = trace ? len : 0;
}

// Varlen dQ over nseq packed sequences: strides 15, (extent, head, token)
// element strides of q, k, v, dout and dq, where the first of k's and of
// v's is their packed token count (the extent of their tensor maps) and the
// others' first is unused; those of q, k, v and dout and the base pointers
// must be multiples of 16 bytes (TMA), those of dq multiples of 2
// elements. Writes dq and delta (h, total_q) fp32 on the rows below each
// sequence's used rows (the caller zero-fills the others); lse (h, total_q)
// contiguous. used_q and used_k may be null. max_seqlen_q goes unread: the
// flat schedule's grid comes from total_q and nseq. Returns 0, a
// cudaError_t from the launch, -1 for an unsupported head dim, or -2 if
// h * total_q passes 2^31 or cuTensorMapEncodeTiled refuses a tensor map.
// Launches on `stream`; does not synchronise.
extern "C" int flash_varlen_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, const long long* strides,
    const int* cu_q, const int* cu_k, const int* used_q, const int* used_k,
    int nseq, int max_seqlen_q, int total_q, int h, int hk, int d,
    float scale, int window_left, int window_right, float softcap,
    int is_fp16, void* stream) {
  namespace f = fa::vbwd90;
  (void)max_seqlen_q;
  if (d != 64 && d != 128) return -1;
  if (nseq <= 0 || total_q <= 0) return 0;
  const int bn = f::walk_tile(d, softcap > 0.f);
  CUtensorMap maps[4];
  if (static_cast<long long>(h) * total_q > 0x7fffffffll ||
      strides[3] > 0x7fffffffll || strides[6] > 0x7fffffffll ||
      fa::sm90::make_map(maps + 0, q, is_fp16, d, total_q, h, 1, strides[2],
                         strides[1], 0, f::kBlockRows) ||
      fa::sm90::make_map(maps + 1, dout, is_fp16, d, total_q, h, 1,
                         strides[11], strides[10], 0, f::kBlockRows) ||
      fa::sm90::make_map(maps + 2, k, is_fp16, d,
                         static_cast<int>(strides[3]), hk, 1, strides[5],
                         strides[4], 0, bn) ||
      fa::sm90::make_map(maps + 3, v, is_fp16, d,
                         static_cast<int>(strides[6]), hk, 1, strides[8],
                         strides[7], 0, bn)) {
    return -2;
  }
  f::Params p = {};
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dq_h = strides[13];
  p.dq_s = strides[14];
  p.total_q = total_q;
  p.h = h;
  p.group = h / hk;
  p.nseq = nseq;
  p.left = window_left;
  p.right = window_right;
  p.scale = scale;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
  p.cap_log2 = softcap * fa::kLog2e;
  p.cu_q = cu_q;
  p.cu_k = cu_k;
  p.used_q = used_q;
  p.used_k = used_k;
  p.trace = g_dq_trace;
  p.trace_len = g_dq_trace_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64 ? f::launch_softcap<__half, 64>(maps, p, cap, s)
                   : f::launch_softcap<__half, 128>(maps, p, cap, s);
  }
  return d == 64 ? f::launch_softcap<__nv_bfloat16, 64>(maps, p, cap, s)
                 : f::launch_softcap<__nv_bfloat16, 128>(maps, p, cap, s);
}
