// The attention features that the dense kernels 1-3 take beyond scale,
// window, GQA/MQA and softcap: ALiBi, segment ids, attention_chunk, sink
// tokens, the learnable sink, and dropout (csrc/dropout.cuh); and those
// that the packed varlen kernels 6-8 take (ALiBi, attention_chunk, dropout;
// see "The varlen kernels" below).
//
// The kernels take them in instances of their own, chosen by a template
// parameter kFeat: kFeatExt for the score and visibility rules (ALiBi,
// segment ids, chunk, sink tokens, the learnable sink, each switched at run
// time inside the instance), kFeatDrop for dropout. The feature-free
// instances (kFeat 0), which the training and varlen paths run, compile as
// they did before the features existed.
//
// The rules follow flash_attn_tpu/kernels/flash_fwd.py:_fwd_kernel
// (:333-392, the mask and the ALiBi term; :505-523, the sink and the
// dropout scale) and flash_bwd.py:_recompute_p_and_ds (:107-230), with
// diag = row + sk - sq:
//   ALiBi:    score (base 2, after the softcap) -= slope log2(e) |col - diag|
//   visible:  col < sk, row < sq, col <= diag + right (right >= 0),
//             col >= diag - left or col < sink_tokens (left >= 0),
//             chunk_start(diag) <= col < chunk_start(diag) + chunk (chunk > 0),
//             q_seg[row] == kv_seg[col] (segment ids)
//   sink:     the row's sum of exponentials gains exp(sink), out and the
//             LSE include it; a row that sees no key has out 0, lse = sink
//   dropout:  m and l from the undropped P, P V from P times the keep mask,
//             out scaled by 1 / (1 - p).

#pragma once

#include "dropout.cuh"
#include "mma_utils.cuh"

namespace fa {

constexpr int kFeatExt = 1;   // ALiBi, segment ids, chunk, sink tokens, sink
constexpr int kFeatDrop = 2;  // dropout

struct Features {
  const float* slopes;  // ALiBi slopes (h,) or (b, h) fp32, or null
  long long slope_b;    // their batch stride: 0 for (h,)
  const int* q_seg;     // segment ids (b, sq) and (b, sk) int32, or null
  const int* kv_seg;
  long long q_seg_b, kv_seg_b;  // their batch strides
  const float* sink;    // learnable sink (h,) fp32, natural log, or null
  int chunk;            // attention_chunk; 0 = none
  int sink_tokens;      // keys below it escape a left window; 0 = none
  uint32_t seed;        // dropout: the seed's 32 bits
  uint32_t keep_threshold;  // keep iff the hash is below it
  float keep_scale;     // 1 / (1 - dropout_p)
};

// x - x mod c, the mod taken towards -inf (JAX's %), for c > 0: the first
// column of the chunk of diagonal x.
__host__ __device__ __forceinline__ int chunk_start(int x, int c) {
  const int r = x % c;
  return x - (r < 0 ? r + c : r);
}

// Whether key col is visible from the row of diagonal diag under the
// window, the sink tokens and the chunk; the caller checks col < sk, the
// row's bound and the segment ids.
__device__ __forceinline__ bool visible_ext(int col, int diag, int left,
                                           int right, const Features& f) {
  if (right >= 0 && col > diag + right) return false;
  if (left >= 0 && col < diag - left && col >= f.sink_tokens) return false;
  if (f.chunk > 0) {
    const int lo = chunk_start(diag, f.chunk);
    if (col < lo || col >= lo + f.chunk) return false;
  }
  return true;
}

// Whether the chunk rule lets rows of diagonals d_lo..d_hi see every key
// of c_lo..c_hi: one chunk for all rows, holding the keys.
__device__ __forceinline__ bool chunk_full(int c_lo, int c_hi, int d_lo,
                                           int d_hi, const Features& f) {
  if (f.chunk <= 0) return true;
  const int lo = chunk_start(d_lo, f.chunk);
  return lo == chunk_start(d_hi, f.chunk) && c_lo >= lo && c_hi < lo + f.chunk;
}

// The key tiles of width tile_n that rows row0..row_last walk (kernels 1
// and 3): first the n_sink tiles from s0 that hold sink tokens some row may
// see below the main range, then the main range from lo, narrowed to the
// rows' chunks; n in all. No tile is walked twice.
struct KeyTiles {
  int lo, n, s0, n_sink;
  __device__ __forceinline__ int tile(int it) const {
    return it < n_sink ? s0 + it : lo + it - n_sink;
  }
};

__device__ __forceinline__ KeyTiles key_tiles(int row0, int row_last, int off,
                                              int left, int right, int sk,
                                              int tile_n, const Features& f) {
  int col_lo = left >= 0 ? max(row0 + off - left, 0) : 0;
  int col_hi = right >= 0 ? min(row_last + off + right, sk - 1) : sk - 1;
  int chunk_lo = 0;
  if (f.chunk > 0) {
    chunk_lo = max(chunk_start(row0 + off, f.chunk), 0);
    col_lo = max(col_lo, chunk_lo);
    col_hi = min(col_hi, chunk_start(row_last + off, f.chunk) + f.chunk - 1);
  }
  KeyTiles t;
  t.lo = col_lo / tile_n;
  const int n_main = col_hi >= col_lo ? col_hi / tile_n - t.lo + 1 : 0;
  t.s0 = chunk_lo / tile_n;
  t.n_sink = 0;
  // Sink tokens matter only under a left window: keys chunk_lo..
  // min(sink_tokens, col_hi + 1) - 1, in tiles below the main range.
  const int s_hi = min(f.sink_tokens - 1, col_hi);
  if (left >= 0 && f.sink_tokens > 0 && s_hi >= chunk_lo) {
    int last = s_hi / tile_n;
    if (n_main > 0) last = min(last, t.lo - 1);
    t.n_sink = max(last - t.s0 + 1, 0);
  }
  t.n = t.n_sink + n_main;
  return t;
}

// The query rows that see some key of key0..key_last (kernel 2): the
// window's rows, every row from the right edge on where the keys hold sink
// tokens, narrowed to the keys' chunks. Returns lo and sets hi.
__device__ __forceinline__ int query_rows(int key0, int key_last, int off,
                                          int left, int right, int sq,
                                          const Features& f, int& hi) {
  int lo = right >= 0 ? max(key0 - off - right, 0) : 0;
  hi = left >= 0 ? min(key_last - off + left, sq - 1) : sq - 1;
  if (left >= 0 && key0 < f.sink_tokens) hi = sq - 1;
  if (f.chunk > 0) {
    lo = max(lo, chunk_start(key0, f.chunk) - off);
    hi = min(hi, chunk_start(key_last, f.chunk) + f.chunk - 1 - off);
  }
  return lo;
}

// The varlen kernels (6-8, csrc/flash_varlen_fwd_sm90.cuh and
// csrc/flash_varlen_bwd_sm90.cuh) take ALiBi with per-head slopes,
// attention_chunk and dropout from Features (slope_b 0; no segment ids,
// sink tokens or learnable sink, as the JAX varlen kernel has none). Their
// rules are the ones above in each sequence's own positions: a row of
// rows = min(used_q, length) and a key of keys count from the sequence's
// first row and key, and diag = row + used_k - used_q, so that
//   ALiBi:    |col - diag| is the JAX kernels' |packed col - qmeta diag|
//             (flash_attn_tpu/kernels/flash_varlen.py:701-704, :837-840);
//   chunk:    chunk_start(diag) <= col < chunk_start(diag) + chunk, in the
//             sequence's key positions (make_varlen_metadata :166-183);
//   dropout:  the keep mask of batch row 0 at the packed query row q0 + row
//             and key k0 + col (q0, k0 the sequence's first row and key),
//             as the JAX varlen kernel draws it (:733-736, :859-861).
// A block's walk is narrowed to its rows' chunks (chunk_keys) or its keys'
// rows (chunk_rows); with no sink tokens it stays one range.

// Narrows [lo, hi], the keys that rows of diagonals d_lo..d_hi walk, to
// their chunks (chunk > 0).
__device__ __forceinline__ void chunk_keys(int d_lo, int d_hi, int chunk,
                                           int& lo, int& hi) {
  if (chunk <= 0) return;
  lo = max(lo, chunk_start(d_lo, chunk));
  hi = min(hi, chunk_start(d_hi, chunk) + chunk - 1);
}

// Narrows [lo, hi], the query rows that see keys key0..key_last (off =
// used_k - used_q), to the rows whose chunks hold them (chunk > 0).
__device__ __forceinline__ void chunk_rows(int key0, int key_last, int off,
                                           int chunk, int& lo, int& hi) {
  if (chunk <= 0) return;
  lo = max(lo, chunk_start(key0, chunk) - off);
  hi = min(hi, chunk_start(key_last, chunk) + chunk - 1 - off);
}

// out's factor and the LSE (natural log) of a row from its running max m
// and sum l (base 2), with the learnable sink s2 = sink log2(e) when
// has_sink: the sink joins the sum under the larger of the two maxima, so
// that neither overflows; a row that saw nothing (l = 0) then has lse =
// sink and out 0. Without the sink: 1 / l and m + log2 l, or 0 and -inf.
__device__ __forceinline__ float finalize_row(float m, float l, bool has_sink,
                                              float s2, float& lse) {
  if (has_sink) {
    const float mm = fmaxf(m, s2);
    const float w = exp2f(m - mm);
    const float lt = l * w + exp2f(s2 - mm);
    lse = (mm + log2f(lt)) * kLn2;
    return w / lt;
  }
  lse = l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
  return l > 0.f ? 1.f / l : 0.f;
}

}  // namespace fa
