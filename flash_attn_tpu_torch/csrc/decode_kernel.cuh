// General decode: attention of sq >= 1 new query tokens against a KV cache,
// contiguous (b, hk, smax, d) or paged (npages, hk, page, d), with every
// extra of the reference's decode path.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_decode.py:56
// (_decode_kernel, launched at :626 by flash_attention_decode). It computes
// the same function; the TPU schedule (one tile holding all sq * g rows,
// lane-replicated m/l scratch, the kv grid axis carrying the softmax state,
// index-map clamping) is not carried over.
//
// Function. Query row r of kv head g is query token t = r / group of query
// head g * group + r % group ("PackGQA"). Its absolute position is
// pos = seqlen - sq + t, seqlen being the total length, new tokens
// included. Column c is visible iff
//   leftpad <= c < seqlen, c <= pos (causal),
//   c >= pos - window_left, or c < leftpad + sink_tokens (with a window),
//   ch_lo <= c < ch_lo + chunk, ch_lo = pos - (pos - leftpad) mod chunk.
// For each row that is two intervals, [lo1, hi1) and [lo2, hi2) (the sink
// tokens'), both non-decreasing in pos. Scores are s * scale, or
// tanh(s * scale / softcap) * softcap, minus slope * |c - pos| with ALiBi.
// Online softmax in fp32 (base 2). A learnable sink adds exp(sink) to the
// denominator at the end. out = acc / l in q's type, lse = ln(l) + m in
// fp32; a row that sees nothing gives out 0 and lse -inf (with a sink:
// lse = sink, the exact value).
//
// The first visible column is computed exactly, max(pos - window_left,
// leftpad) and the chunk's start. The TPU kernel starts its walk at
// max(seqlen - sq - window_left, 0) + leftpad (flash_decode.py:122), which
// skips tiles that hold visible keys when leftpad and a window meet.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): a decode step
// reads every visible K and V row once, hk * 2d * 2 bytes per token, and is
// bound by bytes; a long prefill (generate's, sq in the thousands) does 4d
// flops per visible (row, column) pair and is bound by operations.
//
// Design. One block of 4 warps per (64 packed rows, kv head, batch row);
// each warp owns 16 rows, Q stays in registers as mma.sync A fragments, so a
// prefill of any length tiles over blocks. The block walks the tiles of its
// rows' visible columns (the sink-token tiles, then the window's; never the
// gap between them) in 64-token tiles, double-buffered through 16-byte
// cp.async copies straight from the cache: a contiguous cache is a pool
// whose page is the whole row (page = smax, page id = cache_batch_idx[b] or
// b), a paged one is read through the block table, both through the
// caller's strides. Tiles that every row of the block sees whole skip the
// mask (a branch around the whole tile); softcap and ALiBi are template
// parameters, the sink only touches the epilogue. The loader and the walk
// are decode_tile.cuh's, shared with the paged decode kernel
// (paged_decode.cu).
//
// That kernel keeps warps on rows, which suits long calls (a prefill of
// thousands of tokens, vLLM's right-aligned chunks). A decode step has
// sq * group packed rows (4 at sq = 1 with a group of 4) and b * hk blocks
// (64 at b = 8, hk = 8) for 132 SMs, with three of four warps idle. Calls of
// at most 64 packed rows may go to the split-KV kernel below, after the
// design of the paged decode's (paged_decode.cu):
//  * one block per (split, kv head, batch row), holding all the rows. The
//    host picks num_splits from what it knows without reading the device
//    (kernels/flash_decode.py `num_splits_for`: batch, kv heads, packed
//    rows, the longest range a row can see, cut by the window, the sink
//    tokens and the chunk, and the SM count): about two blocks per SM, at
//    least 256 tokens a split. Each block derives its chunk on the device
//    from seqlens[b] and leftpad[b]: the walk above (the sink-token tiles,
//    then the window's), split s taking items [s n / S, (s + 1) n / S) of
//    its n tiles, so the splits cover it exactly once;
//  * at most 16 rows: every warp holds all of them and takes its own 16
//    keys of every 64-token tile; the four merge their (m, l, O) through
//    shared memory at the end. 17-64 rows: one warp per 16 rows, as above;
//  * a ring of three cp.async tile stages, two tiles in flight while one
//    computes. The products stay on mma.sync.m16n8k16: wgmma's M of 64
//    would compute 4-16x padded rows, and a decode step is bound by bytes;
//  * with num_splits == 1 the block writes out and lse itself (the sink
//    included); otherwise it writes its fp32 partial O (normalised by its
//    own sum) and its LSE without the sink (-inf for a chunk with no
//    visible column), and decode_combine_kernel merges the partials in
//    split order with no atomics, as the JAX package's combine_partials
//    (flash_attn_tpu/kernels/flash_decode.py:648) does. The learnable sink
//    is added there once, as one more partial whose output is 0 and whose
//    LSE is the sink.

#pragma once

#include "decode_tile.cuh"

namespace {

using namespace fa;
using namespace fa::decode;

struct Params {
  const void* q;         // (b, sq, h, d)
  const void* k;         // K cache, read through pool's strides
  const void* v;         // V cache likewise
  void* out;             // (b, sq, h, d)
  float* lse;            // (b, h, sq)
  const int* seqlens;    // (b,) total lengths, new tokens included
  KvPool pool;           // table null: a contiguous cache
  const int* batch_idx;  // (b,) cache row of each batch row, or null (row b)
  const int* leftpad;    // (b,) or null
  const float* slopes;   // ALiBi slopes, row b at b * slopes_bstride, or null
  const float* sink;     // (h,) or null
  int sq, h, hk, group;
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2
  // with a softcap (score_mul = scale / softcap, cap_log2 = softcap*log2 e).
  float score_mul, cap_log2;
  int causal, window_left, chunk, sink_tokens, slopes_bstride;
  Descales ds;  // read only by the scaled instances
};

// Visible columns of the row at absolute position pos: [lo1, hi1) and
// [lo2, hi2) (the sink tokens, empty without them).
struct Span {
  int lo1, hi1, lo2, hi2;
};

__device__ __forceinline__ Span visible_span(const Params& p, int pos,
                                             int seqlen, int leftpad) {
  int lo = leftpad;
  int hi = p.causal ? min(seqlen, pos + 1) : seqlen;
  if (p.chunk > 0) {
    int rem = (pos - leftpad) % p.chunk;
    if (rem < 0) rem += p.chunk;  // floor modulo, as the reference's
    const int ch_lo = pos - rem;
    lo = max(lo, ch_lo);
    hi = min(hi, ch_lo + p.chunk);
  }
  Span s;
  s.hi1 = hi;
  s.lo1 = p.window_left >= 0 ? max(lo, pos - p.window_left) : lo;
  s.lo2 = lo;
  s.hi2 = p.window_left >= 0 && p.sink_tokens > 0
              ? min(hi, leftpad + p.sink_tokens)
              : lo;
  return s;
}

__device__ __forceinline__ bool sees(const Span& s, int col) {
  return (col >= s.lo1 && col < s.hi1) || (col >= s.lo2 && col < s.hi2);
}

// The kv tiles of the rows whose spans run from `first` to `last` (both
// intervals grow with pos, so the first row bounds their starts and the
// last their ends): the sink tokens' tiles, then the window's that are not
// among them; never the gap between them. Item it of n is tile(it).
struct Walk {
  int sink_lo, sink_n, win_lo, n;
  __device__ __forceinline__ int tile(int it) const {
    return it < sink_n ? sink_lo + it : win_lo + (it - sink_n);
  }
};

__device__ __forceinline__ Walk walk_of(const Span& first, const Span& last) {
  Walk w;
  w.sink_lo = 0;
  w.sink_n = 0;
  if (last.hi2 > first.lo2) {
    w.sink_lo = first.lo2 / kTileN;
    w.sink_n = (last.hi2 + kTileN - 1) / kTileN - w.sink_lo;
  }
  w.win_lo = first.lo1 / kTileN;
  const int win_hi =
      last.hi1 > first.lo1 ? (last.hi1 + kTileN - 1) / kTileN : w.win_lo;
  if (w.sink_n > 0) w.win_lo = max(w.win_lo, w.sink_lo + w.sink_n);
  w.n = w.sink_n + max(win_hi - w.win_lo, 0);
  return w;
}

// The output scale and the LSE of a row whose softmax state is (m, lsum) in
// base 2: 1 / lsum and ln(lsum) + m, or 0 and -inf for a row that sees
// nothing. With a sink (`sink` not null) exp(sink[head]) joins the
// denominator, taken against max(m, sink), and a row that sees nothing
// gets lse = sink.
__device__ __forceinline__ void row_result(float m, float lsum,
                                           const float* sink, int head,
                                           float& inv, float& lse) {
  if (sink) {
    const float s2 = sink[head] * kLog2e;
    const float mx = lsum > 0.f ? fmaxf(m, s2) : s2;
    const float corr = lsum > 0.f ? exp2f(m - mx) : 0.f;
    const float denom = lsum * corr + exp2f(s2 - mx);
    inv = corr / denom;
    lse = (mx + log2f(denom)) * kLn2;
  } else {
    inv = lsum > 0.f ? 1.f / lsum : 0.f;
    lse = lsum > 0.f ? (m + log2f(lsum)) * kLn2 : -INFINITY;
  }
}

// A thread's two query rows, gid and gid + 8 of the 16 from wrow0: their
// spans, positions, heads, ALiBi slopes (base 2), and where their out (an
// element of out) and lse rows start, -1 for a row past the packed rows.
struct Rows {
  Span span[2];
  int pos[2];
  int head[2];
  float slope[2];
  long long orow[2];
  int lse_idx[2];
};

template <int D, bool kAlibi>
__device__ __forceinline__ Rows rows_of(const Params& p, int wrow0, int g,
                                           int b, int seqlen, int leftpad,
                                           int gid) {
  Rows rw;
  const int rows_total = p.sq * p.group;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow0 + gid + 8 * i;
    if (r < rows_total) {
      const int t = r / p.group;
      rw.head[i] = g * p.group + r % p.group;
      rw.pos[i] = seqlen - p.sq + t;
      rw.span[i] = visible_span(p, rw.pos[i], seqlen, leftpad);
      rw.orow[i] =
          ((static_cast<long long>(b) * p.sq + t) * p.h + rw.head[i]) * D;
      rw.lse_idx[i] = (b * p.h + rw.head[i]) * p.sq + t;
      rw.slope[i] =
          kAlibi ? p.slopes[b * p.slopes_bstride + rw.head[i]] * kLog2e : 0.f;
    } else {
      // Sees no column and is never stored; q = 0 keeps its scores finite
      // in unmasked tiles.
      rw.span[i] = Span{0, 0, 0, 0};
      rw.pos[i] = 0;
      rw.head[i] = 0;
      rw.orow[i] = -1;
      rw.lse_idx[i] = -1;
      rw.slope[i] = 0.f;
    }
  }
  return rw;
}

// kKeys keys (a whole tile, or a warp's quarter of it) of one warp's 16
// rows: S = Q K^T; x = score(s, i, col) (base 2) for row i (0: gid, 1:
// gid + 8) and column col; with kMasked only the entries where
// visible(i, col) holds; the online-softmax update of m, l and O += P V.
template <typename T, int D, bool kMasked, int kKeys = kTileN, typename KV,
          typename Score, typename Visible>
__device__ __forceinline__ void tile_step(const KV* ks_ptr, const KV* vs_ptr,
                                          int col0,
                                          const uint32_t (&qf)[D / 16][4],
                                          float (&o)[D / 8][4], float (&m)[2],
                                          float (&l)[2], Score score,
                                          Visible visible, int gid, int tig) {
  constexpr int kStride = row_stride<D>(sizeof(KV));
  constexpr int kKSteps = D / 16;
  constexpr int kNTiles = kKeys / 8;
  constexpr int kOTiles = D / 8;

  float s[kNTiles][4];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const KV* krow = ks_ptr + (nt * 8 + gid) * kStride + tig * 2;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const uint32_t b0 = Frag<T, KV>::k2(krow + ks * 16);
      const uint32_t b1 = Frag<T, KV>::k2(krow + ks * 16 + 8);
      Mma<T>::run(s[nt], qf[ks], b0, b1);
    }
  }

  // Scores, and visibility kept as bits.
  uint32_t vis = 0;
  float tmax[2] = {kMask, kMask};
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int col = col0 + nt * 8 + tig * 2 + (e & 1);
      const float x = score(s[nt][e], i, col);
      if (!kMasked || visible(i, col)) {
        vis |= 1u << (nt * 4 + e);
        tmax[i] = fmaxf(tmax[i], x);
      }
      s[nt][e] = x;
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(tmax[i]));
    alpha[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float pe = !kMasked || (vis >> (nt * 4 + e)) & 1u
                           ? exp2f(s[nt][e] - m[i])
                           : 0.f;
      l[i] += pe;
      s[nt][e] = pe;
    }
  }
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt) {
    o[nt][0] *= alpha[0];
    o[nt][1] *= alpha[0];
    o[nt][2] *= alpha[1];
    o[nt][3] *= alpha[1];
  }

  // O += P V: P's A fragments come straight from the S accumulators.
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    uint32_t a[4];
    a[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
    a[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
    a[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const KV* vrow = vs_ptr + (kk * 16 + tig * 2) * kStride + gid;
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt) {
      const KV* vc = vrow + nt * 8;
      const uint32_t b0 = Frag<T, KV>::v2(vc, vc + kStride);
      const uint32_t b1 = Frag<T, KV>::v2(vc + 8 * kStride, vc + 9 * kStride);
      Mma<T>::run(o[nt], a, b0, b1);
    }
  }
}

template <typename T, int D, bool kSoftcap, bool kAlibi, typename KV,
          bool kScaled>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Params p) {
  // padded smem row: conflict-free fragments
  constexpr int kStride = row_stride<D>(sizeof(KV));
  constexpr int kKSteps = D / 16;
  constexpr int kOTiles = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* sK = reinterpret_cast<KV*>(smem_raw);  // [2][kTileN][kStride]
  KV* sV = sK + 2 * kTileN * kStride;        // [2][kTileN][kStride]

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rows_total = p.sq * p.group;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int seqlen = p.seqlens[b];
  const int leftpad = p.leftpad ? p.leftpad[b] : 0;
  const int cache_row = p.batch_idx ? p.batch_idx[b] : b;

  // The block's rows run from token t0 to t1; both intervals grow with
  // pos, so the first row bounds their starts and the last their ends.
  const int row_last = min(row0 + kRowsPerBlock, rows_total) - 1;
  const Span first =
      visible_span(p, seqlen - p.sq + row0 / p.group, seqlen, leftpad);
  const Span last =
      visible_span(p, seqlen - p.sq + row_last / p.group, seqlen, leftpad);
  const Walk walk = walk_of(first, last);

  // This thread's two rows: gid and gid + 8 of the warp's 16.
  const int wrow0 = row0 + warp * 16;
  const bool warp_active = wrow0 < rows_total;
  const Rows rw = rows_of<D, kAlibi>(p, wrow0, g, b, seqlen, leftpad, gid);

  uint32_t qf[kKSteps][4];
  load_q<T, D>(p.q, rw.orow, qf, tig);
  float o[kOTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt) {
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums
  const Fold<kScaled> fold(p.ds, p.score_mul, b, g);

  auto score = [&](float x, int i, int col) {
    x = kSoftcap ? tanhf(x * fold.mul(p.score_mul)) * p.cap_log2
                 : x * fold.mul(p.score_mul);
    if (kAlibi) x -= rw.slope[i] * fabsf(static_cast<float>(col - rw.pos[i]));
    return x;
  };
  auto visible = [&](int i, int col) { return sees(rw.span[i], col); };
  // A contiguous cache is one page per cache row.
  auto page_of = [&](int pidx) {
    return p.pool.table ? __ldg(p.pool.table +
                                static_cast<long long>(b) * p.pool.max_pages +
                                pidx)
                        : cache_row;
  };
  walk_kv<T, D>(
      p.pool, g, page_of, seqlen, p.k, p.v, sK, sV, walk.n,
      [&](int it) { return walk.tile(it); }, warp_active,
      [&](const auto* ks_ptr, const auto* vs_ptr, int col0) {
        // Every row of the block sees the whole tile: no mask.
        const bool whole =
            (last.lo1 <= col0 && col0 + kTileN <= first.hi1) ||
            (last.lo2 <= col0 && col0 + kTileN <= first.hi2);
        if (whole) {
          tile_step<T, D, false>(ks_ptr, vs_ptr, col0, qf, o, m, l, score,
                                 visible, gid, tig);
        } else {
          tile_step<T, D, true>(ks_ptr, vs_ptr, col0, qf, o, m, l, score,
                                visible, gid, tig);
        }
      },
      tid);

  if (!warp_active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    if (rw.orow[i] < 0) continue;
    float inv, lse;
    row_result(m[i], lsum, p.sink, rw.head[i], inv, lse);
    fold.scale(inv);
    store_row<T, D>(static_cast<T*>(p.out) + rw.orow[i], o, i, inv, tig);
    if (tig == 0) p.lse[rw.lse_idx[i]] = lse;
  }
}

constexpr int kSplitStages = 3;
constexpr int kKeyRows = 16;  // up to this many packed rows: warps on keys

__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Partial results of the split kernel: o_part (num, b, sq, h, d) and
// lse_part (num, b, h, sq), fp32; unused with one split.
struct Splits {
  float* o_part;
  float* lse_part;
  int num;
};

// The first of the n_items walk items that split s of n takes.
__device__ __forceinline__ int split_start(int s, int n, int n_items) {
  return static_cast<int>(static_cast<long long>(s) * n_items / n);
}

// Split `blockIdx.x` of the walk of every packed row of one (kv head, batch
// row): at most kKeyRows rows with kWarpKeys (every warp holds them all and
// takes its quarter of each tile's keys), else at most kRowsPerBlock (one
// warp per 16 rows).
template <typename T, int D, bool kSoftcap, bool kAlibi, bool kWarpKeys,
          typename KV, bool kScaled>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const Params p, const Splits sp) {
  // padded smem row: conflict-free fragments
  constexpr int kStride = row_stride<D>(sizeof(KV));
  constexpr int kKSteps = D / 16;
  constexpr int kOTiles = D / 8;
  constexpr int kKeys = kWarpKeys ? kTileN / kWarps : kTileN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* sK = reinterpret_cast<KV*>(smem_raw);       // [3][kTileN][kStride]
  KV* sV = sK + kSplitStages * kTileN * kStride;  // [3][kTileN][kStride]

  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rows_total = p.sq * p.group;
  const int seqlen = p.seqlens[b];
  const int leftpad = p.leftpad ? p.leftpad[b] : 0;
  const int cache_row = p.batch_idx ? p.batch_idx[b] : b;

  // The walk of all the rows (the first is token 0, the last token sq - 1)
  // and this split's share of its items.
  const Span first = visible_span(p, seqlen - p.sq, seqlen, leftpad);
  const Span last = visible_span(p, seqlen - 1, seqlen, leftpad);
  const Walk walk = walk_of(first, last);
  const int item0 = split_start(split, sp.num, walk.n);
  const int n_tiles = split_start(split + 1, sp.num, walk.n) - item0;

  const int wrow0 = kWarpKeys ? 0 : warp * 16;
  const bool warp_active = wrow0 < rows_total;
  const Rows rw = rows_of<D, kAlibi>(p, wrow0, g, b, seqlen, leftpad, gid);
  uint32_t qf[kKSteps][4];
  load_q<T, D>(p.q, rw.orow, qf, tig);
  float o[kOTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt) {
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums
  const Fold<kScaled> fold(p.ds, p.score_mul, b, g);

  auto score = [&](float x, int i, int col) {
    x = kSoftcap ? tanhf(x * fold.mul(p.score_mul)) * p.cap_log2
                 : x * fold.mul(p.score_mul);
    if (kAlibi) x -= rw.slope[i] * fabsf(static_cast<float>(col - rw.pos[i]));
    return x;
  };
  auto visible = [&](int i, int col) { return sees(rw.span[i], col); };
  auto page_of = [&](int pidx) {
    return p.pool.table ? __ldg(p.pool.table +
                                static_cast<long long>(b) * p.pool.max_pages +
                                pidx)
                        : cache_row;
  };
  const KV* kbase = static_cast<const KV*>(p.k) + g * p.pool.k_head;
  const KV* vbase = static_cast<const KV*>(p.v) + g * p.pool.v_head;
  auto load = [&](int it) {
    if (it < n_tiles) {
      load_kv_tile<T, D>(p.pool, kbase, vbase, sK, sV, page_of, seqlen,
                         walk.tile(item0 + it), it % kSplitStages, tid);
    }
    cp_async_commit();
  };
  load(0);
  load(1);
  const int key0 = kWarpKeys ? warp * kKeys : 0;  // this warp's keys
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_1();  // tile it has landed (it + 1 may be in flight)
    __syncthreads();    // ... for every thread; stage (it + 2) % 3 is free
    load(it + 2);
    if (warp_active) {
      const int srow = (it % kSplitStages) * kTileN + key0;
      const KV* ks_ptr = sK + srow * kStride;
      const KV* vs_ptr = sV + srow * kStride;
      const int col0 = walk.tile(item0 + it) * kTileN + key0;
      // Every row sees all of this warp's keys of the tile: no mask.
      const bool whole =
          (last.lo1 <= col0 && col0 + kKeys <= first.hi1) ||
          (last.lo2 <= col0 && col0 + kKeys <= first.hi2);
      if (whole) {
        tile_step<T, D, false, kKeys>(ks_ptr, vs_ptr, col0, qf, o, m, l,
                                      score, visible, gid, tig);
      } else {
        tile_step<T, D, true, kKeys>(ks_ptr, vs_ptr, col0, qf, o, m, l,
                                     score, visible, gid, tig);
      }
    }
  }

  // One split writes out and lse with the sink; more write fp32 partials
  // without it.
  const float* sink = sp.num == 1 ? p.sink : nullptr;
  // This split's rows of the partials (row = (b * sq + t) * h + head).
  const long long part = static_cast<long long>(split) * gridDim.z * p.sq * p.h;
  if constexpr (kWarpKeys) {
    // Merge the four warps' (m, l, O) through shared memory, once every
    // copy has landed and every warp is done with the tiles.
    cp_async_wait_0();
    __syncthreads();
    float* sO = reinterpret_cast<float*>(smem_raw);  // [4][16][D]
    float* sM = sO + kWarps * kKeyRows * D;          // [4][16]
    float* sL = sM + kWarps * kKeyRows;              // [4][16]
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = gid + 8 * i;
      const float lsum = quad_sum(l[i]);
      if (tig == 0) {
        sM[warp * kKeyRows + r] = m[i];
        sL[warp * kKeyRows + r] = lsum;
      }
      float* dst = sO + (warp * kKeyRows + r) * D + tig * 2;
#pragma unroll
      for (int nt = 0; nt < kOTiles; ++nt) {
        *reinterpret_cast<float2*>(dst + nt * 8) =
            make_float2(o[nt][2 * i], o[nt][2 * i + 1]);
      }
    }
    __syncthreads();
    // Thread tid: row tid / 8, columns (tid % 8) * D / 8 ...
    constexpr int kCols = D / 8;
    const int r = tid >> 3;
    const int c0 = (tid & 7) * kCols;
    if (r >= rows_total) return;
    float mw[kWarps];
    float mx = kMask;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = sM[w * kKeyRows + r];
      mx = fmaxf(mx, mw[w]);
    }
    float lsum = 0.f;
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(mw[w] - mx);
      lsum += sL[w * kKeyRows + r] * f;
      const float* src = sO + (w * kKeyRows + r) * D + c0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] += src[c] * f;
    }
    const int t = r / p.group;
    const int head = g * p.group + r % p.group;
    const long long orow =
        ((static_cast<long long>(b) * p.sq + t) * p.h + head) * D + c0;
    const int lrow = (b * p.h + head) * p.sq + t;
    float inv, lse;
    row_result(mx, lsum, sink, head, inv, lse);
    fold.scale(inv);
    if (sp.num == 1) {
      T* out = static_cast<T*>(p.out) + orow;
#pragma unroll
      for (int c = 0; c < kCols; c += 2) {
        *reinterpret_cast<uint32_t*>(out + c) =
            Mma<T>::pack(acc[c] * inv, acc[c + 1] * inv);
      }
      if ((tid & 7) == 0) p.lse[lrow] = lse;
    } else {
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        *reinterpret_cast<float4*>(sp.o_part + part * D + orow + c) =
            make_float4(acc[c] * inv, acc[c + 1] * inv, acc[c + 2] * inv,
                        acc[c + 3] * inv);
      }
      if ((tid & 7) == 0) sp.lse_part[part + lrow] = lse;
    }
  } else {
    if (!warp_active) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lsum = quad_sum(l[i]);
      if (rw.orow[i] < 0) continue;
      float inv, lse;
      row_result(m[i], lsum, sink, rw.head[i], inv, lse);
      fold.scale(inv);
      if (sp.num == 1) {
        store_row<T, D>(static_cast<T*>(p.out) + rw.orow[i], o, i, inv, tig);
        if (tig == 0) p.lse[rw.lse_idx[i]] = lse;
      } else {
        float* dst = sp.o_part + part * D + rw.orow[i] + tig * 2;
#pragma unroll
        for (int nt = 0; nt < kOTiles; ++nt) {
          *reinterpret_cast<float2*>(dst + nt * 8) =
              make_float2(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
        }
        if (tig == 0) sp.lse_part[part + rw.lse_idx[i]] = lse;
      }
    }
  }
}

// Merges the split kernel's partials in split order: one warp per (batch
// row, query token, head) row, out (b, sq, h, D) in T and lse (b, h, sq).
// A learnable sink (`sink` not null) is one more partial whose output is 0
// and whose LSE is sink[head]. A row whose every partial is empty (lse
// -inf) gives out 0 and lse -inf, or lse = sink.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* o_part, const float* lse_part,
                          const float* sink, T* out, float* lse, int num,
                          int rows, int sq, int h) {
  constexpr int kPer = D / 32;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int head = row % h;
  const int bt = row / h;  // b * sq + t
  const int lrow = ((bt / sq) * h + head) * sq + bt % sq;
  const float ls_sink = sink ? sink[head] : -INFINITY;
  float mx = ls_sink;
  for (int s = 0; s < num; ++s) mx = fmaxf(mx, lse_part[s * rows + lrow]);
  float acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc[c] = 0.f;
  float den = 0.f;
  if (mx > -INFINITY) {
    for (int s = 0; s < num; ++s) {
      const float ls = lse_part[s * rows + lrow];
      const float w = ls > -INFINITY ? expf(ls - mx) : 0.f;
      den += w;
      const float* src =
          o_part + (static_cast<long long>(s) * rows + row) * D + lane * kPer;
#pragma unroll
      for (int c = 0; c < kPer; ++c) acc[c] += w * src[c];
    }
    if (sink) den += expf(ls_sink - mx);
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  T* dst = out + static_cast<long long>(row) * D + lane * kPer;
#pragma unroll
  for (int c = 0; c < kPer; c += 2) {
    *reinterpret_cast<uint32_t*>(dst + c) =
        Mma<T>::pack(acc[c] * inv, acc[c + 1] * inv);
  }
  if (lane == 0) lse[lrow] = den > 0.f ? mx + logf(den) : -INFINITY;
}

template <typename T, int D, bool kSoftcap, bool kAlibi, typename KV,
          bool kScaled>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(sizeof(KV));
  const cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D, kSoftcap, kAlibi, KV, kScaled>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq * p.group + kRowsPerBlock - 1) / kRowsPerBlock, p.hk,
                  batch);
  decode_kernel<T, D, kSoftcap, kAlibi, KV, kScaled>
      <<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kSoftcap, bool kAlibi, typename KV,
          bool kScaled>
int launch_split(const Params& p, const Splits& sp, int batch,
                 cudaStream_t stream) {
  const size_t smem =
      kSplitStages * 2 * kTileN * row_stride<D>(sizeof(KV)) * sizeof(KV);
  void (*kernel)(const Params, const Splits) =
      p.sq * p.group <= kKeyRows
          ? decode_split_kernel<T, D, kSoftcap, kAlibi, true, KV, kScaled>
          : decode_split_kernel<T, D, kSoftcap, kAlibi, false, KV, kScaled>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(sp.num, p.hk, batch), kThreads, smem, stream>>>(p, sp);
  return static_cast<int>(cudaGetLastError());
}

// One instantiation's template arguments, as a type.
template <typename T_, int D_, bool kSoftcap_, bool kAlibi_>
struct Inst {
  using T = T_;
  static constexpr int D = D_;
  static constexpr bool kSoftcap = kSoftcap_;
  static constexpr bool kAlibi = kAlibi_;
};

template <typename T, int D, typename F>
int with_flags(bool softcap, bool alibi, F f) {
  if (softcap) {
    return alibi ? f(Inst<T, D, true, true>()) : f(Inst<T, D, true, false>());
  }
  return alibi ? f(Inst<T, D, false, true>()) : f(Inst<T, D, false, false>());
}

// f(Inst<T, D, softcap, alibi>()) for the call's type, head dim and flags;
// -1 for an unsupported head dim.
template <typename F>
int dispatch(int is_fp16, int d, bool softcap, bool alibi, F f) {
  if (d != 64 && d != 128) return -1;
  if (is_fp16) {
    return d == 64 ? with_flags<__half, 64>(softcap, alibi, f)
                   : with_flags<__half, 128>(softcap, alibi, f);
  }
  return d == 64 ? with_flags<__nv_bfloat16, 64>(softcap, alibi, f)
                 : with_flags<__nv_bfloat16, 128>(softcap, alibi, f);
}

Params make_params(const void* q, const void* k, const void* v, void* out,
                   float* lse, const int* seqlens, const int* table,
                   const int* batch_idx, const int* leftpad,
                   const float* slopes, int slopes_bstride, const float* sink,
                   int sq, int h, int hk, int page, int max_pages, int npages,
                   const long long* pool_strides, float scale, int causal,
                   int window_left, int chunk, int sink_tokens,
                   float softcap) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.seqlens = seqlens;
  p.pool = make_pool(table, page, max_pages, npages, pool_strides);
  p.batch_idx = batch_idx;
  p.leftpad = leftpad;
  p.slopes = slopes;
  p.slopes_bstride = slopes_bstride;
  p.sink = sink;
  p.sq = sq;
  p.h = h;
  p.hk = hk;
  p.group = h / hk;
  const bool has_softcap = softcap > 0.f;
  p.score_mul = has_softcap ? scale / softcap : scale * kLog2e;
  p.cap_log2 = softcap * kLog2e;
  p.causal = causal;
  p.window_left = window_left;
  p.chunk = chunk;
  p.sink_tokens = sink_tokens;
  return p;
}

// The C entries of one cache kind (kKind: q's own type, int8 or e4m3) and
// scaling (kScaled: the cache comes with K/V descales, which a 1-byte one
// always does). Each kind is built from its own source file
// (decode.cu: q's type, unscaled; decode_scaled.cu; decode_int8.cu;
// decode_e4m3.cu), so that their instantiations compile in parallel.
//
// pool_strides: 6 element strides, (page, head, slot) of the K cache, then
// of the V cache; a contiguous cache passes table = null, page = smax,
// max_pages = 1 and npages = its number of rows. (page - 1) * slot stride
// + 8 * d must fit in an int. Null pointers leave a feature off. kv_code
// must be this source's kind; k_scale and v_scale are the descales, (hk,)
// with scale_bstride 0 or (b, hk) with scale_bstride hk, null for an
// unscaled source. Returns 0, a cudaError_t from the launch, -1 for an
// unsupported head dim, or -4 for another cache kind or missing descales.
// Launches on `stream`; does not synchronise.
template <int kKind, bool kScaled>
int decode_fwd_impl(const Params& p, int batch, int d, int is_fp16,
                    bool softcap, int kv_code, cudaStream_t s) {
  if (kv_code != kKind || (kScaled && (!p.ds.k || !p.ds.v))) return -4;
  return dispatch(is_fp16, d, softcap, p.slopes != nullptr, [&](auto c) {
    using C = decltype(c);
    using T = typename C::T;
    using KV = typename KvType<T, kKind>::type;
    return launch<T, C::D, C::kSoftcap, C::kAlibi, KV, kScaled>(p, batch, s);
  });
}

// decode_fwd's function through the split-KV kernel, for calls of at most
// 64 packed rows (sq * h / hk), over num_splits splits of the walk: with
// one it writes out and lse; with more it writes o_part (num_splits, b, sq,
// h, d) and lse_part (num_splits, b, h, sq), fp32, the sink left out, and
// the combine kernel merges them into out and lse. Returns as decode_fwd,
// or -3 for rows or splits the kernel does not take.
template <int kKind, bool kScaled>
int decode_split_fwd_impl(const Params& p, const Splits& sp, int batch,
                          int d, int is_fp16, bool softcap, int kv_code,
                          cudaStream_t s) {
  if (p.sq * p.group > kRowsPerBlock || sp.num < 1 ||
      (sp.num > 1 && (!sp.o_part || !sp.lse_part))) {
    return -3;
  }
  if (kv_code != kKind || (kScaled && (!p.ds.k || !p.ds.v))) return -4;
  return dispatch(is_fp16, d, softcap, p.slopes != nullptr, [&](auto c) {
    using C = decltype(c);
    using T = typename C::T;
    using KV = typename KvType<T, kKind>::type;
    const int rc = launch_split<T, C::D, C::kSoftcap, C::kAlibi, KV, kScaled>(
        p, sp, batch, s);
    if (rc != 0 || sp.num == 1) return rc;
    const int rows = batch * p.sq * p.h;
    decode_combine_kernel<T, C::D>
        <<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
            sp.o_part, sp.lse_part, p.sink, static_cast<T*>(p.out), p.lse,
            sp.num, rows, p.sq, p.h);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Defines the two C entries, decode_fwd and decode_split_fwd, of one cache
// kind in the source that includes this header.
#define FA_DECODE_ENTRY_POINTS(KIND, SCALED)                                   \
  extern "C" int decode_fwd(                                                   \
      const void* q, const void* k, const void* v, void* out, float* lse,     \
      const int* seqlens, const int* table, const int* batch_idx,             \
      const int* leftpad, const float* slopes, int slopes_bstride,            \
      const float* sink, int batch, int sq, int h, int hk, int d, int page,   \
      int max_pages, int npages, const long long* pool_strides, float scale,  \
      int causal, int window_left, int chunk, int sink_tokens, float softcap, \
      int is_fp16, int kv_code, const float* k_scale, const float* v_scale,   \
      int scale_bstride, void* stream) {                                       \
    Params p = make_params(q, k, v, out, lse, seqlens, table, batch_idx,      \
                           leftpad, slopes, slopes_bstride, sink, sq, h, hk,  \
                           page, max_pages, npages, pool_strides, scale,      \
                           causal, window_left, chunk, sink_tokens, softcap); \
    p.ds = Descales{k_scale, v_scale, scale_bstride};                         \
    return decode_fwd_impl<KIND, SCALED>(p, batch, d, is_fp16, softcap > 0.f, \
                                         kv_code,                             \
                                         static_cast<cudaStream_t>(stream)); \
  }                                                                            \
  extern "C" int decode_split_fwd(                                             \
      const void* q, const void* k, const void* v, void* out, float* lse,     \
      const int* seqlens, const int* table, const int* batch_idx,             \
      const int* leftpad, const float* slopes, int slopes_bstride,            \
      const float* sink, int batch, int sq, int h, int hk, int d, int page,   \
      int max_pages, int npages, const long long* pool_strides, float scale,  \
      int causal, int window_left, int chunk, int sink_tokens, float softcap, \
      int is_fp16, int kv_code, const float* k_scale, const float* v_scale,   \
      int scale_bstride, float* o_part, float* lse_part, int num_splits,      \
      void* stream) {                                                          \
    Params p = make_params(q, k, v, out, lse, seqlens, table, batch_idx,      \
                           leftpad, slopes, slopes_bstride, sink, sq, h, hk,  \
                           page, max_pages, npages, pool_strides, scale,      \
                           causal, window_left, chunk, sink_tokens, softcap); \
    p.ds = Descales{k_scale, v_scale, scale_bstride};                         \
    return decode_split_fwd_impl<KIND, SCALED>(                               \
        p, Splits{o_part, lse_part, num_splits}, batch, d, is_fp16,           \
        softcap > 0.f, kv_code, static_cast<cudaStream_t>(stream));           \
  }
