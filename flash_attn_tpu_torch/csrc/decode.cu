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
// Known gap: a decode step (sq = 1) gives b * hk blocks with one busy warp
// each, so it runs well under the bandwidth bound; split-KV with a combine
// pass is the fix, for a later change.

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

// One kv tile of one warp's 16 rows: S = Q K^T; x = score(s, i, col) (base
// 2) for row i (0: gid, 1: gid + 8) and column col; with kMasked only the
// entries where visible(i, col) holds; the online-softmax update of m, l
// and O += P V.
template <typename T, int D, bool kMasked, typename Score, typename Visible>
__device__ __forceinline__ void tile_step(const T* ks_ptr, const T* vs_ptr,
                                          int col0,
                                          const uint32_t (&qf)[D / 16][4],
                                          float (&o)[D / 8][4], float (&m)[2],
                                          float (&l)[2], Score score,
                                          Visible visible, int gid, int tig) {
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kNTiles = kTileN / 8;
  constexpr int kOTiles = D / 8;

  float s[kNTiles][4];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const T* krow = ks_ptr + (nt * 8 + gid) * kStride + tig * 2;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const uint32_t b0 = ld_u32(krow + ks * 16);
      const uint32_t b1 = ld_u32(krow + ks * 16 + 8);
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
  for (int kk = 0; kk < kTileN / 16; ++kk) {
    uint32_t a[4];
    a[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
    a[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
    a[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const T* vrow = vs_ptr + (kk * 16 + tig * 2) * kStride + gid;
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt) {
      const T* vc = vrow + nt * 8;
      const uint32_t b0 = pack_u16(vc, vc + kStride);
      const uint32_t b1 = pack_u16(vc + 8 * kStride, vc + 9 * kStride);
      Mma<T>::run(o[nt], a, b0, b1);
    }
  }
}

template <typename T, int D, bool kSoftcap, bool kAlibi>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Params p) {
  constexpr int kStride = D + 8;  // padded smem row: conflict-free fragments
  constexpr int kKSteps = D / 16;
  constexpr int kOTiles = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][kTileN][kStride]
  T* sV = sK + 2 * kTileN * kStride;       // [2][kTileN][kStride]

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
  // Tiles walked: those of the sink tokens, then the window's that are not
  // among them.
  int sink_lo = 0, sink_n = 0;
  if (last.hi2 > first.lo2) {
    sink_lo = first.lo2 / kTileN;
    sink_n = (last.hi2 + kTileN - 1) / kTileN - sink_lo;
  }
  int win_lo = first.lo1 / kTileN;
  const int win_hi =
      last.hi1 > first.lo1 ? (last.hi1 + kTileN - 1) / kTileN : win_lo;
  if (sink_n > 0) win_lo = max(win_lo, sink_lo + sink_n);
  const int n_tiles = sink_n + max(win_hi - win_lo, 0);
  auto tile_at = [&](int it) {
    return it < sink_n ? sink_lo + it : win_lo + (it - sink_n);
  };

  // This thread's two rows: gid and gid + 8 of the warp's 16.
  const int wrow0 = row0 + warp * 16;
  const bool warp_active = wrow0 < rows_total;
  Span span[2];
  int pos[2];
  int head[2];
  float slope[2];
  long long orow[2];
  int lse_idx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow0 + gid + 8 * i;
    if (r < rows_total) {
      const int t = r / p.group;
      head[i] = g * p.group + r % p.group;
      pos[i] = seqlen - p.sq + t;
      span[i] = visible_span(p, pos[i], seqlen, leftpad);
      orow[i] = ((static_cast<long long>(b) * p.sq + t) * p.h + head[i]) * D;
      lse_idx[i] = (b * p.h + head[i]) * p.sq + t;
      slope[i] = kAlibi ? p.slopes[b * p.slopes_bstride + head[i]] * kLog2e
                        : 0.f;
    } else {
      // Sees no column and is never stored; q = 0 keeps its scores finite
      // in unmasked tiles.
      span[i] = Span{0, 0, 0, 0};
      pos[i] = 0;
      head[i] = 0;
      orow[i] = -1;
      lse_idx[i] = -1;
      slope[i] = 0.f;
    }
  }

  uint32_t qf[kKSteps][4];
  load_q<T, D>(p.q, orow, qf, tig);
  float o[kOTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt) {
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  auto score = [&](float x, int i, int col) {
    x = kSoftcap ? tanhf(x * p.score_mul) * p.cap_log2 : x * p.score_mul;
    if (kAlibi) x -= slope[i] * fabsf(static_cast<float>(col - pos[i]));
    return x;
  };
  auto visible = [&](int i, int col) { return sees(span[i], col); };
  // A contiguous cache is one page per cache row.
  auto page_of = [&](int pidx) {
    return p.pool.table ? __ldg(p.pool.table +
                                static_cast<long long>(b) * p.pool.max_pages +
                                pidx)
                        : cache_row;
  };
  walk_kv<T, D>(
      p.pool, g, page_of, seqlen, p.k, p.v, sK, sV, n_tiles, tile_at,
      warp_active,
      [&](const T* ks_ptr, const T* vs_ptr, int col0) {
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
    if (orow[i] < 0) continue;
    float inv, lse;
    if (p.sink) {
      // Denominator sum + exp(sink), taken against max(m, sink).
      const float s2 = p.sink[head[i]] * kLog2e;
      const float mx = lsum > 0.f ? fmaxf(m[i], s2) : s2;
      const float corr = lsum > 0.f ? exp2f(m[i] - mx) : 0.f;
      const float denom = lsum * corr + exp2f(s2 - mx);
      inv = corr / denom;
      lse = (mx + log2f(denom)) * kLn2;
    } else {
      inv = lsum > 0.f ? 1.f / lsum : 0.f;
      lse = lsum > 0.f ? (m[i] + log2f(lsum)) * kLn2 : -INFINITY;
    }
    store_row<T, D>(static_cast<T*>(p.out) + orow[i], o, i, inv, tig);
    if (tig == 0) p.lse[lse_idx[i]] = lse;
  }
}

template <typename T, int D, bool kSoftcap, bool kAlibi>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(sizeof(T));
  const cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D, kSoftcap, kAlibi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq * p.group + kRowsPerBlock - 1) / kRowsPerBlock, p.hk,
                  batch);
  decode_kernel<T, D, kSoftcap, kAlibi><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_flags(const Params& p, int batch, bool softcap, bool alibi,
                 cudaStream_t stream) {
  if (softcap) {
    return alibi ? launch<T, D, true, true>(p, batch, stream)
                 : launch<T, D, true, false>(p, batch, stream);
  }
  return alibi ? launch<T, D, false, true>(p, batch, stream)
               : launch<T, D, false, false>(p, batch, stream);
}

}  // namespace

// pool_strides: 6 element strides, (page, head, slot) of the K cache, then
// of the V cache; a contiguous cache passes table = null, page = smax,
// max_pages = 1 and npages = its number of rows. (page - 1) * slot stride
// + 8 * d must fit in an int. Null pointers leave a feature off. Returns
// 0, a cudaError_t from the launch, or -1 for an unsupported head dim.
// Launches on `stream`; does not synchronise.
extern "C" int decode_fwd(const void* q, const void* k, const void* v,
                          void* out, float* lse, const int* seqlens,
                          const int* table, const int* batch_idx,
                          const int* leftpad, const float* slopes,
                          int slopes_bstride, const float* sink, int batch,
                          int sq, int h, int hk, int d, int page,
                          int max_pages, int npages,
                          const long long* pool_strides, float scale,
                          int causal, int window_left, int chunk,
                          int sink_tokens, float softcap, int is_fp16,
                          void* stream) {
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
  const bool alibi = slopes != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    if (d == 64) return launch_flags<__half, 64>(p, batch, has_softcap, alibi, s);
    if (d == 128) return launch_flags<__half, 128>(p, batch, has_softcap, alibi, s);
  } else {
    if (d == 64) {
      return launch_flags<__nv_bfloat16, 64>(p, batch, has_softcap, alibi, s);
    }
    if (d == 128) {
      return launch_flags<__nv_bfloat16, 128>(p, batch, has_softcap, alibi, s);
    }
  }
  return -1;
}
