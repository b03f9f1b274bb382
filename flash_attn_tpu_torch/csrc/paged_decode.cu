// Paged causal attention of new query tokens against a paged KV pool:
// decode steps (sq = 1) and chunked-prefill steps (sq = prefill_chunk).
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_decode_multipage.py:65
// (_mp_decode_kernel, launched at :542 by flash_attention_decode_multipage).
// It computes the same function; the TPU schedule (super-block DMA ring,
// SMEM slot parity, byte-count semaphore waits, lane-replicated m/l
// scratch, row budgets) is not carried over.
//
// Function. Query row r of kv head g is query token t = r / group of query
// head g * group + r % group ("PackGQA": the group's heads share every K/V
// tile). Its absolute position is pos = seqlen - sq + t. Column c is
// visible iff c < seqlen, c <= pos and, with a window, c >= pos - window.
// Scores are s * scale, or tanh(s * scale / softcap) * softcap. Online
// softmax in fp32 (base 2); out = acc / l in q's type, lse = m + ln(l) in
// fp32, and a row with no visible column gives out 0 and lse -inf. Token c
// lives in page block_table[b, c / page_size], slot c % page_size.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): a decode step
// must read every visible K and V row once, hk * (d + dv) * 2 bytes per
// token, so it is bound by bytes. A prefill chunk does 4 * d flops for each
// visible (query head, query token, column) triple, at most
// 4 * sq * ctx * h * d, and is bound by the larger of its bytes at
// 3.35 TB/s and those flops at 989 TFLOP/s.
//
// A 1-byte pool (int8 or e4m3, decode_tile.cuh) is read at half the bytes
// and upcast to q's type fragment by fragment; its per-kv-head (or per
// batch row and kv head) K descale folds into the score multiplier and its
// V descale into the output scale, as the TPU kernel does
// (flash_decode_multipage.py:268 and :315-316); a split multiplies its own
// partial, the combine nothing. Bound: hk * (d + dv) bytes per token.
//
// Design. One block of 4 warps per (64 packed rows, kv head, batch row);
// each warp owns 16 rows. Q stays in registers as mma.sync A fragments.
// The block walks the visible KV range of its rows (from the window's first
// visible column, not from 0) in tiles of 64 tokens: K and V rows are
// gathered page by page through the block table straight into shared
// memory with 16-byte cp.async copies, double-buffered so the next tile
// loads while this one computes. S = Q K^T and O += P V run on
// mma.sync.m16n8k16 (bf16/fp16 in, fp32 accumulate), P is re-packed from
// the S accumulators without touching shared memory. Columns past the
// sequence, and pages outside the pool, are zero-filled rather than read.
// The pools are read through their (page, head, slot) strides, so vLLM's
// (num_blocks, page, hk, d) "phd" pools, viewed head-major as (num_blocks,
// hk, page, d), are taken without a copy, as are the two halves of a fused
// K|V pool. The loader and the walk are decode_tile.cuh's, shared with
// the general decode kernel (decode.cu). The tile step is written out
// here: through the general kernel's step function (a functor for the
// score and one for the mask) it compiled to 171 registers instead of 205
// at d = 128 and ran 1.25-1.4x slower (PERF.md).
//
// That kernel keeps warps on rows, which suits prefill chunks (sq = 256:
// 1024 packed rows). A decode step has sq * group <= 16 packed rows (4 at
// sq = 1 with a group of 4): one warp's worth, and b * hk blocks (64 at
// b = 8, hk = 8) for 132 SMs. Such calls go to the split-KV kernel below:
//  * one block per (split, kv head, batch row). The host picks num_splits
//    from what it knows without reading the device (batch, kv heads, the
//    longest context the table can hold, the window, the SM count;
//    kernels/flash_decode_multipage.py `num_splits_for`): enough blocks for
//    two per SM, at least 256 tokens a split. Each block derives its chunk
//    from the device-side seqlen: the visible range (from the window's first
//    visible column, not from 0) in 64-token tiles, split s taking tiles
//    [s n / S, (s + 1) n / S) of the n, so the chunks cover the range once;
//  * every warp at work: the block's 16 rows sit in every warp's Q
//    fragments, and each warp takes its own 16 keys of every 64-token tile
//    (S, online softmax and P V on mma.sync), so all four share the tile's
//    bytes; their (m, l, O) merge through shared memory at the end;
//  * a ring of three tile stages, two tiles in flight while one computes
//    (~64 KB per block in flight, two blocks per SM);
//  * with num_splits == 1 the block writes out and lse itself; otherwise it
//    writes its fp32 partial O (normalised by its own sum) and its LSE (-inf
//    for a chunk with no visible column), and a second kernel merges the
//    partials in split order, with no atomics, as the JAX package's
//    combine_partials (flash_attn_tpu/kernels/flash_decode.py:648) does.

#include "decode_tile.cuh"

namespace {

using namespace fa;
using namespace fa::decode;

struct Params {
  const void* q;      // (b, sq, h, d)
  const void* k;      // K pool, read through pool's strides
  const void* v;      // V pool likewise
  void* out;          // (b, sq, h, d)
  float* lse;         // (b, h, sq)
  const int* seqlens; // (b,) total lengths, new tokens included
  KvPool pool;        // its table (b, max_pages) is never null here
  int sq, h, hk, group;
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2
  // with a softcap (score_mul = scale / softcap, cap_log2 = softcap*log2 e).
  float score_mul, cap_log2;
  bool has_softcap;
  int window_left;
  Descales ds;  // a 1-byte pool's (read only by the 1-byte instances)
};

template <typename T, int D, typename KV>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const Params p) {
  // padded smem row: conflict-free fragments
  constexpr int kStride = row_stride<D>(sizeof(KV));
  constexpr int kKSteps = D / 16;
  constexpr int kOTiles = D / 8;
  constexpr int kNTiles = kTileN / 8;
  constexpr bool kQuant = sizeof(KV) == 1;
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

  // Visible KV range of this block's rows.
  const int row_last = min(row0 + kRowsPerBlock, rows_total) - 1;
  const int pos_first = seqlen - p.sq + row0 / p.group;
  const int pos_last = seqlen - p.sq + row_last / p.group;
  const int kv_lo = p.window_left >= 0 ? max(pos_first - p.window_left, 0) : 0;
  const int kv_hi = min(seqlen, pos_last + 1);
  const int tile_lo = kv_lo / kTileN;
  const int n_tiles =
      kv_hi > kv_lo ? (kv_hi - tile_lo * kTileN + kTileN - 1) / kTileN : 0;

  // This thread's two rows: gid and gid + 8 of the warp's 16.
  const int wrow0 = row0 + warp * 16;
  const bool warp_active = wrow0 < rows_total;
  int pos[2];
  long long orow[2];
  int lse_idx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow0 + gid + 8 * i;
    if (r < rows_total) {
      const int t = r / p.group;
      const int head = g * p.group + r % p.group;
      pos[i] = seqlen - p.sq + t;
      orow[i] = ((static_cast<long long>(b) * p.sq + t) * p.h + head) * D;
      lse_idx[i] = (b * p.h + head) * p.sq + t;
    } else {
      pos[i] = -1;  // sees no column; never stored
      orow[i] = -1;
      lse_idx[i] = -1;
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
  const Fold<kQuant> fold(p.ds, p.score_mul, b, g);  // a 1-byte pool's

  auto page_of = [&](int pidx) {
    return __ldg(p.pool.table + static_cast<long long>(b) * p.pool.max_pages +
                 pidx);
  };
  walk_kv<T, D>(
      p.pool, g, page_of, seqlen, p.k, p.v, sK, sV, n_tiles,
      [&](int it) { return tile_lo + it; }, warp_active,
      [&](const auto* ks_ptr, const auto* vs_ptr, int col0) {
        // The tile's elements: KV, or T upcast from a 1-byte pool.
        using E = std::remove_cv_t<std::remove_pointer_t<decltype(ks_ptr)>>;
        constexpr int kTS = row_stride<D>(sizeof(E));
        float s[kNTiles][4];
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          const E* krow = ks_ptr + (nt * 8 + gid) * kTS + tig * 2;
#pragma unroll
          for (int ks = 0; ks < kKSteps; ++ks) {
            const uint32_t b0 = Frag<T, E>::k2(krow + ks * 16);
            const uint32_t b1 = Frag<T, E>::k2(krow + ks * 16 + 8);
            Mma<T>::run(s[nt], qf[ks], b0, b1);
          }
        }

        // Scale (base 2), softcap, mask; visibility kept as bits.
        uint32_t vis = 0;
        float tmax[2] = {kMask, kMask};
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int col = col0 + nt * 8 + tig * 2 + (e & 1);
            float x = s[nt][e];
            x = p.has_softcap ? tanhf(x * fold.mul(p.score_mul)) * p.cap_log2
                              : x * fold.mul(p.score_mul);
            const bool ok = col < seqlen && col <= pos[i] &&
                            (p.window_left < 0 || col >= pos[i] - p.window_left);
            if (ok) {
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
            const float pe =
                (vis >> (nt * 4 + e)) & 1u ? exp2f(s[nt][e] - m[i]) : 0.f;
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
          const E* vrow = vs_ptr + (kk * 16 + tig * 2) * kTS + gid;
#pragma unroll
          for (int nt = 0; nt < kOTiles; ++nt) {
            const E* vc = vrow + nt * 8;
            const uint32_t b0 = Frag<T, E>::v2(vc, vc + kTS);
            const uint32_t b1 =
                Frag<T, E>::v2(vc + 8 * kTS, vc + 9 * kTS);
            Mma<T>::run(o[nt], a, b0, b1);
          }
        }
      },
      tid);

  if (!warp_active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    if (orow[i] < 0) continue;
    float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    fold.scale(inv);
    store_row<T, D>(static_cast<T*>(p.out) + orow[i], o, i, inv, tig);
    if (tig == 0) {
      p.lse[lse_idx[i]] =
          lsum > 0.f ? (m[i] + log2f(lsum)) * kLn2 : -INFINITY;
    }
  }
}

constexpr int kSplitRows = 16;  // packed rows of a split-KV block
constexpr int kSplitStages = 3;

__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Partial results of the split-KV kernel: o_part (num_splits, b, sq, h, d)
// and lse_part (num_splits, b, h, sq), fp32; unused with one split.
struct Splits {
  float* o_part;
  float* lse_part;
  int num;
};

// Tiles [first, last) of the n_tiles visible ones that split s of n takes.
__device__ __forceinline__ int split_start(int s, int n, int n_tiles) {
  return static_cast<int>(static_cast<long long>(s) * n_tiles / n);
}

template <typename T, int D, bool kSoftcap, typename KV>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const Params p, const Splits sp) {
  // padded smem row: conflict-free fragments
  constexpr int kStride = row_stride<D>(sizeof(KV));
  constexpr int kKSteps = D / 16;
  constexpr int kOTiles = D / 8;
  constexpr bool kQuant = sizeof(KV) == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* sK = reinterpret_cast<KV*>(smem_raw);         // [3][kTileN][kStride]
  KV* sV = sK + kSplitStages * kTileN * kStride;    // [3][kTileN][kStride]

  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rows_total = p.sq * p.group;  // <= kSplitRows
  const int seqlen = p.seqlens[b];

  // The visible range of all rows, in tiles, and this split's share.
  const int pos_first = seqlen - p.sq;
  const int kv_lo = p.window_left >= 0 ? max(pos_first - p.window_left, 0) : 0;
  const int kv_hi = seqlen;
  const int tile_lo = kv_lo / kTileN;
  const int n_all =
      kv_hi > kv_lo ? (kv_hi - tile_lo * kTileN + kTileN - 1) / kTileN : 0;
  const int first = tile_lo + split_start(split, sp.num, n_all);
  const int n_tiles = tile_lo + split_start(split + 1, sp.num, n_all) - first;

  // This thread's two rows, gid and gid + 8, in every warp.
  int pos[2];
  long long orow[2];
  int lse_idx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = gid + 8 * i;
    if (r < rows_total) {
      const int t = r / p.group;
      const int head = g * p.group + r % p.group;
      pos[i] = seqlen - p.sq + t;
      orow[i] = ((static_cast<long long>(b) * p.sq + t) * p.h + head) * D;
      lse_idx[i] = (b * p.h + head) * p.sq + t;
    } else {
      pos[i] = -1;  // sees no column; never stored
      orow[i] = -1;
      lse_idx[i] = -1;
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
  // A 1-byte pool's descales; V's scales this split's output.
  const Fold<kQuant> fold(p.ds, p.score_mul, b, g);

  const KV* kbase = static_cast<const KV*>(p.k) + g * p.pool.k_head;
  const KV* vbase = static_cast<const KV*>(p.v) + g * p.pool.v_head;
  auto page_of = [&](int pidx) {
    return __ldg(p.pool.table + static_cast<long long>(b) * p.pool.max_pages +
                 pidx);
  };
  auto load = [&](int it) {
    if (it < n_tiles) {
      load_kv_tile<T, D>(p.pool, kbase, vbase, sK, sV, page_of, seqlen,
                         first + it, it % kSplitStages, tid);
    }
    cp_async_commit();
  };
  load(0);
  load(1);
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_1();  // tile it has landed (it + 1 may be in flight)
    __syncthreads();    // ... for every thread; stage (it + 2) % 3 is free
    load(it + 2);
    const KV* ks_ptr = sK + (it % kSplitStages) * kTileN * kStride + warp * 16 * kStride;
    const KV* vs_ptr = sV + (it % kSplitStages) * kTileN * kStride + warp * 16 * kStride;
    const int col0 = (first + it) * kTileN + warp * 16;

    // S: this warp's 16 keys of the tile.
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const KV* krow = ks_ptr + (nt * 8 + gid) * kStride + tig * 2;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        Mma<T>::run(s[nt], qf[ks], Frag<T, KV>::k2(krow + ks * 16),
                    Frag<T, KV>::k2(krow + ks * 16 + 8));
      }
    }
    // Scale (base 2), softcap, mask; visibility kept as bits.
    uint32_t vis = 0;
    float tmax[2] = {kMask, kMask};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = col0 + nt * 8 + tig * 2 + (e & 1);
        float x = s[nt][e];
        x = kSoftcap ? tanhf(x * fold.mul(p.score_mul)) * p.cap_log2
                 : x * fold.mul(p.score_mul);
        const bool ok = col < seqlen && col <= pos[i] &&
                        (p.window_left < 0 || col >= pos[i] - p.window_left);
        if (ok) {
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
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float pe =
            (vis >> (nt * 4 + e)) & 1u ? exp2f(s[nt][e] - m[i]) : 0.f;
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
    // O += P V over the warp's 16 keys.
    uint32_t a[4];
    a[0] = Mma<T>::pack(s[0][0], s[0][1]);
    a[1] = Mma<T>::pack(s[0][2], s[0][3]);
    a[2] = Mma<T>::pack(s[1][0], s[1][1]);
    a[3] = Mma<T>::pack(s[1][2], s[1][3]);
    const KV* vrow = vs_ptr + tig * 2 * kStride + gid;
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt) {
      const KV* vc = vrow + nt * 8;
      Mma<T>::run(o[nt], a, Frag<T, KV>::v2(vc, vc + kStride),
                  Frag<T, KV>::v2(vc + 8 * kStride, vc + 9 * kStride));
    }
  }

  // Merge the four warps' (m, l, O) through shared memory, once every
  // copy has landed and every warp is done with the tiles.
  cp_async_wait_0();
  __syncthreads();
  float* sO = reinterpret_cast<float*>(smem_raw);  // [4][16][D]
  float* sM = sO + kWarps * kSplitRows * D;        // [4][16]
  float* sL = sM + kWarps * kSplitRows;            // [4][16]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = gid + 8 * i;
    const float lsum = quad_sum(l[i]);
    if (tig == 0) {
      sM[warp * kSplitRows + r] = m[i];
      sL[warp * kSplitRows + r] = lsum;
    }
    float* dst = sO + (warp * kSplitRows + r) * D + tig * 2;
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
    mw[w] = sM[w * kSplitRows + r];
    mx = fmaxf(mx, mw[w]);
  }
  float lsum = 0.f;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float f = exp2f(mw[w] - mx);
    lsum += sL[w * kSplitRows + r] * f;
    const float* src = sO + (w * kSplitRows + r) * D + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] += src[c] * f;
  }
  const int t = r / p.group;
  const int head = g * p.group + r % p.group;
  const long long orow_r =
      ((static_cast<long long>(b) * p.sq + t) * p.h + head) * D + c0;
  const int lrow = (b * p.h + head) * p.sq + t;
  float inv = lsum > 0.f ? 1.f / lsum : 0.f;
  fold.scale(inv);
  const float lse = lsum > 0.f ? (mx + log2f(lsum)) * kLn2 : -INFINITY;
  if (sp.num == 1) {
    T* out = static_cast<T*>(p.out) + orow_r;
#pragma unroll
    for (int c = 0; c < kCols; c += 2) {
      *reinterpret_cast<uint32_t*>(out + c) =
          Mma<T>::pack(acc[c] * inv, acc[c + 1] * inv);
    }
    if ((tid & 7) == 0) p.lse[lrow] = lse;
  } else {
    const long long rows_all = static_cast<long long>(gridDim.z) * p.sq * p.h;
    float* out = sp.o_part + split * rows_all * D + orow_r;
#pragma unroll
    for (int c = 0; c < kCols; c += 4) {
      *reinterpret_cast<float4*>(out + c) = make_float4(
          acc[c] * inv, acc[c + 1] * inv, acc[c + 2] * inv, acc[c + 3] * inv);
    }
    if ((tid & 7) == 0) sp.lse_part[split * rows_all + lrow] = lse;
  }
}

// Merges the partials of num_splits splits, in split order: one warp per
// (batch row, query token, head) row, out (b, sq, h, D) in T and lse
// (b, h, sq). A row whose every partial is empty (lse -inf) gives out 0 and
// lse -inf.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const float* o_part, const float* lse_part, T* out,
                         float* lse, int num, int rows, int sq, int h) {
  constexpr int kPer = D / 32;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int head = row % h;
  const int bt = row / h;  // b * sq + t
  const int lrow = ((bt / sq) * h + head) * sq + bt % sq;
  float mx = -INFINITY;
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

template <typename T, int D, bool kSoftcap, typename KV>
int launch_split(const Params& p, const Splits& sp, int batch,
                 cudaStream_t stream) {
  const size_t smem =
      kSplitStages * 2 * kTileN * row_stride<D>(sizeof(KV)) * sizeof(KV);
  const cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T, D, kSoftcap, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sp.num, p.hk, batch);
  paged_split_kernel<T, D, kSoftcap, KV>
      <<<grid, kThreads, smem, stream>>>(p, sp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, typename KV>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(sizeof(KV));
  const cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq * p.group + kRowsPerBlock - 1) / kRowsPerBlock, p.hk,
                  batch);
  paged_decode_kernel<T, D, KV><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One instantiation's q type, head dim and pool element type, as a type.
template <typename T_, int D_, typename KV_>
struct Inst {
  using T = T_;
  using KV = KV_;
  static constexpr int D = D_;
};

template <typename T, int D, typename F>
int with_kv(int kv_code, F f) {
  switch (kv_code) {
    case kKvSame:
      return f(Inst<T, D, T>());
    case kKvInt8:
      return f(Inst<T, D, int8_t>());
    case kKvE4m3:
      return f(Inst<T, D, __nv_fp8_e4m3>());
    default:
      return -4;
  }
}

// f(Inst<T, D, KV>()) for the call's q type, head dim and pool kind; -1 for
// an unsupported head dim, -4 for an unknown pool kind.
template <typename F>
int dispatch(int is_fp16, int d, int kv_code, F f) {
  if (d != 64 && d != 128) return -1;
  if (is_fp16) {
    return d == 64 ? with_kv<__half, 64>(kv_code, f)
                   : with_kv<__half, 128>(kv_code, f);
  }
  return d == 64 ? with_kv<__nv_bfloat16, 64>(kv_code, f)
                 : with_kv<__nv_bfloat16, 128>(kv_code, f);
}

}  // namespace

// pool_strides: 6 element strides, (page, head, slot) of the K pool, then
// of the V pool; (page - 1) * slot stride + 8 * d must fit in an int. Calls
// with sq * (h / hk) <= 16 packed rows run the split-KV kernel over
// num_splits splits: with one it writes out and lse, with more o_part
// (num_splits, b, sq, h, d) and lse_part (num_splits, b, h, sq), fp32, for
// paged_decode_combine. Other calls take num_splits == 1. kv_code: the
// pools hold q's type (0), int8 (1) or e4m3 (2); a 1-byte pool takes its
// K and V dequant scales, (hk,) with scale_bstride 0 or (b, hk) with
// scale_bstride hk. Returns 0, a cudaError_t from the launch, -1 for an
// unsupported head dim, -3 for splits the call cannot take, or -4 for an
// unknown pool kind or a 1-byte pool without scales. Launches on
// `stream`; does not synchronise.
extern "C" int paged_decode_fwd(const void* q, const void* k, const void* v,
                                void* out, float* lse, const int* seqlens,
                                const int* table, int batch, int sq, int h,
                                int hk, int d, int page, int max_pages,
                                int npages, const long long* pool_strides,
                                float scale, int window_left, float softcap,
                                int is_fp16, float* o_part, float* lse_part,
                                int num_splits, int kv_code,
                                const float* k_scale, const float* v_scale,
                                int scale_bstride, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.seqlens = seqlens;
  p.pool = make_pool(table, page, max_pages, npages, pool_strides);
  p.sq = sq;
  p.h = h;
  p.hk = hk;
  p.group = h / hk;
  p.has_softcap = softcap > 0.f;
  p.score_mul = p.has_softcap ? scale / softcap : scale * kLog2e;
  p.cap_log2 = softcap * kLog2e;
  p.window_left = window_left;
  p.ds = Descales{k_scale, v_scale, scale_bstride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Splits sp = {o_part, lse_part, num_splits};
  if (kv_code != kKvSame && (!k_scale || !v_scale)) return -4;
  const bool split = sq * p.group <= kSplitRows;
  if (split) {
    if (num_splits < 1 || (num_splits > 1 && (!o_part || !lse_part))) return -3;
  } else if (num_splits != 1) {
    return -3;
  }
  return dispatch(is_fp16, d, kv_code, [&](auto c) {
    using C = decltype(c);
    using T = typename C::T;
    using KV = typename C::KV;
    if (!split) return launch<T, C::D, KV>(p, batch, s);
    return p.has_softcap ? launch_split<T, C::D, true, KV>(p, sp, batch, s)
                         : launch_split<T, C::D, false, KV>(p, sp, batch, s);
  });
}

// Merges paged_decode_fwd's partials: o_part (num_splits, b, sq, h, d) and
// lse_part (num_splits, b, h, sq), fp32, into out (b, sq, h, d) in q's type
// and lse (b, h, sq). Returns 0, a cudaError_t, or -1 for an unsupported
// head dim.
extern "C" int paged_decode_combine(const float* o_part, const float* lse_part,
                                    void* out, float* lse, int num_splits,
                                    int batch, int sq, int h, int d,
                                    int is_fp16, void* stream) {
  const int rows = batch * sq * h;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != 64 && d != 128) return -1;
  if (is_fp16) {
    if (d == 64) {
      paged_combine_kernel<__half, 64><<<grid, kThreads, 0, s>>>(
          o_part, lse_part, static_cast<__half*>(out), lse, num_splits, rows,
          sq, h);
    } else {
      paged_combine_kernel<__half, 128><<<grid, kThreads, 0, s>>>(
          o_part, lse_part, static_cast<__half*>(out), lse, num_splits, rows,
          sq, h);
    }
  } else if (d == 64) {
    paged_combine_kernel<__nv_bfloat16, 64><<<grid, kThreads, 0, s>>>(
        o_part, lse_part, static_cast<__nv_bfloat16*>(out), lse, num_splits,
        rows, sq, h);
  } else {
    paged_combine_kernel<__nv_bfloat16, 128><<<grid, kThreads, 0, s>>>(
        o_part, lse_part, static_cast<__nv_bfloat16*>(out), lse, num_splits,
        rows, sq, h);
  }
  return static_cast<int>(cudaGetLastError());
}

// paged_decode_fwd, then, for a call of more than one split, its partials
// merged into out and lse by paged_decode_combine's kernel: a decode step
// in one call (o_part and lse_part are the caller's workspace). Returns as
// paged_decode_fwd does, or paged_decode_combine's code.
extern "C" int paged_decode_fwd_merged(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* seqlens, const int* table, int batch, int sq, int h, int hk,
    int d, int page, int max_pages, int npages, const long long* pool_strides,
    float scale, int window_left, float softcap, int is_fp16, float* o_part,
    float* lse_part, int num_splits, int kv_code, const float* k_scale,
    const float* v_scale, int scale_bstride, void* stream) {
  const int rc = paged_decode_fwd(
      q, k, v, out, lse, seqlens, table, batch, sq, h, hk, d, page, max_pages,
      npages, pool_strides, scale, window_left, softcap, is_fp16, o_part,
      lse_part, num_splits, kv_code, k_scale, v_scale, scale_bstride, stream);
  if (rc != 0 || num_splits == 1) return rc;
  return paged_decode_combine(o_part, lse_part, out, lse, num_splits, batch,
                              sq, h, d, is_fp16, stream);
}
