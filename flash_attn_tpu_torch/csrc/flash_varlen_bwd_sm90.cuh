// Packed variable-length flash-attention backward for Hopper (kernels 7 and
// 8): dk, dv (kernel 7) and dq with delta = sum_j P dP (kernel 8) for nseq
// sequences packed along one token axis, from q, dO (total_q, h, d) or (h,
// total_q, d), k, v (total_k, hk, d) as q, and the forward's log-sum-exp
// (h, total_q).
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_varlen.py:883
// (_varlen_dkv_kernel, launched at :1739) and :1005 (_varlen_dq_kernel,
// launched at :1821), both called by flash_attention_varlen_bwd (:1508),
// restricted to the forward's features (csrc/flash_varlen_fwd_sm90.cuh):
// scale, bottom-right-aligned causal and sliding window per sequence (off =
// used_k - used_q), GQA/MQA, softcap, seqused_q/k, thd and hsd layouts, head
// dim 64 or 128, bf16/fp16.
//
// Function, kernels 2's and 3's (csrc/flash_bwd_sm90.cuh) per sequence:
// query row i of sequence b (rows from cu_q[b], rows = min(used_q, length))
// sees key j of its keys (from cu_k[b], keys = min(used_k, length)) iff,
// with diag = i + off, j >= diag - left (left >= 0) and j <= diag + right
// (right >= 0). P is recomputed from Q, K and the LSE (0 on rows whose LSE
// is -inf), dP = dO V^T, delta = sum_j P dP in fp32, dS = P (dP - delta)
// scale [(1 - t^2) with a softcap], dQ = sum dS K, dV = sum P^T dO, dK =
// sum dS^T Q (dK and dV summed over each kv head's group of query heads).
// Kernel 8 writes the rows below `rows` (zeros for a row that sees no key),
// kernel 7 the keys below `keys` of every key tile that some row sees; the
// others are not written (the wrapper zero-fills dq, delta, dk and dv).
// Kernel 7 reads kernel 8's delta unchanged.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): dK/dV 8 d
// flops per visible (query head, row, key) triple (S, dP, dV, dK), dQ 6 d
// (S, dP, dQ), against q, dO, k, v, the LSE (and delta) and the outputs
// moved once; kernel 8 does 10 d (S and dP twice). At training lengths both
// are bound by operations.
//
// Design: kernels 2's and 3's blocks and walks (dkv_range_walk and
// dq_range_walk of csrc/flash_bwd_sm90.cuh) on kernel 6's flat tile
// schedule (csrc/varlen_schedule.cuh), 128 keys or rows a tile.
//  * Blocks: two 64-row (kernel 8) or 64-key (kernel 7) wgmma warpgroups,
//    256 threads; thread 0 issues every TMA copy into a ring of kStages
//    stages with full and empty mbarriers (no producer warp: see
//    csrc/flash_bwd_sm90.cuh). Walked tiles are walk_tile(d, softcap) keys
//    (kernel 8) or query rows (kernel 7).
//  * Kernel 8: pass 1, S = Q K^T and dP = dO V^T from shared memory, delta
//    += P dP; pass 2, S and dP again, then dQ += dS K with dS as the
//    register A operand and K read N-major; S and dP of tile i are issued
//    before dQ of tile i - 1. A warpgroup whose 64 rows lie past the
//    sequence's end only takes the stages and releases them.
//  * Kernel 7: K and V of the 128-key tile loaded once; for each query head
//    of the kv head's group, the query tiles of this sequence that see
//    these keys, Q, dO, LSE and delta (1-D maps over the contiguous (h,
//    total_q) rows) through the ring; S^T = K Q^T and dP^T = V dO^T from
//    shared memory, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//    register A operands; dK and dV sum the group in fp32. The warpgroups
//    take turns to issue their products, as kernel 2's do.
//  * Schedule (csrc/varlen_schedule.cuh, shared with kernel 6): grid.x =
//    (total + nseq * 127) / 128 tiles per head (query heads for kernel 8,
//    kv heads for kernel 7), each block finding its sequence and tile by a
//    block-wide scan of cu_q / used_q (kernel 8: the sequence's last row
//    tile first) or cu_k / used_k (kernel 7: its first key tile, the longest
//    causal walk, first) before the warpgroups split; a block past the last
//    tile exits. No host read.
//  * Inputs: Q, dO, K and V by TMA (4-D maps over (d, token, head) through
//    the callers' strides) at token cu_q[b] + row and cu_k[b] + key. Rows
//    past a sequence's end are the next sequence's rows and keys past its
//    used keys are its own or the next one's, not TMA's zeros (those only
//    cover the tensor's end): rows past `rows` take lse +inf (P = 0), every
//    tile that holds the sequence's last key or row takes the mask, and the
//    outputs go out by per-row guarded stores (a whole-tile store would
//    overwrite the neighbour's rows). A key tile that no row sees (a window,
//    sk > sq, rows 0) issues nothing and stores nothing.
// Deterministic: no atomics; every output element is summed by one thread
// in a fixed order and written once.
//
// Features (csrc/attn_features.cuh, the varlen rules), in instances of
// their own (kFeat != 0, launched from csrc/flash_varlen_bwd_features.cu):
// the range structs SeqFeatRange and SeqFeatDkvRange carry ALiBi,
// attention_chunk and dropout into the shared walks, as kernels 2-3's
// carry theirs. P is recomputed with the ALiBi term after the softcap and
// the chunk's visibility; with dropout the keep mask Z (batch row 0, the
// packed row and key) gives dV from P Z / (1 - p) and dP Z / (1 - p) for
// delta (kernel 8's first pass) and dS. Kernel 8 narrows its key walk to
// its rows' chunks and walks 64-key tiles (dq_walk_tile), kernel 7 narrows
// its query walk to the rows whose chunks hold its keys. The feature-free
// instances compile as they did.

#pragma once

#include <type_traits>

#include "flash_bwd_sm90.cuh"
#include "varlen_schedule.cuh"

namespace fa {
namespace vbwd90 {

using namespace fa::sm90;
using fa::bwd90::dkv_range_walk;
using fa::bwd90::DkvShared;
using fa::bwd90::dq_range_walk;
using fa::bwd90::DqShared;
using fa::bwd90::kBlockRows;
using fa::bwd90::kThreads;
using fa::bwd90::kWarpgroups;
using fa::bwd90::lse_base2;
using fa::bwd90::prob_alibi;
using fa::bwd90::set_smem;
using fa::bwd90::store_rows;
using fa::bwd90::walk_tile;

// The block's sequence and walk, in shared memory (see the kernel).
enum Slot { kQ0, kK0, kRows, kKeys, kOff, kTileLo, kNTiles, kSlots };

// The block for dq_range_walk: its walk and lengths, read from the slots
// where they are used. A warpgroup whose rows start past the sequence's
// end (the tail of its last row tile; never the warpgroup of thread 0)
// only takes the stages and releases them. Keys past `keys` are the next
// sequence's, so every tile that holds the last key takes the mask.
struct SeqRange {
  static constexpr bool kSkipEmpty = true;
  static constexpr int kFeat = 0;  // no features (csrc/attn_features.cuh)
  volatile int* blk;
  __device__ __forceinline__ int tile_lo() const { return blk[kTileLo]; }
  __device__ __forceinline__ int n_tiles() const { return blk[kNTiles]; }
  __device__ __forceinline__ int n_steps() const { return 2 * blk[kNTiles]; }
  __device__ __forceinline__ int rows() const { return blk[kRows]; }
  __device__ __forceinline__ int keys() const { return blk[kKeys]; }
  __device__ __forceinline__ int off() const { return blk[kOff]; }
  // A masked step reads the key bound once.
  template <class M>
  __device__ __forceinline__ auto step_keys(M) const {
    const int keys = M::value ? blk[kKeys] : 0;
    return [keys] { return keys; };
  }
};

// Kernel 3's shared memory, the schedule's scan and the block's slots.
template <int D, bool kSoftcap>
struct Cfg {
  using Dq = fa::bwd90::DqCfg<D, kSoftcap>;
  static constexpr int kScanInts = kThreads / 32 + 3;
  static constexpr size_t kSmem = Dq::kSmem + 4 * (kScanInts + kSlots);
};

struct Params {
  const float* lse;  // (h, total_q) contiguous, natural log
  float* delta;      // (h, total_q) contiguous
  void* dq;          // packed as q: element strides dq_h (head), dq_s (token)
  long long dq_h, dq_s;
  long long total_q;
  int h, group, nseq;
  int left, right;  // normalised window; negative = unbounded
  float scale;
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2
  // with a softcap.
  float score_mul, cap_log2;
  const int* cu_q;    // nseq + 1
  const int* cu_k;    // nseq + 1
  const int* used_q;  // nseq or null
  const int* used_k;  // nseq or null
  // The schedule's trace (csrc/varlen_schedule.cuh), null but in checks.
  int* trace;
  long long trace_len;
};

// The parameters of a dQ instance with features.
struct FeatParams : Params {
  Features f;
};

template <int kFeat>
using ParamsOf = std::conditional_t<kFeat == 0, Params, FeatParams>;

// Kernel 8's block for dq_range_walk with features (kF = kFeat): SeqRange's
// walk and lengths, and for this thread's two rows (diagonals diag[i]) the
// rules: the head's ALiBi slope in base 2 and the rows' dropout hash parts
// (the packed rows).
template <int kF, bool kSoftcap>
struct SeqFeatRange {
  static constexpr bool kSkipEmpty = true;
  static constexpr int kFeat = kF;
  static constexpr bool kExt = (kF & kFeatExt) != 0;
  const FeatParams& p;
  volatile int* blk;
  const int (&diag)[2];
  float slope2;
  uint32_t drop_row[2];
  __device__ __forceinline__ int n_tiles() const { return blk[kNTiles]; }
  __device__ __forceinline__ int n_steps() const { return 2 * blk[kNTiles]; }
  __device__ __forceinline__ int rows() const { return blk[kRows]; }
  __device__ __forceinline__ int keys() const { return blk[kKeys]; }
  __device__ __forceinline__ int off() const { return blk[kOff]; }
  template <class M>
  __device__ __forceinline__ auto step_keys(M) const {
    const int keys = M::value ? blk[kKeys] : 0;
    return [keys] { return keys; };
  }
  __device__ __forceinline__ int tile(int it) const {
    return blk[kTileLo] + it;
  }
  // Whether the chunk leaves a tile of keys c_lo..c_hi whole for rows of
  // diagonals d_lo..d_hi (the window is tested apart).
  __device__ __forceinline__ bool full(int c_lo, int c_hi, int d_lo,
                                       int d_hi) const {
    if constexpr (kExt) {
      return chunk_full(c_lo, c_hi, d_lo, d_hi, p.f);
    } else {
      return true;
    }
  }
  __device__ __forceinline__ float prob(float s, int col, int i, float lse2,
                                        float& dmul) const {
    if constexpr (kExt) {
      return prob_alibi<kSoftcap>(p, s, lse2, slope2, col - diag[i], dmul);
    } else {
      return fa::bwd90::prob<kSoftcap>(p, s, lse2, dmul);
    }
  }
  __device__ __forceinline__ bool visible(int col, int i) const {
    if constexpr (kExt) {
      return visible_ext(col, diag[i], p.left, p.right, p.f);
    } else {
      return in_window(col, diag[i], p.left, p.right);
    }
  }
  // dP Z / (1 - p) in place, with dropout: Z at the packed key k0 + col.
  template <int N>
  __device__ __forceinline__ void drop_dp(float (&dp)[N], int col0,
                                          int tig) const {
    if constexpr ((kF & kFeatDrop) != 0) {
      const int k0 = blk[kK0];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int col = k0 + col0 + (e >> 2) * 8 + tig * 2 + (e & 1);
        dp[e] = dropout_keep(drop_row[(e >> 1) & 1], col, p.f.keep_threshold)
                    ? dp[e] * p.f.keep_scale
                    : 0.f;
      }
    }
  }
};

template <typename T, int D, bool kSoftcap, int kFeat = 0>
__global__ void __launch_bounds__(kThreads, 1)
    varlen_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const ParamsOf<kFeat> p) {
  constexpr bool kExt = (kFeat & kFeatExt) != 0;
  // A feature instance walks 64-key tiles at d 64 too (dq_walk_tile), as
  // kernel 3's does.
  using Cf = Cfg<D, kSoftcap || kFeat != 0>;
  using C = typename Cf::Dq;
  static_assert(C::kBN == fa::bwd90::dq_walk_tile(D, kSoftcap, kFeat),
                "dQ key tile");
  constexpr int kStages = C::kStages;
  constexpr int kBN = C::kBN;
  constexpr int kBlocksD = D / 64;  // 128-byte column blocks of a row
  extern __shared__ unsigned char smem_vbwd90[];
  unsigned char* sQ =
      smem_vbwd90 + ((1024 - (smem_u32(smem_vbwd90) & 1023)) & 1023);
  unsigned char* sdO = sQ + C::kQBytes;
  unsigned char* sK = sdO + C::kQBytes;
  unsigned char* sV = sK + kStages * C::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * C::kTileBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  int* scan = reinterpret_cast<int*>(empty + kStages);
  // The block's sequence and walk (Slot), written by thread 0 and read
  // where they are used, through a volatile pointer: kernel 3 reads its
  // lengths from the parameters, which ptxas reloads instead of holding a
  // register through the walk. Held in registers, these spilled 192 bytes
  // at d 64 without a softcap; read here, 148 (kernel 3 spills 16). Reading
  // the rows and diagonals from here too spilled nothing but ran 1.09-1.10x
  // slower (PERF.md §6).
  volatile int* blk = scan + Cf::kScanInts;

  // The block's sequence and row tile, before the warpgroups split.
  const int seq = vsched::find_tile<kThreads, kBlockRows>(
      p.cu_q, p.used_q, p.nseq, blockIdx.x, scan);
  if (seq < 0) {  // past the last row tile: the whole block leaves
    if (threadIdx.x == 0) vsched::trace_block(p.trace, p.trace_len, -1, -1);
    return;
  }
  const int* found = scan + kThreads / 32;
  const int row0 = (found[2] - 1 - found[1]) * kBlockRows;
  const int head = blockIdx.y;
  const int tid = threadIdx.x;

  if (tid == 0) {
    const int q0 = __ldg(p.cu_q + seq);
    const int len_q = __ldg(p.cu_q + seq + 1) - q0;
    const int uq = p.used_q ? __ldg(p.used_q + seq) : len_q;
    const int rows = max(min(uq, len_q), 0);
    const int k0 = __ldg(p.cu_k + seq);
    const int len_k = __ldg(p.cu_k + seq + 1) - k0;
    const int uk = p.used_k ? __ldg(p.used_k + seq) : len_k;
    const int keys = max(min(uk, len_k), 0);
    const int off = uk - uq;
    const int row_last = min(row0 + kBlockRows, rows) - 1;
    int col_lo = p.left >= 0 ? max(row0 + off - p.left, 0) : 0;
    int col_hi =
        p.right >= 0 ? min(row_last + off + p.right, keys - 1) : keys - 1;
    if constexpr (kExt) {
      chunk_keys(row0 + off, row_last + off, p.f.chunk, col_lo, col_hi);
    }
    blk[kQ0] = q0;
    blk[kK0] = k0;
    blk[kRows] = rows;
    blk[kKeys] = keys;
    blk[kOff] = off;
    blk[kTileLo] = col_lo / kBN;
    blk[kNTiles] = col_hi >= col_lo ? col_hi / kBN - col_lo / kBN + 1 : 0;
    vsched::trace_block(p.trace, p.trace_len, seq, row0);
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kWarpgroups);  // lane 0 of each warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The copies, all issued by thread 0: Q and dO once, then the visible
  // K/V tiles twice (pass 1 sums delta, pass 2 accumulates dQ), step x
  // into stage x % kStages once every warp has released step x - kStages.
  auto load_kv = [&](int x) {
    const int s = x % kStages;
    const int key0 = blk[kK0] + (blk[kTileLo] + x % blk[kNTiles]) * kBN;
    const int g = head / p.group;
    mbar_wait(empty + s, ((x / kStages) & 1) ^ 1);
    mbar_expect_tx(full + s, 2 * C::kTileBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocksD; ++cb) {
      tma_load_4d(sK + s * C::kTileBytes + cb * kBN * 128, &tk, full + s,
                  cb * 64, key0, g, 0);
      tma_load_4d(sV + s * C::kTileBytes + cb * kBN * 128, &tv, full + s,
                  cb * 64, key0, g, 0);
    }
  };
  if (tid == 0 && blk[kNTiles] > 0) {
    const int r0 = blk[kQ0] + row0;
    mbar_expect_tx(q_full, 2 * C::kQBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocksD; ++cb) {
      tma_load_4d(sQ + cb * kBlockRows * 128, &tq, q_full, cb * 64, r0, head,
                  0);
      tma_load_4d(sdO + cb * kBlockRows * 128, &tdo, q_full, cb * 64, r0,
                  head, 0);
    }
    for (int x = 0; x < min(kStages, 2 * blk[kNTiles]); ++x) load_kv(x);
  }

  const int cw = tid >> 7;  // warpgroup: rows 64 cw..
  const int t = tid & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wrow0 = row0 + cw * 64;
  // The rows' LSE and delta, at head * total_q + q0 + row.
  auto stat_row = [&] {
    return static_cast<long long>(head) * p.total_q + blk[kQ0];
  };

  int row[2], diag[2];
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = wrow0 + warp * 16 + gid + 8 * i;
    diag[i] = row[i] + blk[kOff];
    const bool ok = row[i] < blk[kRows];
    lse2[i] = lse_base2(ok ? p.lse[stat_row() + row[i]] : 0.f, ok);
  }
  float dq[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
  float delta[2] = {0.f, 0.f};

  if constexpr (kFeat == 0) {
    dq_range_walk<T, D, kSoftcap, C>(
        p, SeqRange{blk}, load_kv,
        DqShared{sQ, sdO, sK, sV, q_full, full, empty}, tid, lane, tig, cw,
        wrow0, diag, lse2, dq, delta);
  } else {
    SeqFeatRange<kFeat, kSoftcap> r{p, blk, diag};
    r.slope2 = kExt && p.f.slopes ? p.f.slopes[head] * kLog2e : 0.f;
    const uint32_t base = dropout_base(p.f.seed, 0, head);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r.drop_row[i] = dropout_row(base, blk[kQ0] + row[i]);
    }
    dq_range_walk<T, D, kSoftcap, C>(
        p, r, load_kv, DqShared{sQ, sdO, sK, sV, q_full, full, empty}, tid,
        lane, tig, cw, wrow0, diag, lse2, dq, delta);
  }

  // Per-row guarded stores: rows below `rows` only.
  const int rows = blk[kRows];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (tig == 0 && row[i] < rows) p.delta[stat_row() + row[i]] = delta[i];
  }
  store_rows<T, D>(static_cast<T*>(p.dq) + head * p.dq_h +
                       static_cast<long long>(blk[kQ0]) * p.dq_s,
                   p.dq_s, row, rows, tig, dq);
}

template <typename T, int D, bool kSoftcap, int kFeat = 0>
int launch(const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
           const CUtensorMap& tv, const ParamsOf<kFeat>& p,
           cudaStream_t stream) {
  const long long tiles = vsched::grid_tiles(p.total_q, p.nseq, kBlockRows);
  if (tiles <= 0) return 0;
  const size_t smem = Cfg<D, kSoftcap || kFeat != 0>::kSmem;
  if (const int err =
          set_smem(varlen_dq_sm90_kernel<T, D, kSoftcap, kFeat>, smem)) {
    return err;
  }
  const dim3 grid(static_cast<unsigned>(tiles), p.h);
  varlen_dq_sm90_kernel<T, D, kSoftcap, kFeat>
      <<<grid, kThreads, smem, stream>>>(tq, tdo, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_softcap(const CUtensorMap* maps, const Params& p, bool softcap,
                   cudaStream_t s) {
  return softcap ? launch<T, D, true>(maps[0], maps[1], maps[2], maps[3], p, s)
                 : launch<T, D, false>(maps[0], maps[1], maps[2], maps[3], p,
                                       s);
}

// The dQ instances with features: kFeat 1-3 (kFeatExt | kFeatDrop),
// softcap or not. Returns -3 for kFeat 0, which launch_softcap takes.
template <typename T, int D>
int launch_features(const CUtensorMap* m, const FeatParams& p, bool softcap,
                    int feat, cudaStream_t s) {
  switch (feat + 4 * softcap) {
    case 1: return launch<T, D, false, 1>(m[0], m[1], m[2], m[3], p, s);
    case 2: return launch<T, D, false, 2>(m[0], m[1], m[2], m[3], p, s);
    case 3: return launch<T, D, false, 3>(m[0], m[1], m[2], m[3], p, s);
    case 5: return launch<T, D, true, 1>(m[0], m[1], m[2], m[3], p, s);
    case 6: return launch<T, D, true, 2>(m[0], m[1], m[2], m[3], p, s);
    case 7: return launch<T, D, true, 3>(m[0], m[1], m[2], m[3], p, s);
    default: return -3;
  }
}

// Kernel 7's block: its sequence and walk, in shared memory, written by
// thread 0 and read where used through a volatile pointer (see kernel 8).
enum DkvSlot { kVQ0, kVK0, kVRows, kVKeys, kVOff, kVQtLo, kVNQt, kVNIter,
               kDkvSlots };

// Kernel 7's block for dkv_range_walk: its walk and lengths, read from the
// slots where they are used, but for the key bound and the diagonal offset,
// which every masked element reads, held in registers. Keys past `keys`
// are the next sequence's (or the tensor's end) and are masked; they are
// never stored. Stage s's LSE and delta rows start at row sofs[s] of their
// tiles.
struct SeqDkvRange {
  static constexpr int kFeat = 0;  // no features (csrc/attn_features.cuh)
  volatile int* blk;
  volatile int* sofs;
  int keys_, off_;
  __device__ __forceinline__ int qt_lo() const { return blk[kVQtLo]; }
  __device__ __forceinline__ int n_qt() const { return blk[kVNQt]; }
  __device__ __forceinline__ int n_iter() const { return blk[kVNIter]; }
  __device__ __forceinline__ int rows() const { return blk[kVRows]; }
  __device__ __forceinline__ int keys() const { return keys_; }
  __device__ __forceinline__ int off() const { return off_; }
  __device__ __forceinline__ int stat_ofs(int s) const { return sofs[s]; }
};

// Kernel 2's shared memory, then the schedule's scan and the block's slots
// (kernel 2's stage row offsets follow them here).
template <int D, bool kSoftcap>
struct DkvCfg {
  using Dkv = fa::bwd90::DkvCfg<D, kSoftcap>;
  static constexpr int kScanInts = kThreads / 32 + 3;
  static constexpr size_t kSmem = Dkv::kSmem + 4 * (kScanInts + kDkvSlots);
};

struct DkvParams {
  void* dk;  // packed as k: element strides dk_h (head), dk_s (token)
  void* dv;  // packed as v
  long long dk_h, dk_s, dv_h, dv_s;
  long long total_q;  // the LSE and delta rows per head
  int h, group, nseq;
  int left, right;  // normalised window; negative = unbounded
  float scale;
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2
  // with a softcap.
  float score_mul, cap_log2;
  const int* cu_q;    // nseq + 1
  const int* cu_k;    // nseq + 1
  const int* used_q;  // nseq or null
  const int* used_k;  // nseq or null
  // The schedule's trace (csrc/varlen_schedule.cuh; the first key of the
  // block's tile for its first row), null but in checks.
  int* trace;
  long long trace_len;
};

// The parameters of a dK/dV instance with features.
struct DkvFeatParams : DkvParams {
  Features f;
};

template <int kFeat>
using DkvParamsOf = std::conditional_t<kFeat == 0, DkvParams, DkvFeatParams>;

// Kernel 7's block for dkv_range_walk with features: SeqDkvRange's walk and
// lengths, and the rules of each step's query head (head_rules: its ALiBi
// slope in base 2, its dropout hash base, and the sequence's first packed
// row and key, read from the slots once a step).
template <int kF, bool kSoftcap>
struct SeqFeatDkvRange {
  static constexpr int kFeat = kF;
  static constexpr bool kExt = (kF & kFeatExt) != 0;
  const DkvFeatParams& p;
  volatile int* blk;
  volatile int* sofs;
  int keys_, off_, g;
  __device__ __forceinline__ int qt_lo() const { return blk[kVQtLo]; }
  __device__ __forceinline__ int n_qt() const { return blk[kVNQt]; }
  __device__ __forceinline__ int n_iter() const { return blk[kVNIter]; }
  __device__ __forceinline__ int rows() const { return blk[kVRows]; }
  __device__ __forceinline__ int keys() const { return keys_; }
  __device__ __forceinline__ int off() const { return off_; }
  __device__ __forceinline__ int stat_ofs(int s) const { return sofs[s]; }
  struct HeadRules {
    float slope2;
    uint32_t base;
    int q0, k0;
  };
  __device__ __forceinline__ HeadRules head_rules(int it) const {
    const int head = g * p.group + it / blk[kVNQt];
    HeadRules hr;
    hr.slope2 = kExt && p.f.slopes ? p.f.slopes[head] * kLog2e : 0.f;
    hr.base = 0u;
    hr.q0 = hr.k0 = 0;
    if constexpr ((kF & kFeatDrop) != 0) {
      hr.base = dropout_base(p.f.seed, 0, head);
      hr.q0 = blk[kVQ0];
      hr.k0 = blk[kVK0];
    }
    return hr;
  }
  __device__ __forceinline__ bool full(int k_lo, int k_hi, int d_lo,
                                       int d_hi) const {
    if constexpr (kExt) {
      return chunk_full(k_lo, k_hi, d_lo, d_hi, p.f);
    } else {
      return true;
    }
  }
  __device__ __forceinline__ float prob(const HeadRules& hr, float s,
                                        float lse2, int key, int row,
                                        float& dmul) const {
    if constexpr (kExt) {
      return prob_alibi<kSoftcap>(p, s, lse2, hr.slope2, key - row - off_,
                                  dmul);
    } else {
      return fa::bwd90::prob<kSoftcap>(p, s, lse2, dmul);
    }
  }
  // Key `key` (thread's key i) from query row `row`; rows past `rows` take
  // P = 0 through their LSE.
  __device__ __forceinline__ bool visible(int key, int row, int) const {
    if constexpr (kExt) {
      return visible_ext(key, row + off_, p.left, p.right, p.f);
    } else {
      return in_window(key, row + off_, p.left, p.right);
    }
  }
  // Z at the packed row q0 + row and key k0 + key.
  __device__ __forceinline__ bool keep(const HeadRules& hr, int row,
                                       int key) const {
    return dropout_keep(dropout_row(hr.base, hr.q0 + row), hr.k0 + key,
                        p.f.keep_threshold);
  }
  __device__ __forceinline__ float keep_scale() const {
    return p.f.keep_scale;
  }
};

template <typename T, int D, bool kSoftcap, int kFeat = 0>
__global__ void __launch_bounds__(kThreads, 1)
    varlen_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tlse,
                           const __grid_constant__ CUtensorMap tdelta,
                           const DkvParamsOf<kFeat> p) {
  constexpr bool kExt = (kFeat & kFeatExt) != 0;
  using C = typename DkvCfg<D, kSoftcap>::Dkv;
  constexpr int kStages = C::kStages;
  constexpr int kBQ = C::kBQ;
  constexpr int kBlocksD = D / 64;  // 128-byte column blocks of a row
  extern __shared__ unsigned char smem_vdkv90[];
  unsigned char* sK =
      smem_vdkv90 + ((1024 - (smem_u32(smem_vdkv90) & 1023)) & 1023);
  unsigned char* sV = sK + C::kKVBytes;
  unsigned char* sQ = sV + C::kKVBytes;  // [kStages] tiles
  unsigned char* sdO = sQ + kStages * C::kQBytes;
  float* sL = reinterpret_cast<float*>(sdO + kStages * C::kQBytes);
  float* sD = sL + kStages * C::kStatStride;
  float* sL2 = sD + kStages * C::kStatStride;  // [kWarpgroups][kStages][kBQ]
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(sL2 + kWarpgroups * kStages * kBQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  int* scan = reinterpret_cast<int*>(empty + kStages);
  volatile int* blk = scan + DkvCfg<D, kSoftcap>::kScanInts;
  volatile int* sofs = blk + kDkvSlots;  // [kStages]

  // The block's sequence and key tile, before the warpgroups split.
  const int seq = vsched::find_tile<kThreads, kBlockRows>(
      p.cu_k, p.used_k, p.nseq, blockIdx.x, scan);
  if (seq < 0) {  // past the last key tile: the whole block leaves
    if (threadIdx.x == 0) vsched::trace_block(p.trace, p.trace_len, -1, -1);
    return;
  }
  const int key0 = scan[kThreads / 32 + 1] * kBlockRows;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;

  if (tid == 0) {
    const int q0 = __ldg(p.cu_q + seq);
    const int len_q = __ldg(p.cu_q + seq + 1) - q0;
    const int uq = p.used_q ? __ldg(p.used_q + seq) : len_q;
    const int rows = max(min(uq, len_q), 0);
    const int k0 = __ldg(p.cu_k + seq);
    const int len_k = __ldg(p.cu_k + seq + 1) - k0;
    const int uk = p.used_k ? __ldg(p.used_k + seq) : len_k;
    const int keys = max(min(uk, len_k), 0);
    const int off = uk - uq;
    // Query rows that see any key of the tile, in tiles of kBQ, for each
    // query head of the group: step it reads query head g * group + it /
    // n_qt, rows (qt_lo + it % n_qt) * kBQ..
    const int key_last = min(key0 + kBlockRows, keys) - 1;
    const int q_lo = p.right >= 0 ? max(key0 - off - p.right, 0) : 0;
    const int q_hi =
        p.left >= 0 ? min(key_last - off + p.left, rows - 1) : rows - 1;
    // An extended instance narrows the rows to the keys' chunks.
    int lo = q_lo, hi = q_hi;
    if constexpr (kExt) chunk_rows(key0, key_last, off, p.f.chunk, lo, hi);
    const int n_qt = hi >= lo ? hi / kBQ - lo / kBQ + 1 : 0;
    blk[kVQ0] = q0;
    blk[kVK0] = k0;
    blk[kVRows] = rows;
    blk[kVKeys] = keys;
    blk[kVOff] = off;
    blk[kVQtLo] = lo / kBQ;
    blk[kVNQt] = n_qt;
    blk[kVNIter] = n_qt * p.group;
    vsched::trace_block(p.trace, p.trace_len, seq, key0);
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kWarpgroups);  // lane 0 of each warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (blk[kVNIter] == 0) return;  // no row sees these keys

  // The copies, all issued by thread 0: K and V once, then per step a Q,
  // dO, LSE and delta tile, step it into stage it % kStages once every
  // warp has released step it - kStages.
  auto load_q = [&](int it) {
    const int s = it % kStages;
    const int n_qt = blk[kVNQt];
    const int head = g * p.group + it / n_qt;
    const int r0 = blk[kVQ0] + (blk[kVQtLo] + it % n_qt) * kBQ;
    const int li = head * static_cast<int>(p.total_q) + r0;
    mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
    sofs[s] = li & 3;
    mbar_expect_tx(full + s, 2 * C::kQBytes + 2 * 4 * C::kStatBox);
#pragma unroll
    for (int cb = 0; cb < kBlocksD; ++cb) {
      tma_load_4d(sQ + s * C::kQBytes + cb * kBQ * 128, &tq, full + s, cb * 64,
                  r0, head, 0);
      tma_load_4d(sdO + s * C::kQBytes + cb * kBQ * 128, &tdo, full + s,
                  cb * 64, r0, head, 0);
    }
    tma_load_1d(sL + s * C::kStatStride, &tlse, full + s, li & ~3);
    tma_load_1d(sD + s * C::kStatStride, &tdelta, full + s, li & ~3);
  };
  if (tid == 0) {
    const int k_at = blk[kVK0] + key0;
    mbar_expect_tx(kv_full, 2 * C::kKVBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocksD; ++cb) {
      tma_load_4d(sK + cb * kBlockRows * 128, &tk, kv_full, cb * 64, k_at, g,
                  0);
      tma_load_4d(sV + cb * kBlockRows * 128, &tv, kv_full, cb * 64, k_at, g,
                  0);
    }
    const int n_iter = blk[kVNIter];
    for (int it = 0; it < min(kStages, n_iter); ++it) load_q(it);
  }

  const int cw = tid >> 7;  // warpgroup: keys 64 cw..
  const int t = tid & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wkey0 = key0 + cw * 64;
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = wkey0 + warp * 16 + gid + 8 * i;
  float dk[D / 2];
  float dv[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;

  if constexpr (kFeat == 0) {
    dkv_range_walk<T, D, kSoftcap, C>(
        p, SeqDkvRange{blk, sofs, blk[kVKeys], blk[kVOff]}, load_q,
        DkvShared{sK, sV, sQ, sdO, sL, sD, sL2, kv_full, full, empty}, tid,
        t, lane, tig, cw, wkey0, key, dk, dv);
  } else {
    dkv_range_walk<T, D, kSoftcap, C>(
        p,
        SeqFeatDkvRange<kFeat, kSoftcap>{p, blk, sofs, blk[kVKeys],
                                         blk[kVOff], g},
        load_q, DkvShared{sK, sV, sQ, sdO, sL, sD, sL2, kv_full, full, empty},
        tid, t, lane, tig, cw, wkey0, key, dk, dv);
  }

  // Per-row guarded stores: keys below `keys` only.
  const int keys = blk[kVKeys];
  const long long k0 = blk[kVK0];
  store_rows<T, D>(static_cast<T*>(p.dk) + g * p.dk_h + k0 * p.dk_s, p.dk_s,
                   key, keys, tig, dk);
  store_rows<T, D>(static_cast<T*>(p.dv) + g * p.dv_h + k0 * p.dv_s, p.dv_s,
                   key, keys, tig, dv);
}

template <typename T, int D, bool kSoftcap, int kFeat = 0>
int launch_dkv(const CUtensorMap* maps, const DkvParamsOf<kFeat>& p,
               long long total_k, int hk, cudaStream_t stream) {
  const long long tiles = vsched::grid_tiles(total_k, p.nseq, kBlockRows);
  if (tiles <= 0) return 0;
  const size_t smem = DkvCfg<D, kSoftcap>::kSmem;
  if (const int err =
          set_smem(varlen_dkv_sm90_kernel<T, D, kSoftcap, kFeat>, smem)) {
    return err;
  }
  const dim3 grid(static_cast<unsigned>(tiles), hk);
  varlen_dkv_sm90_kernel<T, D, kSoftcap, kFeat>
      <<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                         maps[4], maps[5], p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv_softcap(const CUtensorMap* maps, const DkvParams& p,
                       bool softcap, long long total_k, int hk,
                       cudaStream_t s) {
  return softcap ? launch_dkv<T, D, true>(maps, p, total_k, hk, s)
                 : launch_dkv<T, D, false>(maps, p, total_k, hk, s);
}

// The dK/dV instances with features: kFeat 1-3, softcap or not. Returns -3
// for kFeat 0, which launch_dkv_softcap takes.
template <typename T, int D>
int launch_dkv_features(const CUtensorMap* maps, const DkvFeatParams& p,
                        bool softcap, int feat, long long total_k, int hk,
                        cudaStream_t s) {
  switch (feat + 4 * softcap) {
    case 1: return launch_dkv<T, D, false, 1>(maps, p, total_k, hk, s);
    case 2: return launch_dkv<T, D, false, 2>(maps, p, total_k, hk, s);
    case 3: return launch_dkv<T, D, false, 3>(maps, p, total_k, hk, s);
    case 5: return launch_dkv<T, D, true, 1>(maps, p, total_k, hk, s);
    case 6: return launch_dkv<T, D, true, 2>(maps, p, total_k, hk, s);
    case 7: return launch_dkv<T, D, true, 3>(maps, p, total_k, hk, s);
    default: return -3;
  }
}

}  // namespace vbwd90
}  // namespace fa
