// Packed variable-length flash-attention forward for Hopper (kernel 6):
// out = softmax(scale * Q K^T [masked]) V and the fp32 log-sum-exp of every
// query row, for nseq sequences packed along one token axis, with K/V
// packed the same way or read in place from page pools through a page
// table.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_varlen.py:542
// (_varlen_fwd_kernel, launched at :1485 by flash_attention_varlen_fwd
// :1160), restricted to the features the training and serving paths use.
// The function is csrc/flash_fwd_tile.cuh's varlen and paged modes: query
// row i of sequence b (rows from cu_q[b], rows = min(used_q, length)) and
// head hq sees key column j of kv head hq / (h / hk) iff i < rows, j < keys
// (packed: min(used_k, length) from cu_k[b]; paged: used_k, in the pages
// of table row b) and, with diag = i + used_k - used_q, j >= diag - left
// (left >= 0) and j <= diag + right (right >= 0). Softcap, GQA, d 64/128,
// bf16/fp16, thd/hsd layouts. Online softmax in fp32 (base 2); out = acc /
// l, lse = m + ln(l) (natural log); a row that sees nothing gives out 0,
// lse -inf; rows past `rows` are not written (the wrapper zero-fills out
// and sets lse to -inf beforehand). Pages outside [0, npages) read as
// zeros, as the plain version's gather does.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * d flops
// per visible (query head, row, column) triple against q, k, v and out
// moved once: bound by operations at prefill lengths, by bytes for decode
// rows.
//
// Design: kernel 1's (csrc/flash_fwd_sm90.cuh): a producer warpgroup whose
// registers setmaxnreg lowers, 64-row wgmma consumer warpgroups (three at
// d 64, two at d 128) taking turns to issue, a K/V ring with full and
// empty mbarriers, S of tile i pipelined with P V of tile i - 1 inside a
// warpgroup, and the mask only on tiles a diagonal, window edge or key end
// crosses. On top of it:
//  * a flat tile scheduler: grid.x = (total_q + nseq (kBlockM - 1)) /
//    kBlockM, an upper bound on sum_b cdiv(rows_b, kBlockM) known from the
//    shapes alone; each block finds its (sequence, row tile) on the device
//    by a block-wide scan of the tile counts from cu_q / used_q, the
//    sequence's last row tile (its longest causal rows) first, and a block
//    past the last tile exits. No host read, and no block for the empty
//    row tiles that a max_seqlen_q x nseq grid launches
//    (csrc/varlen_schedule.cuh, shared with kernel 8's dQ);
//  * packed Q, K and V by TMA over (d, token, head) with the caller's
//    strides, at token cu_q[b] + row0 and cu_k[b] + key0. Rows past a
//    sequence's end are the next sequence's real data, not TMA's zeros:
//    every tile that holds the sequence's last key takes the mask, and out
//    and lse are written per row by guarded 16-byte stores (a TMA store
//    would overwrite the neighbour);
//  * page pools by TMA over (d, slot, head, page), one box of gcd(page,
//    128) slots per page piece: a 128-key tile is 128 / gcd pieces, each
//    inside one page, each landing on a row offset that is a multiple of 8
//    so the 128-byte swizzle stays the one wgmma reads. Lane j of the
//    producer warp reads piece j's page id a tile ahead of its copies and
//    issues that piece's boxes; an id outside the pool (or a piece past
//    the keys) is an out-of-range coordinate, which TMA fills with zeros.
// A page size that is not a multiple of 8 keeps csrc/flash_fwd_tile.cuh's
// paged mode (the wrapper counts that route apart).
//
// Features (csrc/attn_features.cuh, the varlen rules), in instances of
// their own (kFeat != 0, launched from csrc/flash_varlen_features.cu), as
// kernel 1's: ALiBi and attention_chunk (kFeatExt, packed or paged),
// dropout (kFeatDrop, packed). The feature-free instances compile as they
// did. An extended instance narrows its key walk to its rows' chunks,
// scales the scores to base 2 before the max (ALiBi subtracts its term
// there) and masks every tile a chunk edge crosses; dropout keeps m and l
// of the undropped P, zeroes the dropped P before P V (the keep mask at
// the packed row and key) and scales out by 1 / (1 - p).

#pragma once

#include <type_traits>

#include "attn_features.cuh"
#include "mma_utils.cuh"
#include "sm90_utils.cuh"
#include "varlen_schedule.cuh"

namespace fa {
namespace vfwd90 {

using namespace fa::sm90;

constexpr int kBlockN = 128;  // keys per K/V tile
// Named barriers: 1 + w, the epilogue of consumer warpgroup w; kTurnBarrier
// + w, its turn to issue wgmma (0 is __syncthreads').
constexpr int kTurnBarrier = 4;

// Query rows per block, as kernel 1's: three consumer warpgroups at d 64,
// two at d 128.
__host__ __device__ constexpr int block_m(int d) { return d == 64 ? 192 : 128; }

// Slots per TMA box of a page pool: gcd(page, kBlockN). The Hopper kernel
// takes pools whose boxes hold at least 8 slots (a page size that is a
// multiple of 8); the others keep the sm80 paged mode.
__host__ __device__ constexpr int piece_rows(int page) {
  return (page & -page) < kBlockN ? (page & -page) : kBlockN;
}
__host__ __device__ constexpr bool pages_on_tma(int page) {
  return page % 8 == 0;
}

template <int D>
struct Cfg {
  static constexpr int kConsumers = block_m(D) / 64;
  static constexpr int kBlockM = block_m(D);
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // As kernel 1's, paged too: a larger budget leaves the three d-64
  // consumers fewer than 160 registers (ptxas then spills and serializes
  // their wgmma), and one of 32, which fills the register file exactly
  // (128 x 32 + 384 x 160), failed at launch on the card.
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs =
      (65536 / 128 - kProducerRegs) / kConsumers / 8 * 8;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;  // one K or V tile
  static constexpr int kBarriers = 1 + 4 * kStages;
  static constexpr int kScanInts = kThreads / 32 + 4;
  // 1024 bytes of slack to align the tiles for the swizzle.
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes +
                                  8 * kBarriers + 4 * kScanInts;
};

struct Params {
  void* out;   // packed as q; element strides o_h (head), o_s (token)
  float* lse;  // (h, total_q) contiguous
  long long o_h, o_s;
  long long total_q;
  int h, group, nseq;
  int left, right;  // normalised window; negative = unbounded
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2
  // with a softcap (score_mul = scale / softcap, cap_log2 = softcap*log2 e).
  float score_mul, cap_log2;
  const int* cu_q;    // nseq + 1
  const int* cu_k;    // nseq + 1, packed K/V only
  const int* used_q;  // nseq or null
  const int* used_k;  // nseq or null (required with pages)
  // Pages: table (nseq, max_pages) with row stride table_row; pieces of
  // `piece` slots each, kBlockN / piece per tile.
  const int* table;
  long long table_row;
  int page, max_pages, piece;
  // The schedule's trace, null but in checks on the card: each block
  // writes (blockIdx.x, blockIdx.y, sequence, first row), the last two -1
  // past the last tile, at ints 4 (blockIdx.y gridDim.x + blockIdx.x) of
  // the trace_len it has.
  int* trace;
  long long trace_len;
};

// The parameters of an instance with features.
struct FeatParams : Params {
  Features f;
};

template <int kFeat>
using ParamsOf = std::conditional_t<kFeat == 0, Params, FeatParams>;

template <typename T, int D, bool kSoftcap, bool kPaged, int kFeat = 0>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    varlen_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const ParamsOf<kFeat> p) {
  constexpr bool kExt = (kFeat & kFeatExt) != 0;
  constexpr bool kDrop = (kFeat & kFeatDrop) != 0;
  static_assert(!(kPaged && kDrop), "dropout reads packed K/V only");
  using C = Cfg<D>;
  constexpr int kStages = C::kStages;
  constexpr int kBlockM = C::kBlockM;
  constexpr int kBlocksD = D / 64;  // 128-byte column blocks of a row
  extern __shared__ unsigned char smem_v90[];
  unsigned char* sQ = smem_v90 + ((1024 - (smem_u32(smem_v90) & 1023)) & 1023);
  unsigned char* sK = sQ + C::kQBytes;
  unsigned char* sV = sK + kStages * C::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * C::kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;
  int* scan = reinterpret_cast<int*>(v_empty + kStages);

  const int b = vsched::find_tile<C::kThreads, kBlockM>(
      p.cu_q, p.used_q, p.nseq, blockIdx.x, scan);
  if (b < 0) {  // past the last row tile: the whole block leaves
    if (threadIdx.x == 0) vsched::trace_block(p.trace, p.trace_len, -1, -1);
    return;
  }
  const int head = blockIdx.y;
  // The sequence's row tiles from its last (longest causal rows) down.
  const int* found = scan + C::kThreads / 32;
  const int row0 = (found[2] - 1 - found[1]) * kBlockM;
  const int q0 = __ldg(p.cu_q + b);
  const int len_q = __ldg(p.cu_q + b + 1) - q0;
  const int uq = p.used_q ? __ldg(p.used_q + b) : len_q;
  const int rows = max(min(uq, len_q), 0);
  int k0 = 0, uk, keys;
  if constexpr (kPaged) {
    uk = __ldg(p.used_k + b);
    keys = max(min(uk, p.max_pages * p.page), 0);
  } else {
    k0 = __ldg(p.cu_k + b);
    const int len_k = __ldg(p.cu_k + b + 1) - k0;
    uk = p.used_k ? __ldg(p.used_k + b) : len_k;
    keys = max(min(uk, len_k), 0);
  }
  const int off = uk - uq;
  const int row_last = min(row0 + kBlockM, rows) - 1;
  int col_lo = p.left >= 0 ? max(row0 + off - p.left, 0) : 0;
  int col_hi =
      p.right >= 0 ? min(row_last + off + p.right, keys - 1) : keys - 1;
  if constexpr (kExt) {
    chunk_keys(row0 + off, row_last + off, p.f.chunk, col_lo, col_hi);
  }
  const int tile_lo = col_lo / kBlockN;
  const int n_tiles = col_hi >= col_lo ? col_hi / kBlockN - tile_lo + 1 : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 4 * C::kConsumers);  // lane 0, consumer warps
      mbar_init(v_empty + s, 4 * C::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // Producer. The branches never meet again, as setmaxnreg requires.
    setmaxnreg_dec<C::kProducerRegs>();
    // In the producer, so that the consumers' registers do not see it.
    if (tid == 0) vsched::trace_block(p.trace, p.trace_len, b, row0);
    const int g = head / p.group;
    if constexpr (kPaged) {
      // Warp 0: lane j < pieces loads piece j of every tile, its page id
      // read a tile ahead of its copies.
      const int pieces = kBlockN / p.piece;
      const int lane = tid;
      const int* trow = p.table + b * p.table_row;
      auto page_of = [&](int it, int& slot) {
        const int key = (tile_lo + it) * kBlockN + lane * p.piece;
        slot = key % p.page;
        return key < keys ? __ldg(trow + key / p.page) : -1;
      };
      if (tid < 32 && n_tiles > 0) {
        if (lane == 0) {
          mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
          for (int cb = 0; cb < kBlocksD; ++cb) {
            tma_load_4d(sQ + cb * kBlockM * 128, &tq, q_full, cb * 64,
                        q0 + row0, head, 0);
          }
        }
        int slot = 0, id = lane < pieces ? page_of(0, slot) : -1;
        for (int it = 0; it < n_tiles; ++it) {
          const int s = it % kStages;
          const int parity = ((it / kStages) & 1) ^ 1;
          int next_slot = 0, next_id = -1;
          if (lane < pieces && it + 1 < n_tiles) next_id = page_of(it + 1, next_slot);
          const int box = lane * p.piece * 128;
          mbar_wait(k_empty + s, parity);
          if (lane == 0) mbar_expect_tx(k_full + s, C::kTileBytes);
          __syncwarp();
          if (lane < pieces) {
#pragma unroll
            for (int cb = 0; cb < kBlocksD; ++cb) {
              tma_load_4d(sK + s * C::kTileBytes + cb * kBlockN * 128 + box,
                          &tk, k_full + s, cb * 64, slot, g, id);
            }
          }
          mbar_wait(v_empty + s, parity);
          if (lane == 0) mbar_expect_tx(v_full + s, C::kTileBytes);
          __syncwarp();
          if (lane < pieces) {
#pragma unroll
            for (int cb = 0; cb < kBlocksD; ++cb) {
              tma_load_4d(sV + s * C::kTileBytes + cb * kBlockN * 128 + box,
                          &tv, v_full + s, cb * 64, slot, g, id);
            }
          }
          id = next_id;
          slot = next_slot;
        }
      }
    } else if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int cb = 0; cb < kBlocksD; ++cb) {
        tma_load_4d(sQ + cb * kBlockM * 128, &tq, q_full, cb * 64, q0 + row0,
                    head, 0);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int parity = ((it / kStages) & 1) ^ 1;
        const int key0 = k0 + (tile_lo + it) * kBlockN;
        mbar_wait(k_empty + s, parity);
        mbar_expect_tx(k_full + s, C::kTileBytes);
#pragma unroll
        for (int cb = 0; cb < kBlocksD; ++cb) {
          tma_load_4d(sK + s * C::kTileBytes + cb * kBlockN * 128, &tk,
                      k_full + s, cb * 64, key0, g, 0);
        }
        mbar_wait(v_empty + s, parity);
        mbar_expect_tx(v_full + s, C::kTileBytes);
#pragma unroll
        for (int cb = 0; cb < kBlocksD; ++cb) {
          tma_load_4d(sV + s * C::kTileBytes + cb * kBlockN * 128, &tv,
                      v_full + s, cb * 64, key0, g, 0);
        }
      }
    }
  } else {
    setmaxnreg_inc<C::kConsumerRegs>();
    const int cw = (tid - 128) >> 7;  // consumer warpgroup: rows 64 cw..
    const int t = tid & 127;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int wrow0 = row0 + cw * 64;

    int diag[2];
    bool row_ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wrow0 + warp * 16 + gid + 8 * i;
      row_ok[i] = r < rows;
      diag[i] = r + off;
    }
    // Features: this thread's rows' dropout hash parts (batch row 0, the
    // packed rows) and the head's ALiBi slope in base 2.
    uint32_t drop_row[2];
    float slope2 = 0.f;
    if constexpr (kDrop) {
      const uint32_t base = dropout_base(p.f.seed, 0, head);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        drop_row[i] = dropout_row(base, q0 + diag[i] - off);
      }
    }
    if constexpr (kExt) {
      if (p.f.slopes) slope2 = p.f.slopes[head] * kLog2e;
    }
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kMask, kMask};
    float l[2] = {0.f, 0.f};  // this thread's partial row sums

    // Descriptors: Q (this warpgroup's 64 rows) and K K-major, V N-major.
    const uint64_t q_desc = make_desc(sQ + cw * 64 * 128, 16, 1024);
    const uint64_t k_desc = make_desc(sK, 16, 1024);
    const uint64_t v_desc = make_desc(sV, kBlockN * 128, 1024);

    // S = Q K^T of tile `it` into sc, issued and committed (not waited).
    auto issue_s = [&](float (&sc)[64], int it) {
      const int s = it % kStages;
      mbar_wait(k_full + s, (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // k16 step kk: column block kk / 4, 32 bytes per step inside it.
        const uint32_t step = ((kk >> 2) * kBlockM * 128 + (kk & 3) * 32) >> 4;
        const uint32_t kstep =
            (s * C::kTileBytes + (kk >> 2) * kBlockN * 128 + (kk & 3) * 32) >> 4;
        Wgmma<T>::ss_n128(sc, q_desc + step, k_desc + kstep, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of tile `it`, issued and committed: P's A registers come
    // straight from the S accumulators.
    auto issue_pv = [&](uint32_t (&pa)[kBlockN / 16][4], int it) {
      const int s = it % kStages;
      mbar_wait(v_full + s, (it / kStages) & 1);
      fence_regs(o);  // O's rescale and P's packing come before the fence
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const uint64_t vd = v_desc + ((s * C::kTileBytes + kk * 16 * 128) >> 4);
        wgmma_rs<T, D>(o, pa[kk], vd, 1);
      }
      wgmma_commit();
    };
    auto release = [&](uint64_t* bars, int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + it % kStages);
    };
    // Softcap, mask (only on a tile some row sees in part: a diagonal, a
    // window edge, the last rows, or the key end, past which lie the next
    // sequence's keys or TMA's zeros), scale (base 2) and the online
    // softmax of tile `it`: sc becomes P, and alpha the factor O must be
    // rescaled by.
    auto softmax = [&](float (&sc)[64], int it, float (&alpha)[2]) {
      const int col0 = (tile_lo + it) * kBlockN;
      const bool full =
          wrow0 + 64 <= rows && col0 + kBlockN <= keys &&
          in_window(col0, wrow0 + 63 + off, p.left, -1) &&
          in_window(col0 + kBlockN - 1, wrow0 + off, -1, p.right);
      // Without a softcap the scale folds into the exponent's FFMA (it is
      // positive, so the row max commutes with it). An extended instance
      // scales first: ALiBi's term is in base 2.
      const float mul = kSoftcap || kExt ? 1.f : p.score_mul;
      if constexpr (kExt) {
#pragma unroll
        for (int x = 0; x < 64; ++x) {
          const int i = (x >> 1) & 1;
          const int col = col0 + (x >> 2) * 8 + tig * 2 + (x & 1);
          const float s = kSoftcap ? tanhf(sc[x] * p.score_mul) * p.cap_log2
                                   : sc[x] * p.score_mul;
          sc[x] = s - slope2 * fabsf(static_cast<float>(col - diag[i]));
        }
        if (!(full && chunk_full(col0, col0 + kBlockN - 1, wrow0 + off,
                                 wrow0 + 63 + off, p.f))) {
#pragma unroll
          for (int x = 0; x < 64; ++x) {
            const int i = (x >> 1) & 1;
            const int col = col0 + (x >> 2) * 8 + tig * 2 + (x & 1);
            if (!(row_ok[i] && col < keys &&
                  visible_ext(col, diag[i], p.left, p.right, p.f))) {
              sc[x] = -INFINITY;
            }
          }
        }
      } else if constexpr (kSoftcap) {
#pragma unroll
        for (int x = 0; x < 64; ++x) {
          sc[x] = tanhf(sc[x] * p.score_mul) * p.cap_log2;
        }
      }
      if (!kExt && !full) {
#pragma unroll
        for (int x = 0; x < 64; ++x) {
          const int i = (x >> 1) & 1;
          const int col = col0 + (x >> 2) * 8 + tig * 2 + (x & 1);
          if (!(row_ok[i] && col < keys &&
                in_window(col, diag[i], p.left, p.right))) {
            sc[x] = -INFINITY;
          }
        }
      }
      float tmax[2] = {kMask, kMask};
#pragma unroll
      for (int x = 0; x < 64; ++x) {
        tmax[(x >> 1) & 1] = fmaxf(tmax[(x >> 1) & 1], sc[x]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(tmax[i]) * mul);
        alpha[i] = exp2_approx(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int x = 0; x < 64; ++x) {
        const int i = (x >> 1) & 1;
        // Masked: exp2(-inf) = 0.
        const float pe = exp2_approx(fmaf(sc[x], mul, -m[i]));
        l[i] += pe;
        if constexpr (kDrop) {
          // m and l take the undropped P; P V the kept entries, keyed on
          // the packed key.
          const int col = col0 + (x >> 2) * 8 + tig * 2 + (x & 1);
          sc[x] = dropout_keep(drop_row[i], k0 + col, p.f.keep_threshold)
                      ? pe
                      : 0.f;
        } else {
          sc[x] = pe;
        }
      }
    };
    auto pack_p = [&](const float (&sc)[64], uint32_t (&pa)[kBlockN / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pa[kk][j] = Mma<T>::pack(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
        }
      }
    };

    // The consumer warpgroups take turns to issue their wgmma, in a ring,
    // as in kernel 1.
    auto turn_begin = [&] { named_barrier(kTurnBarrier + cw, 256); };
    auto turn_end = [&] {
      named_arrive(kTurnBarrier + (cw + 1) % C::kConsumers, 256);
    };
    if (n_tiles > 0 && cw == C::kConsumers - 1) named_arrive(kTurnBarrier, 256);

    if (n_tiles > 0 && wrow0 >= rows) {
      // No rows here (a short sequence or the tail of a long one): take the
      // turns and release the tiles.
      for (int it = 0; it < n_tiles; ++it) {
        turn_begin();
        turn_end();
        mbar_wait(k_full + it % kStages, (it / kStages) & 1);
        release(k_empty, it);
        mbar_wait(v_full + it % kStages, (it / kStages) & 1);
        release(v_empty, it);
      }
    } else if (n_tiles > 0) {
      // The walk, software-pipelined inside the warpgroup: the softmax of
      // tile it runs while the tensor cores do P V of tile it - 1.
      mbar_wait(q_full, 0);
      float sc[64];
      float alpha[2];
      uint32_t pa[kBlockN / 16][4];
      turn_begin();
      issue_s(sc, 0);
      turn_end();
      wgmma_wait<0>();
      fence_regs(sc);
      release(k_empty, 0);
      softmax(sc, 0, alpha);
      pack_p(sc, pa);
      for (int it = 1; it < n_tiles; ++it) {
        turn_begin();
        issue_s(sc, it);
        issue_pv(pa, it - 1);
        turn_end();
        wgmma_wait<1>();  // S of tile it (committed first) is done
        fence_regs(sc);
        release(k_empty, it);
        softmax(sc, it, alpha);
        wgmma_wait<0>();  // P V of tile it - 1 is done
        fence_regs(o);
        release(v_empty, it - 1);
#pragma unroll
        for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
        pack_p(sc, pa);
      }
      issue_pv(pa, n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(o);
      release(v_empty, n_tiles - 1);
    }

    // Epilogue: O / l into this warpgroup's rows of the Q tile (swizzled
    // as Q was), then every row below `rows` out with 16-byte stores.
    float lsum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) lsum[i] = quad_sum(l[i]);
    named_barrier(1 + cw, 128);  // the warpgroup is done reading Q
    unsigned char* so = sQ + cw * 64 * 128;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + gid + 8 * i;
      float inv = lsum[i] > 0.f ? 1.f / lsum[i] : 0.f;
      if constexpr (kDrop) inv *= p.f.keep_scale;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int chunk = (j & 7) ^ (r & 7);
        *reinterpret_cast<uint32_t*>(so + (j >> 3) * kBlockM * 128 + r * 128 +
                                     chunk * 16 + tig * 4) =
            Mma<T>::pack(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
      if (tig == 0 && row_ok[i]) {
        p.lse[head * p.total_q + q0 + wrow0 + r] =
            lsum[i] > 0.f ? (m[i] + log2f(lsum[i])) * kLn2 : -INFINITY;
      }
    }
    named_barrier(1 + cw, 128);
    T* out = static_cast<T*>(p.out) + head * p.o_h;
    constexpr int kChunks = D / 8;  // 16-byte chunks of a row
#pragma unroll
    for (int idx = t; idx < 64 * kChunks; idx += 128) {
      const int r = idx / kChunks;
      const int j = idx % kChunks;
      const int row = wrow0 + r;
      if (row < rows) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            so + (j >> 3) * kBlockM * 128 + r * 128 + (((j & 7) ^ (r & 7)) * 16));
        *reinterpret_cast<uint4*>(
            out + static_cast<long long>(q0 + row) * p.o_s + j * 8) = val;
      }
    }
  }
}

// Blocks of the flat schedule: an upper bound on sum_b cdiv(rows_b,
// kBlockM) from the packed row count and the sequence count alone.
inline long long grid_tiles(long long total_q, int nseq, int d) {
  const int bm = block_m(d);
  return (total_q + static_cast<long long>(nseq) * (bm - 1)) / bm;
}

template <typename T, int D, bool kSoftcap, bool kPaged, int kFeat = 0>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const ParamsOf<kFeat>& p, cudaStream_t stream) {
  using C = Cfg<D>;
  const long long tiles = grid_tiles(p.total_q, p.nseq, D);
  if (tiles <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      varlen_fwd_sm90_kernel<T, D, kSoftcap, kPaged, kFeat>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles), p.h);
  varlen_fwd_sm90_kernel<T, D, kSoftcap, kPaged, kFeat>
      <<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch(const CUtensorMap* maps, const Params& p, bool softcap,
             bool paged, cudaStream_t s) {
  if (paged) {
    return softcap ? launch<T, D, true, true>(maps[0], maps[1], maps[2], p, s)
                   : launch<T, D, false, true>(maps[0], maps[1], maps[2], p, s);
  }
  return softcap ? launch<T, D, true, false>(maps[0], maps[1], maps[2], p, s)
                 : launch<T, D, false, false>(maps[0], maps[1], maps[2], p, s);
}

// An instance with features: kFeat 1-3 (kFeatExt | kFeatDrop) on packed
// K/V, kFeatExt on pools; softcap or not. Returns -3 for kFeat 0 (dispatch
// takes it) and for dropout on pools.
template <typename T, int D>
int dispatch_features(const CUtensorMap* maps, const FeatParams& p,
                      bool softcap, bool paged, int feat, cudaStream_t s) {
  const CUtensorMap &tq = maps[0], &tk = maps[1], &tv = maps[2];
  if (paged) {
    if (feat != kFeatExt) return -3;
    return softcap ? launch<T, D, true, true, 1>(tq, tk, tv, p, s)
                   : launch<T, D, false, true, 1>(tq, tk, tv, p, s);
  }
  switch (feat + 4 * softcap) {
    case 1: return launch<T, D, false, false, 1>(tq, tk, tv, p, s);
    case 2: return launch<T, D, false, false, 2>(tq, tk, tv, p, s);
    case 3: return launch<T, D, false, false, 3>(tq, tk, tv, p, s);
    case 5: return launch<T, D, true, false, 1>(tq, tk, tv, p, s);
    case 6: return launch<T, D, true, false, 2>(tq, tk, tv, p, s);
    case 7: return launch<T, D, true, false, 3>(tq, tk, tv, p, s);
    default: return -3;
  }
}

}  // namespace vfwd90
}  // namespace fa
