// Vertical-slash (MInference) sparse attention forward over key-tile lists,
// for Hopper (kernel 12): out = softmax(scale * Q K^T over each 64-row
// block's attended columns [masked]) V and the fp32 log-sum-exp of every
// query row, for q (b, h, sq, d) and k, v (b, hk, sk, d) read through their
// strides.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_sparse.py:130
// (_sparse_fwd_kernel, launched at :453 by flash_attention_sparse_fwd
// :273). Features: causal or not (bottom-right aligned per batch row, off =
// used_k - used_q), seqlens_q / seqlens_k, ALiBi (slope of (b, head) at
// alibi[b * alibi_b + head]), softcap, GQA/MQA, head dim 64 or 128,
// bf16/fp16. The TPU schedule (128-row super-blocks, 512-wide KV tiles,
// int8 bitmap rows, lane-replicated m/l scratch, DMA semaphores) is not
// carried over.
//
// Function. The planner (kernels/flash_sparse.py plan_sparse) turns the
// vertical-slash metadata into, per (batch row, query head, 64-row block),
// the ascending list of 64-wide key tiles that hold an attended column,
// with one 64-bit membership word per tile (bit c: column 64 * tile + c is
// attended), after dropping the columns no row of the block can see. Query
// row i of head hq sees key column j of kv head hq / (h / hk) iff i < rows
// (min(seqlens_q[b], sq)), j < keys (min(seqlens_k[b], sk)), j's bit is set
// in its tile's word on i's block's list and, under causal masking,
// j <= i + used_k - used_q. Scores are s * scale, or tanh(s * scale /
// softcap) * softcap, then minus slope * |j - i - off| with ALiBi. Online
// softmax in fp32 (base 2); out = acc / l in q's type, lse = m + ln(l)
// (natural log); a row that sees nothing gives out 0, lse -inf; rows past
// `rows` are not written (the wrapper fills them beforehand).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * d flops
// per visible (query head, row, column) triple against q, k, v and out
// moved once; the kernel computes whole 64 x 64 listed tiles, of which the
// member columns count. At MInference densities it is bound by operations.
//
// Design: kernel 9's forward (csrc/block_sparse_fwd_sm90.cuh) on kernels
// 13-14's list merge (csrc/flash_sparse_bwd_sm90.cuh Merge, Step). A block
// is two warpgroups of 64 query rows each, 256 threads, one block per (two
// 64-row blocks 2 m and 2 m + 1, query head, batch row), two blocks to an
// SM; the grid takes the heads fastest and the last row blocks (under
// causal masks the longest lists) first. Warpgroup i owns row block 2 m + i
// and its list. Thread 0 loads Q once by TMA (4-D maps over the (b, h, s,
// d) views' strides, 128-byte swizzle), merges the two ascending tile lists
// with two pointers (the merge's state in shared memory, each list's next
// entry and word copied by cp.async a step ahead) and, for each merged
// step, writes the tile and each warpgroup's word (0: not on its list) into
// a ring slot beside the stage, then issues the stage's K and V tiles of 64
// keys by TMA before the arrive that completes its barrier. So each K/V tile
// is loaded once for the 128 rows of both lists, and the word needs no copy
// of its own (it is per tile, not per row). After the last step a sentinel
// (tile -1) whose stage carries no copy ends the walk. A ring of two stages
// at d 128, four at d 64, with full and empty mbarriers; thread 0 refills
// the stage of step x - 1 when it releases step x. Per step a warpgroup
// runs S = Q K^T (wgmma m64n64k16, both operands in shared memory), the
// online softmax on the accumulators (two rows per thread, reduced over the
// quad), P packed to 16 bits as the register A operand of O += P V (wgmma
// m64nDk16, V read N-major through the transpose flag); a warpgroup whose
// word is 0 only releases the stage. Masks, only on a tile whose word is
// not all ones, that crosses the warpgroup's first row's diagonal or that
// passes the used keys: per row a 64-bit word of the tile word's bits below
// the used keys and, with causal masking, at or left of the row's
// diagonal, one bit per element. TMA fills keys past sk with zeros, which
// would score 0, not -inf: the used-keys bound masks them. ALiBi's bias is
// added on every computed tile. A block whose two lists are empty issues no
// copy, waits on no barrier and writes out 0 and lse -inf for its rows;
// with an odd number of row blocks the last block's second list is empty
// (its count is never read). No atomics: every output element is written
// once, by the thread that summed it in a fixed order.

#pragma once

#include <climits>
#include <type_traits>

#include "flash_sparse_bwd_sm90.cuh"

namespace fa {
namespace sfwd90 {

using namespace fa::sm90;
using sparse90::col_of;
using sparse90::low_bits;
using sparse90::Merge;
using sparse90::Step;

constexpr int kWarpgroups = 2;
constexpr int kBlockRows = 64 * kWarpgroups;  // query rows per block
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTile = 64;  // keys per listed tile: the planner's 64
// Two blocks per SM, as kernel 9: four warpgroups, whose walks hide each
// other's latencies, at most 128 registers a thread.
constexpr int kBlocksPerSm = 2;

template <int D>
struct Cfg {
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kQBytes = kBlockRows * D * 2;
  static constexpr int kTileBytes = kTile * D * 2;  // one K or V tile
  // 1024 bytes of slack to align the tiles for the swizzle.
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes +
                                  8 * (1 + 2 * kStages) +
                                  kStages * sizeof(Step) + sizeof(Merge);
};

struct Params {
  void* out;   // (b, h, sq, d) through o_b, o_h, o_s
  float* lse;  // (b, h, sq) contiguous
  long long o_b, o_h, o_s;
  int h, group, sq, sk, nqb;
  int causal;
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2 with
  // a softcap.
  float score_mul, cap_log2;
  // Lists of list_len entries per (b, head, 64-row block), at row
  // (b * h + head) * nqb + block; counts[row] of them used.
  const int* counts;
  const int* tiles;
  const unsigned long long* words;
  long long list_len;
  const int* used_q;  // seqlens_q (b) or null
  const int* used_k;  // seqlens_k (b) or null
  const float* alibi;
  int alibi_b;
};

template <typename T, int D, bool kSoftcap, bool kAlibi>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    sparse_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Params p) {
  using C = Cfg<D>;
  constexpr int kStages = C::kStages;
  constexpr int kBlocksD = D / 64;  // 128-byte column blocks of a row
  extern __shared__ unsigned char smem_sfwd90[];
  unsigned char* sQ =
      smem_sfwd90 + ((1024 - (smem_u32(smem_sfwd90) & 1023)) & 1023);
  unsigned char* sK = sQ + C::kQBytes;
  unsigned char* sV = sK + kStages * C::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * C::kTileBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  Step* ring = reinterpret_cast<Step*>(empty + kStages);
  Merge* mg = reinterpret_cast<Merge*>(ring + kStages);

  const int head = blockIdx.x;
  const int b = blockIdx.z;
  const int pair = gridDim.y - 1 - blockIdx.y;  // 64-row blocks 2 pair, +1
  const int row0 = pair * kBlockRows;
  const long long lrow =
      (static_cast<long long>(b) * p.h + head) * p.nqb + 2 * pair;
  const int n0 = p.counts[lrow];
  const int n1 = 2 * pair + 1 < p.nqb ? p.counts[lrow + 1] : 0;
  const int uq = p.used_q ? p.used_q[b] : p.sq;
  const int uk = p.used_k ? p.used_k[b] : p.sk;
  const int rows = max(min(uq, p.sq), 0);
  const int keys = max(min(uk, p.sk), 0);
  const int off = uk - uq;
  const int tid = threadIdx.x;
  const int cw = tid >> 7;  // warpgroup: rows 64 cw..
  const int t = tid & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wrow0 = row0 + cw * 64;

  int row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) row[i] = wrow0 + warp * 16 + gid + 8 * i;
  float o[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  if (n0 + n1 > 0) {
    if (tid == 0) {
      mbar_init(q_full, 1);
#pragma unroll
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, 4 * kWarpgroups);  // lane 0 of each warp
      }
      fence_barrier_init();
    }
    __syncthreads();

    // The ring, filled by thread 0: the merged tiles, then a sentinel; item
    // y into stage y % kStages once every warp has released item y -
    // kStages.
    const int g = head / p.group;
    auto produce = [&] {
      const int y = mg->produced;
      const int s = y % kStages;
      mbar_wait(empty + s, ((y / kStages) & 1) ^ 1);
      unsigned long long w[2];
      const int tile = mg->next(w);
      Step& st = ring[s];
      if (tile == INT_MAX) {
        st.at = -1;
        mbar_arrive(full + s);
        mg->pass = 2;
      } else {
        st.at = tile;
        st.word[0] = w[0];
        st.word[1] = w[1];
        mbar_expect_tx(full + s, 2 * C::kTileBytes);
#pragma unroll
        for (int cb = 0; cb < kBlocksD; ++cb) {
          tma_load_4d(sK + s * C::kTileBytes + cb * kTile * 128, &tk, full + s,
                      cb * 64, tile * kTile, g, b);
          tma_load_4d(sV + s * C::kTileBytes + cb * kTile * 128, &tv, full + s,
                      cb * 64, tile * kTile, g, b);
        }
      }
      mg->produced = y + 1;
    };
    if (tid == 0) {
      mg->at[0] = p.tiles + lrow * p.list_len;
      mg->at[1] = mg->at[0] + p.list_len;
      mg->wd[0] = p.words + lrow * p.list_len;
      mg->wd[1] = mg->wd[0] + p.list_len;
      mg->n[0] = n0;
      mg->n[1] = n1;
      mg->produced = mg->pass = 0;
      mg->restart();
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int cb = 0; cb < kBlocksD; ++cb) {
        tma_load_4d(sQ + cb * kBlockRows * 128, &tq, q_full, cb * 64, row0,
                    head, b);
      }
      for (int y = 0; y < kStages && mg->pass < 2; ++y) produce();
    }

    // Descriptors: this warpgroup's Q rows and K K-major, V N-major.
    const uint64_t q_desc = make_desc(sQ + cw * 64 * 128, 16, 1024);
    const uint64_t k_desc = make_desc(sK, 16, 1024);
    const uint64_t v_desc = make_desc(sV, kTile * 128, 1024);
    float sc[kTile / 2];
    uint32_t pa[kTile / 16][4];
    float alpha[2];
    float slope2 = 0.f;  // ALiBi slope, base 2
    if constexpr (kAlibi) {
      slope2 = __ldg(p.alibi + b * p.alibi_b + head) * kLog2e;
    }

    // S = Q K^T of stage s into sc, waited for.
    auto scores = [&](int s) {
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // k16 step kk: column block kk / 4, 32 bytes per step inside it.
        const uint32_t qa = ((kk >> 2) * kBlockRows * 128 + (kk & 3) * 32) >> 4;
        const uint32_t kb =
            (s * C::kTileBytes + (kk >> 2) * kTile * 128 + (kk & 3) * 32) >> 4;
        wgmma_ss<T, kTile>(sc, q_desc + qa, k_desc + kb, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
    };
    // Softcap, scale (base 2), ALiBi, the mask of tile `tile` and word `w`
    // (with kMasked) and the online softmax of the step: sc becomes P,
    // alpha the factor O must be rescaled by. Element x is row (x >> 1) & 1,
    // column col0 + 2 tig + col_of(x).
    auto softmax = [&](auto masked, int tile, unsigned long long w) {
      // Without a softcap or ALiBi the scale folds into the exponent's FFMA
      // (it is positive, so the row max commutes with it).
      constexpr bool kScaled = kSoftcap || kAlibi;
      const float mul = kScaled ? 1.f : p.score_mul;
      const int c0 = tile * kTile + 2 * tig;
      if constexpr (kSoftcap) {
#pragma unroll
        for (int x = 0; x < kTile / 2; ++x) {
          sc[x] = tanhf(sc[x] * p.score_mul) * p.cap_log2;
        }
      } else if constexpr (kAlibi) {
#pragma unroll
        for (int x = 0; x < kTile / 2; ++x) sc[x] *= p.score_mul;
      }
      if constexpr (kAlibi) {
        float dist[2];  // each row's c0 less its diagonal
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dist[i] = static_cast<float>(c0 - row[i] - off);
        }
#pragma unroll
        for (int x = 0; x < kTile / 2; ++x) {
          sc[x] -= slope2 * fabsf(dist[(x >> 1) & 1] + col_of(x));
        }
      }
      if constexpr (decltype(masked)::value) {
        // Per row, bit j for column c0 + j: the word's, below the used keys
        // and, with causal masking, at or left of the row's diagonal.
        const unsigned long long mk = (w >> (2 * tig)) & low_bits(keys - c0);
        unsigned long long wr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wr[i] = p.causal ? mk & low_bits(row[i] + off - c0 + 1) : mk;
        }
#pragma unroll
        for (int x = 0; x < kTile / 2; ++x) {
          if (!((wr[(x >> 1) & 1] >> col_of(x)) & 1ull)) sc[x] = -INFINITY;
        }
      }
      float tmax[2] = {kMask, kMask};
#pragma unroll
      for (int x = 0; x < kTile / 2; ++x) {
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
      for (int x = 0; x < kTile / 2; ++x) {
        const int i = (x >> 1) & 1;
        // Masked: exp2(-inf) = 0.
        const float pe = exp2_approx(fmaf(sc[x], mul, -m[i]));
        l[i] += pe;
        sc[x] = pe;
      }
    };
    // O = alpha O + P V of stage s, waited for.
    auto accumulate = [&](int s) {
#pragma unroll
      for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pa[kk][j] = Mma<T>::pack(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
        }
      }
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wgmma_rs<T, D>(o, pa[kk],
                       v_desc + ((s * C::kTileBytes + kk * 16 * 128) >> 4), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    };

    mbar_wait(q_full, 0);
    for (int x = 0;; ++x) {
      const int s = x % kStages;
      mbar_wait(full + s, (x / kStages) & 1);
      const int tile = ring[s].at;
      const unsigned long long w = ring[s].word[cw];
      if (tile >= 0 && w) {
        scores(s);
        // Every row of this warpgroup sees every key of the tile?
        const int col0 = tile * kTile;
        if (w == ~0ull && col0 + kTile <= keys &&
            (!p.causal || col0 + kTile - 1 <= wrow0 + off)) {
          softmax(std::false_type(), tile, w);
        } else {
          softmax(std::true_type(), tile, w);
        }
        accumulate(s);
      }
      // Release the stage; thread 0 then refills the stage of step x - 1,
      // which the other warpgroup has most likely released by then.
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
      if (tid == 0 && mg->pass < 2 && mg->produced <= x - 1 + kStages) {
        produce();
      }
      if (tile < 0) break;
    }
  }

  // O / l and the LSE of this thread's rows below `rows`, 4 bytes at a time.
  T* out = static_cast<T*>(p.out) + b * p.o_b + head * p.o_h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    if (row[i] >= rows) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    T* dst = out + static_cast<long long>(row[i]) * p.o_s + tig * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          Mma<T>::pack(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    }
    if (tig == 0) {
      p.lse[(static_cast<long long>(b) * p.h + head) * p.sq + row[i]] =
          lsum > 0.f ? (m[i] + log2f(lsum)) * kLn2 : -INFINITY;
    }
  }
}

template <typename T, int D, bool kSoftcap, bool kAlibi>
int launch(const CUtensorMap* maps, const Params& p, int batch,
           cudaStream_t stream) {
  const size_t smem = Cfg<D>::kSmem;
  auto kernel = sparse_fwd_sm90_kernel<T, D, kSoftcap, kAlibi>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.h, (p.nqb + 1) / 2, batch);
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

// The softcap and ALiBi are template parameters, so a kernel without one
// carries no tanh (or bias) in its score loop.
template <typename T, int D>
int dispatch(const CUtensorMap* maps, const Params& p, int batch,
             cudaStream_t s) {
  const bool cap = p.cap_log2 > 0.f;
  if (p.alibi) {
    return cap ? launch<T, D, true, true>(maps, p, batch, s)
               : launch<T, D, false, true>(maps, p, batch, s);
  }
  return cap ? launch<T, D, true, false>(maps, p, batch, s)
             : launch<T, D, false, false>(maps, p, batch, s);
}

}  // namespace sfwd90
}  // namespace fa
