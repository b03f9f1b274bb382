// Block-sparse attention forward for Hopper (kernel 9): out =
// softmax(scale * Q K^T restricted to a plan's kept elements) V, and the
// fp32 log-sum-exp of every query row, for q (b, h, sq, d) and k, v
// (b, hk, sk, d) read through their strides.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/block_sparsity.py:455
// (_bs_fwd_kernel, launched at :718 by flash_attention_blocksparse_fwd
// :627), restricted to mask_mod plans: scale, softcap, GQA/MQA, head dim 64
// or 128, bf16/fp16. The TPU schedule (a flat host worklist of plan tiles
// with chain flags, 128-lane padding, lane-replicated m/l scratch, the mod
// evaluated inside the kernel) is not carried over: a CUDA kernel cannot
// call the Python mod, so the mod's result arrives as per-row words
// (csrc/block_sparse.cuh).
//
// Function. Query row i of head hq sees key column j of kv head hq / (h /
// hk) iff (i, j) is kept: its 64 x 64 sub-tile is on the row block's list
// and its mode keeps it (csrc/block_sparse.cuh). Scores are s * scale, or
// tanh(s * scale / softcap) * softcap. Online softmax in fp32 (base 2).
// out = acc / l in q's type; lse = m + ln(l), natural log; a row that sees
// nothing gives out 0, lse -inf. Every row below seqlen_q is written.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * d flops
// per kept (query head, row, column) triple against q, k, v and out moved
// once; the kernel computes whole 64 x 64 sub-tiles, of which the kept
// elements count. At the plans' densities (0.1-0.5 at s 8192, d 128) it is
// bound by operations.
//
// Design: the pieces of kernel 1 (csrc/flash_fwd_sm90.cuh) and the list
// merging of kernels 13-14 (csrc/flash_sparse_bwd_sm90.cuh). A block is two
// warpgroups of 64 query rows each, 256 threads, one block per (two 64-row
// blocks 2 m and 2 m + 1, query head, batch row), two blocks to an SM; the
// grid takes the heads fastest and the last row blocks (under causal masks
// the longest lists) first (the first row blocks first ran 1.19x slower on
// a prefix-LM mask). Warpgroup i owns row block 2 m + i and its list.
// Thread 0 loads Q once by TMA, merges the two lists (ascending entries
// (index << 2) | mode) with two pointers, and for each merged step writes
// the key tile and each warpgroup's mode, or "absent", into a ring slot
// beside the stage, then issues the stage's copies before the arrive that
// completes its barrier: the K and V tiles (64 keys, TMA 4-D maps over the
// (b, h, s, d) views' strides, 128-byte swizzle) and, for a warpgroup in
// mode 2, its sub-tile's 64 row words (512 bytes by the bulk copy engine).
// So each K/V tile is loaded once for the 128 rows of both lists, and every
// thread finds its two rows' words in the stage. The merge's state lives in
// shared memory, its next entries copied by cp.async a step ahead. A ring
// of two stages at d 128, four at d 64, with full and empty mbarriers;
// thread 0 refills the stage of step x - 1 when it releases step x. Per
// step a warpgroup runs S = Q K^T (wgmma m64n64k16, both operands in shared
// memory), the online softmax on the accumulators (two rows per thread,
// reduced over the quad), P packed to 16 bits as the register A operand of
// O += P V (wgmma m64nDk16, V read N-major through the transpose flag); a
// warpgroup whose list lacks the tile only releases the stage. The four
// warpgroups of an SM overlap each other's products and softmax:
// pipelining S of a step with P V of the step before inside a warpgroup,
// as kernel 1 does, ran 1.05-1.13x slower at one block per SM (PERF.md
// §6). Masks by mode: mode 0 skips the mask; mode 1 tests the bounds
// (low_bits(sk - col0), rows < sq); mode 2 one bit of the row's word per
// element. TMA fills keys past sk with zeros, which would score 0, not
// -inf; a sub-tile that reaches past sk is never mode 0
// (kernels/block_sparsity.py build_execution_lists), so the bounds are
// always tested there. A block whose two lists are empty issues no copy,
// waits on no barrier and writes zeros; with an odd number of row blocks
// the last block's second list is empty (its count is never read). Rows
// >= sq are never stored. No atomics: every output element is written
// once, by the thread that summed it in a fixed order.

#pragma once

#include <climits>
#include <type_traits>

#include "block_sparse.cuh"
#include "sm90_utils.cuh"

namespace fa {
namespace bs90 {

using namespace fa::sm90;

constexpr int kWarpgroups = 2;
constexpr int kBlockRows = 64 * kWarpgroups;  // query rows per block
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTile = bs::kSub;  // keys per listed tile
constexpr int kWordBytes = kTile * 8;  // a sub-tile's 64 row words

// One ring slot: the step's key tile (-1: the end of the walk) and each
// warpgroup's mode, -1 where the tile is not on its list.
struct Step {
  int tile;
  int mode[kWarpgroups];
};

// Thread 0's ascending merge of the block's two lists (entries `ent`, word
// groups `wofs`, n used), kept in shared memory. Entry i of list l is
// copied into slot i % 2 of its head when entry i - 1 is taken, so a copy
// never lands in the slot just read.
struct Merge {
  const int* ent[2];
  const int* wofs[2];
  int head[2][2];
  int wo[2][2];
  int n[2], i[2];
  int produced;  // ring items issued
  int done;      // the end of the walk has been issued

  __device__ __forceinline__ void read(int l) {
    const int k = i[l];
    if (k < n[l]) {
      cp_async_4(&head[l][k & 1], ent[l] + k);
      cp_async_4(&wo[l][k & 1], wofs[l] + k);
    } else {
      head[l][k & 1] = INT_MAX;
    }
  }
  // The next merged key tile and each list's mode and word group for it
  // (mode -1 if not on the list); INT_MAX past the end.
  __device__ __forceinline__ int next(int (&mode)[2], int (&group)[2]) {
    cp_async_wait_all();
    int tile[2];
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int h = head[l][i[l] & 1];
      tile[l] = h == INT_MAX ? INT_MAX : h >> 2;
    }
    const int t = min(tile[0], tile[1]);
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (t != INT_MAX && tile[l] == t) {
        mode[l] = head[l][i[l] & 1] & 3;
        group[l] = wo[l][i[l] & 1];
        ++i[l];
        read(l);
      } else {
        mode[l] = -1;
        group[l] = 0;
      }
    }
    return t;
  }
};

// Two blocks per SM: four warpgroups, whose walks hide each other's
// latencies. A thread's registers then fit in 128 (ptxas gives 93-128, no
// spills), and two blocks' shared memory in the SM's with two stages at
// d 128, four at d 64.
constexpr int kBlocksPerSm = 2;

template <int D>
struct Cfg {
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kQBytes = kBlockRows * D * 2;
  static constexpr int kTileBytes = kTile * D * 2;  // one K or V tile
  // 1024 bytes of slack to align the tiles for the swizzle.
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes +
      kStages * kWarpgroups * kWordBytes + 8 * (1 + 2 * kStages) +
      sizeof(Merge) + kStages * sizeof(Step);
};

struct Params {
  void* out;   // (b, h, sq, d) through o_b, o_h, o_s
  float* lse;  // (b, h, sq) contiguous
  long long o_b, o_h, o_s;
  int h, group, sq, sk, nqb;
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2 with
  // a softcap.
  float score_mul, cap_log2;
  // Lists of list_len entries per (b, head, 64-row block), at row
  // (b * h + head) * nqb + block; counts[row] of them used.
  const int* counts;
  const int* tiles;
  const int* wofs;
  const unsigned long long* words;
  long long list_len;
};

template <typename T, int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bs_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const Params p) {
  using C = Cfg<D>;
  constexpr int kStages = C::kStages;
  constexpr int kBlocksD = D / 64;  // 128-byte column blocks of a row
  extern __shared__ unsigned char smem_bs90[];
  unsigned char* sQ =
      smem_bs90 + ((1024 - (smem_u32(smem_bs90) & 1023)) & 1023);
  unsigned char* sK = sQ + C::kQBytes;
  unsigned char* sV = sK + kStages * C::kTileBytes;
  // [kStages][kWarpgroups][kTile]: the mode-2 words of each step.
  unsigned long long* sW =
      reinterpret_cast<unsigned long long*>(sV + kStages * C::kTileBytes);
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(sW + kStages * kWarpgroups * kTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  Merge* mg = reinterpret_cast<Merge*>(empty + kStages);
  Step* ring = reinterpret_cast<Step*>(mg + 1);

  const int head = blockIdx.x;
  const int b = blockIdx.z;
  const int pair = gridDim.y - 1 - blockIdx.y;  // 64-row blocks 2 pair, +1
  const int row0 = pair * kBlockRows;
  const long long lrow =
      (static_cast<long long>(b) * p.h + head) * p.nqb + 2 * pair;
  const int n0 = p.counts[lrow];
  const int n1 = 2 * pair + 1 < p.nqb ? p.counts[lrow + 1] : 0;
  const int tid = threadIdx.x;
  const int cw = tid >> 7;  // warpgroup: rows 64 cw..
  const int t = tid & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wrow0 = row0 + cw * 64;

  int r_local[2], row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r_local[i] = warp * 16 + gid + 8 * i;
    row[i] = wrow0 + r_local[i];
  }
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

    // The ring, filled by thread 0: the merged steps, then the end; item y
    // into stage y % kStages once every warp has released item y - kStages.
    const int g = head / p.group;
    auto produce = [&] {
      const int y = mg->produced;
      const int s = y % kStages;
      mbar_wait(empty + s, ((y / kStages) & 1) ^ 1);
      int mode[2], group[2];
      const int tile = mg->next(mode, group);
      Step& st = ring[s];
      if (tile == INT_MAX) {
        st.tile = -1;
        mbar_arrive(full + s);
        mg->done = 1;
      } else {
        st.tile = tile;
        st.mode[0] = mode[0];
        st.mode[1] = mode[1];
        mbar_expect_tx(full + s, 2 * C::kTileBytes +
                                     kWordBytes * ((mode[0] == 2) +
                                                   (mode[1] == 2)));
#pragma unroll
        for (int cb = 0; cb < kBlocksD; ++cb) {
          tma_load_4d(sK + s * C::kTileBytes + cb * kTile * 128, &tk,
                      full + s, cb * 64, tile * kTile, g, b);
          tma_load_4d(sV + s * C::kTileBytes + cb * kTile * 128, &tv,
                      full + s, cb * 64, tile * kTile, g, b);
        }
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          if (mode[l] == 2) {
            bulk_load(sW + (s * kWarpgroups + l) * kTile,
                      p.words + static_cast<long long>(group[l]) * kTile,
                      kWordBytes, full + s);
          }
        }
      }
      mg->produced = y + 1;
    };
    if (tid == 0) {
      mg->ent[0] = p.tiles + lrow * p.list_len;
      mg->ent[1] = mg->ent[0] + p.list_len;
      mg->wofs[0] = p.wofs + lrow * p.list_len;
      mg->wofs[1] = mg->wofs[0] + p.list_len;
      mg->n[0] = n0;
      mg->n[1] = n1;
      mg->i[0] = mg->i[1] = 0;
      mg->produced = mg->done = 0;
      mg->read(0);
      mg->read(1);
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int cb = 0; cb < kBlocksD; ++cb) {
        tma_load_4d(sQ + cb * kBlockRows * 128, &tq, q_full, cb * 64, row0,
                    head, b);
      }
      for (int y = 0; y < kStages && !mg->done; ++y) produce();
    }

    // Descriptors: this warpgroup's Q rows and K K-major, V N-major.
    const uint64_t q_desc = make_desc(sQ + cw * 64 * 128, 16, 1024);
    const uint64_t k_desc = make_desc(sK, 16, 1024);
    const uint64_t v_desc = make_desc(sV, kTile * 128, 1024);
    float sc[kTile / 2];
    uint32_t pa[kTile / 16][4];
    float alpha[2];

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
    // Softcap, the mask (the rows' words w, with kMasked), scale (base 2)
    // and the online softmax of the step: sc becomes P, alpha the factor O
    // must be rescaled by.
    auto softmax = [&](auto masked, const unsigned long long (&w)[2]) {
      // Without a softcap the scale folds into the exponent's FFMA (it is
      // positive, so the row max commutes with it).
      const float mul = kSoftcap ? 1.f : p.score_mul;
      if constexpr (kSoftcap) {
#pragma unroll
        for (int x = 0; x < kTile / 2; ++x) {
          sc[x] = tanhf(sc[x] * p.score_mul) * p.cap_log2;
        }
      }
      if constexpr (decltype(masked)::value) {
        // Element x is row (x >> 1) & 1, column (x >> 2) * 8 + 2 tig + (x & 1).
        const unsigned long long wr[2] = {w[0] >> (2 * tig), w[1] >> (2 * tig)};
#pragma unroll
        for (int x = 0; x < kTile / 2; ++x) {
          if (!((wr[(x >> 1) & 1] >> ((x >> 2) * 8 + (x & 1))) & 1ull)) {
            sc[x] = -INFINITY;
          }
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
      const int tile = ring[s].tile;
      const int mode = ring[s].mode[cw];
      if (tile >= 0 && mode >= 0) {
        scores(s);
        if (mode == 0) {
          const unsigned long long w[2] = {~0ull, ~0ull};
          softmax(std::false_type(), w);
        } else {
          unsigned long long w[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            w[i] = mode == 2 ? sW[(s * kWarpgroups + cw) * kTile + r_local[i]]
                   : row[i] < p.sq ? bs::low_bits(p.sk - tile * kTile)
                                   : 0ull;
          }
          softmax(std::true_type(), w);
        }
        accumulate(s);
      }
      // Release the stage; thread 0 then refills the stage of step x - 1,
      // which the other warpgroup has most likely released by then.
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
      if (tid == 0 && !mg->done && mg->produced <= x - 1 + kStages) produce();
      if (tile < 0) break;
    }
  }

  // O / l and the LSE of this thread's rows below sq, 4 bytes at a time.
  T* out = static_cast<T*>(p.out) + b * p.o_b + head * p.o_h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    if (row[i] >= p.sq) continue;
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

template <typename T, int D, bool kSoftcap>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = Cfg<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      bs_fwd_sm90_kernel<T, D, kSoftcap>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.h, (p.nqb + 1) / 2, batch);
  bs_fwd_sm90_kernel<T, D, kSoftcap>
      <<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bs90
}  // namespace fa
