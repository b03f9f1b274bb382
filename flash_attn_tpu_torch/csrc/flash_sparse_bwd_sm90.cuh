// Vertical-slash (MInference) sparse attention backward for Hopper (kernels
// 13 and 14): dK/dV over the inverse lists and dQ with delta over the
// forward's lists, for q (b, h, sq, d), k, v (b, hk, sk, d) and dO read
// through their strides.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_sparse.py:542
// (_sparse_dkv_kernel, launched at :855) and :638 (_sparse_dq_kernel,
// launched at :915), both called by flash_attention_sparse_bwd (:713).
// Features: causal or not (bottom-right aligned per batch row, off =
// used_k - used_q), seqlens_q / seqlens_k, ALiBi (slope of (b, head) at
// alibi[b * alibi_b + head]), softcap, GQA/MQA, head dim 64 or 128,
// bf16/fp16.
//
// Function. A sparse call is a dense one whose visible (row, key) pairs are
// further cut to the attended set of each row's 64-row block: the key
// tiles on that block's list (kernels/flash_sparse.py plan_sparse), bit
// c of a tile's 64-bit word for key 64 * tile + c. With s = q . k,
//   t  = tanh(s * scale / softcap)                         (softcap only)
//   P  = exp(s * scale [or t * softcap] - slope |j - i - off| - lse), 0 where
//        masked and on rows whose lse is -inf or that lie past seqlens_q
//   dP = dO . v,  delta = sum_j P dP (per query row, fp32)
//   dS = P (dP - delta) scale  [(1 - t^2) with softcap]
//   dV = sum P^T dO,  dK = sum dS^T Q,  dQ = sum dS K,
// dK and dV summed over each kv head's group of query heads. delta is summed
// in fp32 by the dQ kernel, which runs first (see csrc/flash_bwd_sm90.cuh).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): dK/dV needs 8 d
// flops per visible (query head, row, key) triple, dQ 6 d; this dQ kernel
// does 10 d (S and dP twice). At MInference densities both are bound by
// operations.
//
// Design: the skeleton of kernels 2-3 (csrc/flash_bwd_sm90.cuh). A block is
// two warpgroups of 64 rows each, 256 threads; thread 0 issues every TMA
// copy into a ring of kStages stages with full and empty mbarriers; S and
// dP on wgmma with both operands in shared memory, dV, dK and dQ with P^T,
// dS^T or dS as the register A operand. No atomics: every output element is
// summed by one thread in a fixed order. The walk comes from the lists:
//  * dQ (kernel 14): one block per (two 64-row blocks 2m and 2m + 1, query
//    head, batch row), the last blocks first; each warpgroup owns one of
//    the two and its list. The block walks the ascending merge of the two
//    lists, so each listed K/V tile of 64 keys is loaded once, twice in all
//    (pass 1 sums delta, pass 2 accumulates dQ). Its consumer is
//    dq_list_walk (csrc/flash_bwd_sm90.cuh), which kernel 11 shares.
//  * dK/dV (kernel 13): one block per (two 64-key tiles 2t and 2t + 1, kv
//    head, batch row), the first tiles first; each warpgroup owns one tile
//    and its inverse list of (head in group * nqb + block) entries. The
//    block walks the ascending merge of the two lists and loads one Q, dO,
//    LSE and delta tile of 64 rows per merged entry. The warpgroups do not
//    take turns to issue their products as kernel 2's do (the turns made
//    this kernel 1.22x slower). Kernel 10's dK/dV
//    (csrc/block_sparse_bwd_sm90.cuh) runs this consumer's steps on its own
//    lists; sharing the code moved this kernel's registers (-1 and -2 in
//    four of its sixteen instances), so it keeps its own.
// Thread 0 merges the two lists with two pointers. The merge's state lives
// in shared memory, so that it holds none of the consumers' registers, and
// each list's next entry and word are copied there by cp.async when the one
// before is taken, a step ahead of their use. Thread 0 writes each step's
// tile or entry and the two words into a shared ring slot beside the stage
// before the arrive that publishes the stage; a step past the end of a pass
// is a sentinel (tile -1) whose stage carries no copy. A warpgroup whose
// word is 0 skips its products but still releases the stage. A merged step
// never has both words 0, and no tile is loaded twice in a pass. A block
// whose two lists are empty issues no copy, waits on no barrier and writes
// zeros (rows and keys within the used lengths). With an odd nqb or nkb the
// second list of the last block is empty: its count is never read. The grid
// takes the heads fastest, so that the blocks with the longest lists (the
// first key tiles and the last query blocks under causal masking) of every
// head start first.
// Masks, in order: the word's bit per key, the per-row causal diagonal,
// rows past seqlens_q (their LSE becomes +inf in base 2, so P = 0; not
// written), keys past seqlens_k (masked; not written). Only a tile that is
// not all ones, crosses the diagonal or passes the used keys pays for the
// per-element test. TMA fills boxes past the tensors' ends with zeros.

#pragma once

#include <climits>

#include "flash_bwd_sm90.cuh"

namespace fa {
namespace sparse90 {

using namespace fa::sm90;
using fa::bwd90::Bool;
using fa::bwd90::dq_list_walk;
using fa::bwd90::DqShared;
using fa::bwd90::kBlockRows;
using fa::bwd90::kThreads;
using fa::bwd90::kWarpgroups;
using fa::bwd90::lse_base2;
using fa::bwd90::pack_a;
using fa::bwd90::set_smem;
using fa::bwd90::store_rows;

// Keys per listed tile (dQ) and query rows per listed block (dK/dV), at
// both head dims: the planner's 64.
constexpr int kTile = 64;
constexpr int kStages = 4;

// One ring slot: the step's key tile (dQ) or inverse-list entry (dK/dV),
// -1 for a sentinel, and each warpgroup's word (0: not on its list).
struct Step {
  unsigned long long word[kWarpgroups];
  int at;
};

// Thread 0's ascending merge of the block's two lists (entries `at`,
// words `wd`, n used), kept in shared memory. Entry i of list l is copied
// into slot i % 2 of its head and word when entry i - 1 is taken, so a
// copy never lands in the slot just read.
struct Merge {
  const int* at[2];
  const unsigned long long* wd[2];
  unsigned long long w[2][2];
  int head[2][2];
  int n[2], i[2];
  int produced;  // ring items issued
  int pass;      // dQ: 0, 1, then 2 when done; dK/dV: 0, then 2

  __device__ __forceinline__ void read(int l) {
    const int k = i[l];
    if (k < n[l]) {
      cp_async_4(&head[l][k & 1], at[l] + k);
      cp_async_8(&w[l][k & 1], wd[l] + k);
    } else {
      head[l][k & 1] = INT_MAX;
    }
  }
  __device__ __forceinline__ void restart() {
    i[0] = i[1] = 0;
    read(0);
    read(1);
  }
  // The next merged entry and each list's word for it (0 if not on the
  // list); INT_MAX past the end.
  __device__ __forceinline__ int next(unsigned long long (&word)[2]) {
    cp_async_wait_all();
    const int h0 = head[0][i[0] & 1];
    const int h1 = head[1][i[1] & 1];
    const int t = min(h0, h1);
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (t != INT_MAX && (l ? h1 : h0) == t) {
        word[l] = w[l][i[l] & 1];
        ++i[l];
        read(l);
      } else {
        word[l] = 0;
      }
    }
    return t;
  }
};

template <int D>
struct DqCfg {
  static constexpr int kQBytes = kBlockRows * D * 2;  // the Q or dO tile
  static constexpr int kTileBytes = kTile * D * 2;    // one K or V tile
  // 1024 bytes of slack to align the tiles for the swizzle.
  static constexpr size_t kSmem = 1024 + 2 * kQBytes +
                                  2 * kStages * kTileBytes +
                                  8 * (1 + 2 * kStages) +
                                  kStages * sizeof(Step) + sizeof(Merge);
};

template <int D>
struct DkvCfg {
  static constexpr int kKVBytes = kBlockRows * D * 2;  // the K or V tile
  static constexpr int kQBytes = kTile * D * 2;        // one Q or dO tile
  static constexpr int kStatBytes = kTile * 4;         // one LSE or delta tile
  // LSE and delta tiles from a 16-byte aligned start, as kernel 2's
  // (csrc/flash_bwd_sm90.cuh DkvCfg): kStatBox values from up to 3 rows
  // before the tile's first row, in a slot of kStatStride.
  static constexpr int kStatBox = kTile + 4;
  static constexpr int kStatStride = kTile + 32;
  // Per stage: Q, dO, LSE, delta, each warpgroup's copy of the LSE in base
  // 2, and the rows' offset.
  static constexpr size_t kSmem =
      1024 + 2 * kKVBytes +
      kStages * (2 * kQBytes + 2 * 4 * kStatStride + kWarpgroups * kStatBytes) +
      8 * (1 + 2 * kStages) + kStages * sizeof(Step) + sizeof(Merge) +
      4 * kStages;
};

struct Params {
  const float* lse;  // (b, h, sq) contiguous, natural log (dQ kernel)
  float* delta;      // (b, h, sq) contiguous, written by the dQ kernel
  void* dq;          // (b, h, sq, d) through dq_b, dq_h, dq_s
  void* dk;          // (b, hk, sk, d) through dk_*
  void* dv;          // (b, hk, sk, d) through dv_*
  long long dq_b, dq_h, dq_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  // The forward's lists (dQ): list_len entries per (b, head, 64-row block)
  // at row (b * h + head) * nqb + block, counts[row] of them used; the
  // inverse lists (dK/dV): inv_len entries per (b, kv head, 64-key tile) at
  // row (b * hk + kv head) * nkb + tile, inv_idx = head in group * nqb +
  // block; each with its membership word.
  const int* counts;
  const int* tiles;
  const unsigned long long* words;
  const int* inv_counts;
  const int* inv_idx;
  const unsigned long long* inv_words;
  long long list_len, inv_len;
  const int* used_q;  // seqlens_q (b) or null
  const int* used_k;  // seqlens_k (b) or null
  const float* alibi;
  int alibi_b;
  int h, group, sq, sk, nqb, nkb;
  int causal;
  float scale;
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2 with
  // a softcap.
  float score_mul, cap_log2;
};

// One batch row's used rows and keys and its diagonal offset.
struct Lens {
  int rows, keys, off;
};

__device__ __forceinline__ Lens lens_of(const Params& p, int b) {
  const int uq = p.used_q ? p.used_q[b] : p.sq;
  const int uk = p.used_k ? p.used_k[b] : p.sk;
  return {max(min(uq, p.sq), 0), max(min(uk, p.sk), 0), uk - uq};
}

// The word with the low n bits set, n clamped to [0, 64].
__device__ __forceinline__ unsigned long long low_bits(int n) {
  return n <= 0 ? 0ull : n >= 64 ? ~0ull : (1ull << n) - 1;
}

// P of score s given its row's LSE in base 2 and the ALiBi term in base 2
// (read only with kAlibi), and dS's factor dmul: the scale, times 1 - t^2
// under a softcap.
template <bool kSoftcap, bool kAlibi>
__device__ __forceinline__ float prob(const Params& p, float s, float lse2,
                                      float bias, float& dmul) {
  float x;
  if constexpr (kSoftcap) {
    const float t = tanhf(s * p.score_mul);
    dmul = (1.f - t * t) * p.scale;
    x = t * p.cap_log2 - lse2;
  } else {
    dmul = p.scale;
    x = fmaf(s, p.score_mul, -lse2);
  }
  if constexpr (kAlibi) x -= bias;
  return exp2_approx(x);
}

// A dQ step's mask, one word per row of this thread, bit j for column col0
// + 2 tig + j: the tile word's bits, under the used keys and, with causal
// masking, at or left of the row's diagonal; so that element e (column
// offset col_of(e) below) tests one bit. `diag`: each row's diagonal
// relative to col0 + 2 tig, for ALiBi.
struct Cut {
  unsigned long long row[2];
  int diag[2];
};

// Element e's column offset from col0 + 2 tig.
__device__ __forceinline__ int col_of(int e) { return (e >> 2) * 8 + (e & 1); }

// The dQ kernel's hooks for dq_list_walk (csrc/flash_bwd_sm90.cuh): a ring
// item is a key tile and each warpgroup's word (0: not on its list).
template <bool kSoftcap, bool kAlibi>
struct DqItems {
  struct Item {
    unsigned long long w;
  };
  const Params& p;
  const Lens& ln;
  int cw, tig, wrow0;
  const int (&dg)[2];  // each row's causal diagonal
  float slope2;  // ALiBi slope in base 2

  __device__ __forceinline__ int read(const Step& st, int, Item& it) const {
    it.w = st.word[cw];
    return st.at;
  }
  __device__ __forceinline__ bool on(const Item& it) const { return it.w; }
  // Whether every row of this warpgroup sees every key of the tile.
  __device__ __forceinline__ bool unmasked(int col0, const Item& it) const {
    return it.w == ~0ull && col0 + kTile <= ln.keys &&
           (!p.causal || col0 + kTile - 1 <= wrow0 + ln.off);
  }
  __device__ __forceinline__ Cut mask(int col0, const Item& it) const {
    const int c0 = col0 + tig * 2;
    const unsigned long long m = (it.w >> (tig * 2)) & low_bits(ln.keys - c0);
    Cut k;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      k.diag[i] = dg[i] - c0;
      k.row[i] = p.causal ? m & low_bits(k.diag[i] + 1) : m;
    }
    return k;
  }
  __device__ __forceinline__ float prob(const Cut& k, int e, float s,
                                        float lse2, float& dmul) const {
    const float bias =
        kAlibi ? slope2 * fabsf(static_cast<float>(col_of(e) -
                                                   k.diag[(e >> 1) & 1]))
               : 0.f;
    return sparse90::prob<kSoftcap, kAlibi>(p, s, lse2, bias, dmul);
  }
  __device__ __forceinline__ bool visible(const Cut& k, int e) const {
    return (k.row[(e >> 1) & 1] >> col_of(e)) & 1ull;
  }
};

template <typename T, int D, bool kSoftcap, bool kAlibi>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Params p) {
  using C = DqCfg<D>;
  constexpr int kBlocksD = D / 64;  // 128-byte column blocks of a row
  extern __shared__ unsigned char smem_sparse90[];
  unsigned char* sQ =
      smem_sparse90 + ((1024 - (smem_u32(smem_sparse90) & 1023)) & 1023);
  unsigned char* sdO = sQ + C::kQBytes;
  unsigned char* sK = sdO + C::kQBytes;
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
  const Lens ln = lens_of(p, b);
  const long long lrow = (static_cast<long long>(b) * p.h + head) * p.nqb +
                         2 * pair;
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
  const long long lse_row = (static_cast<long long>(b) * p.h + head) * p.sq;

  int row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) row[i] = wrow0 + warp * 16 + gid + 8 * i;
  float dq[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
  float delta[2] = {0.f, 0.f};

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

    // The ring, filled by thread 0: pass 1's merged tiles, a sentinel,
    // pass 2's, a sentinel; item y into stage y % kStages once every warp
    // has released item y - kStages.
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
        if (++mg->pass == 1) mg->restart();
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
      mbar_expect_tx(q_full, 2 * C::kQBytes);
#pragma unroll
      for (int cb = 0; cb < kBlocksD; ++cb) {
        tma_load_4d(sQ + cb * kBlockRows * 128, &tq, q_full, cb * 64, row0,
                    head, b);
        tma_load_4d(sdO + cb * kBlockRows * 128, &tdo, q_full, cb * 64, row0,
                    head, b);
      }
      for (int y = 0; y < kStages && mg->pass < 2; ++y) produce();
    }

    int dg[2];  // each row's causal diagonal
    float lse2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dg[i] = row[i] + ln.off;
      const bool ok = row[i] < ln.rows;
      lse2[i] = lse_base2(ok ? p.lse[lse_row + row[i]] : 0.f, ok);
    }
    float slope2 = 0.f;  // ALiBi slope in base 2
    if constexpr (kAlibi) slope2 = p.alibi[b * p.alibi_b + head] * kLog2e;

    const DqItems<kSoftcap, kAlibi> items{
        p, ln, cw, tig, wrow0, dg, slope2};
    dq_list_walk<T, D, kTile, kStages, C::kTileBytes>(
        items, ring,
        [&](int x) {
          if (mg->pass < 2 && mg->produced <= x - 1 + kStages) produce();
        },
        DqShared{sQ, sdO, sK, sV, q_full, full, empty}, tid, lane, cw, lse2,
        dq, delta);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (tig == 0 && row[i] < ln.rows) p.delta[lse_row + row[i]] = delta[i];
  }
  store_rows<T, D>(static_cast<T*>(p.dq) + b * p.dq_b + head * p.dq_h,
                   p.dq_s, row, ln.rows, tig, dq);
}

template <typename T, int D, bool kSoftcap, bool kAlibi>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tlse,
                           const __grid_constant__ CUtensorMap tdelta,
                           const Params p) {
  using C = DkvCfg<D>;
  constexpr int kBlocksD = D / 64;
  extern __shared__ unsigned char smem_sparse90[];
  unsigned char* sK =
      smem_sparse90 + ((1024 - (smem_u32(smem_sparse90) & 1023)) & 1023);
  unsigned char* sV = sK + C::kKVBytes;
  unsigned char* sQ = sV + C::kKVBytes;  // [kStages] tiles
  unsigned char* sdO = sQ + kStages * C::kQBytes;
  float* sL = reinterpret_cast<float*>(sdO + kStages * C::kQBytes);
  float* sD = sL + kStages * C::kStatStride;
  float* sL2 = sD + kStages * C::kStatStride;  // [kWarpgroups][kStages][kTile]
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(sL2 + kWarpgroups * kStages * kTile);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  Step* ring = reinterpret_cast<Step*>(empty + kStages);
  Merge* mg = reinterpret_cast<Merge*>(ring + kStages);
  volatile int* sofs = reinterpret_cast<int*>(mg + 1);  // [kStages]

  const int g = blockIdx.x;
  const int b = blockIdx.z;
  const int pair = blockIdx.y;  // 64-key tiles 2 pair, 2 pair + 1
  const int key0 = pair * kBlockRows;
  const Lens ln = lens_of(p, b);
  const long long lrow =
      (static_cast<long long>(b) * (p.h / p.group) + g) * p.nkb + 2 * pair;
  const int n0 = p.inv_counts[lrow];
  const int n1 = 2 * pair + 1 < p.nkb ? p.inv_counts[lrow + 1] : 0;
  const int tid = threadIdx.x;
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

  if (n0 + n1 > 0) {
    if (tid == 0) {
      mbar_init(kv_full, 1);
#pragma unroll
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, 4 * kWarpgroups);
      }
      fence_barrier_init();
    }
    __syncthreads();

    // The ring, filled by thread 0: the merged entries, then a sentinel;
    // per entry a Q, dO, LSE and delta tile of 64 rows.
    auto produce = [&] {
      const int y = mg->produced;
      const int s = y % kStages;
      mbar_wait(empty + s, ((y / kStages) & 1) ^ 1);
      unsigned long long w[2];
      const int e = mg->next(w);
      Step& st = ring[s];
      if (e == INT_MAX) {
        st.at = -1;
        mbar_arrive(full + s);
        mg->pass = 2;
      } else {
        st.at = e;
        st.word[0] = w[0];
        st.word[1] = w[1];
        const int head = g * p.group + e / p.nqb;
        const int rb = (e % p.nqb) * kTile;
        const int li = (b * p.h + head) * p.sq + rb;
        sofs[s] = li & 3;
        mbar_expect_tx(full + s, 2 * C::kQBytes + 2 * 4 * C::kStatBox);
#pragma unroll
        for (int cb = 0; cb < kBlocksD; ++cb) {
          tma_load_4d(sQ + s * C::kQBytes + cb * kTile * 128, &tq, full + s,
                      cb * 64, rb, head, b);
          tma_load_4d(sdO + s * C::kQBytes + cb * kTile * 128, &tdo, full + s,
                      cb * 64, rb, head, b);
        }
        tma_load_1d(sL + s * C::kStatStride, &tlse, full + s, li & ~3);
        tma_load_1d(sD + s * C::kStatStride, &tdelta, full + s, li & ~3);
      }
      mg->produced = y + 1;
    };
    if (tid == 0) {
      mg->at[0] = p.inv_idx + lrow * p.inv_len;
      mg->at[1] = mg->at[0] + p.inv_len;
      mg->wd[0] = p.inv_words + lrow * p.inv_len;
      mg->wd[1] = mg->wd[0] + p.inv_len;
      mg->n[0] = n0;
      mg->n[1] = n1;
      mg->produced = mg->pass = 0;
      mg->restart();
      mbar_expect_tx(kv_full, 2 * C::kKVBytes);
#pragma unroll
      for (int cb = 0; cb < kBlocksD; ++cb) {
        tma_load_4d(sK + cb * kBlockRows * 128, &tk, kv_full, cb * 64, key0, g,
                    b);
        tma_load_4d(sV + cb * kBlockRows * 128, &tv, kv_full, cb * 64, key0, g,
                    b);
      }
      for (int y = 0; y < kStages && mg->pass < 2; ++y) produce();
    }

    // Descriptors: this warpgroup's K and V rows (A); Q and dO K-major (B
    // of S^T and dP^T) and N-major (B of dK and dV).
    const uint64_t k_desc = make_desc(sK + cw * 64 * 128, 16, 1024);
    const uint64_t v_desc = make_desc(sV + cw * 64 * 128, 16, 1024);
    const uint64_t q_desc = make_desc(sQ, 16, 1024);
    const uint64_t do_desc = make_desc(sdO, 16, 1024);
    const uint64_t qn_desc = make_desc(sQ, kTile * 128, 1024);
    const uint64_t don_desc = make_desc(sdO, kTile * 128, 1024);
    float st[kTile / 2];   // S^T, then P^T
    float dpt[kTile / 2];  // dP^T, then dS^T
    uint32_t pa[kTile / 16][4];
    uint32_t da[kTile / 16][4];

    // P^T and dS^T of stage s's tile (query rows rb.., their delta from
    // row o of the stage's tile) in place. Element e's query row is rb + 2
    // tig + col(e); `kr`: each of this thread's two keys less the diagonal
    // of row rb + 2 tig (for ALiBi); `rows`: for each key, bit j set when
    // row rb + 2 tig + j sees it (the key is on the word and used and, with
    // causal masking, kr <= j).
    auto col = [](int e) { return (e >> 2) * 8 + (e & 1); };
    auto p_ds_step = [&](auto masked, int s, int o, const int (&kr)[2],
                         const unsigned long long (&rows)[2], float slope2) {
      const float* lse2 = sL2 + (cw * kStages + s) * kTile + tig * 2;
      const float* dlt = sD + s * C::kStatStride + o + tig * 2;
#pragma unroll
      for (int e = 0; e < kTile / 2; ++e) {
        const int i = (e >> 1) & 1;
        const float bias =
            kAlibi ? slope2 * fabsf(static_cast<float>(kr[i] - col(e))) : 0.f;
        float dmul;
        float pr = prob<kSoftcap, kAlibi>(p, st[e], lse2[col(e)], bias, dmul);
        if constexpr (decltype(masked)::value) {
          if (!((rows[i] >> col(e)) & 1ull)) pr = 0.f;
        }
        st[e] = pr;
        dpt[e] = pr * (dpt[e] - dlt[col(e)]) * dmul;
      }
    };

    // The warpgroups do not take turns to issue their products, as kernel
    // 2's do: here the turns made the kernel 1.22x slower at prefill-8k.
    mbar_wait(kv_full, 0);
    for (int x = 0;; ++x) {
      const int s = x % kStages;
      mbar_wait(full + s, (x / kStages) & 1);
      const int e = ring[s].at;
      const unsigned long long w = ring[s].word[cw];
      if (e < 0) break;  // the last item: nothing follows it
      const int head = g * p.group + e / p.nqb;
      const int rb = (e % p.nqb) * kTile;
      float slope2 = 0.f;
      if constexpr (kAlibi) {
        if (w) slope2 = __ldg(p.alibi + b * p.alibi_b + head) * kLog2e;
      }
      if (w) {
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ka =
              ((kk >> 2) * kBlockRows * 128 + (kk & 3) * 32) >> 4;
          const uint32_t qb =
              (s * C::kQBytes + (kk >> 2) * kTile * 128 + (kk & 3) * 32) >> 4;
          wgmma_ss<T, kTile>(st, k_desc + ka, q_desc + qb, kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ka =
              ((kk >> 2) * kBlockRows * 128 + (kk & 3) * 32) >> 4;
          const uint32_t qb =
              (s * C::kQBytes + (kk >> 2) * kTile * 128 + (kk & 3) * 32) >> 4;
          wgmma_ss<T, kTile>(dpt, v_desc + ka, do_desc + qb, kk > 0);
        }
        wgmma_commit();
        // While the products run: this warpgroup's copy of the tile's LSE
        // in base 2 (+inf past the used rows or for rows that see nothing).
        const int o = sofs[s];
        for (int c = t; c < kTile; c += 128) {
          sL2[(cw * kStages + s) * kTile + c] =
              lse_base2(sL[s * C::kStatStride + o + c], rb + c < ln.rows);
        }
        named_barrier(3 + cw, 128);
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        int kr[2];
        unsigned long long rows[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          kr[i] = key[i] - ln.off - rb - tig * 2;
          const bool keep =
              ((w >> (key[i] - wkey0)) & 1ull) && key[i] < ln.keys;
          rows[i] = !keep ? 0ull : p.causal ? ~low_bits(kr[i]) : ~0ull;
        }
        const bool full_tile =
            w == ~0ull && wkey0 + 64 <= ln.keys &&
            (!p.causal || wkey0 + 63 <= rb + ln.off);
        if (full_tile) {
          p_ds_step(Bool<false>(), s, o, kr, rows, slope2);
        } else {
          p_ds_step(Bool<true>(), s, o, kr, rows, slope2);
        }
        pack_a<T, kTile>(st, pa);
        pack_a<T, kTile>(dpt, da);
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);

        // dV += P^T dO and dK += dS^T Q (dS already carries the scale).
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint32_t step = (s * C::kQBytes + kk * 16 * 128) >> 4;
          wgmma_rs<T, D>(dv, pa[kk], don_desc + step, 1);
        }
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint32_t step = (s * C::kQBytes + kk * 16 * 128) >> 4;
          wgmma_rs<T, D>(dk, da[kk], qn_desc + step, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
      if (tid == 0 && x >= 1 && mg->pass < 2 &&
          mg->produced <= x - 1 + kStages) {
        produce();
      }
    }
  }

  store_rows<T, D>(static_cast<T*>(p.dk) + b * p.dk_b + g * p.dk_h, p.dk_s,
                   key, ln.keys, tig, dk);
  store_rows<T, D>(static_cast<T*>(p.dv) + b * p.dv_b + g * p.dv_h, p.dv_s,
                   key, ln.keys, tig, dv);
}

template <typename T, int D, bool kSoftcap, bool kAlibi>
int launch_dq(const CUtensorMap& tq, const CUtensorMap& tdo,
              const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
              int batch, cudaStream_t stream) {
  const size_t smem = DqCfg<D>::kSmem;
  auto kernel = sparse_dq_sm90_kernel<T, D, kSoftcap, kAlibi>;
  if (const int err = set_smem(kernel, smem)) return err;
  const dim3 grid(p.h, (p.nqb + 1) / 2, batch);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tdo, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kSoftcap, bool kAlibi>
int launch_dkv(const CUtensorMap& tq, const CUtensorMap& tdo,
               const CUtensorMap& tk, const CUtensorMap& tv,
               const CUtensorMap& tlse, const CUtensorMap& tdelta,
               const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = DkvCfg<D>::kSmem;
  auto kernel = sparse_dkv_sm90_kernel<T, D, kSoftcap, kAlibi>;
  if (const int err = set_smem(kernel, smem)) return err;
  const dim3 grid(p.h / p.group, (p.nkb + 1) / 2, batch);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tdo, tk, tv, tlse, tdelta, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sparse90
}  // namespace fa
