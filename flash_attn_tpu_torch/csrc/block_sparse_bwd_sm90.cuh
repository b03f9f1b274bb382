// Block-sparse attention backward for Hopper (kernels 10 and 11): dk, dv
// (kernel 10) and dq with delta = sum_j P dP (kernel 11) over a plan's kept
// elements, for q, dO (b, h, sq, d) and k, v (b, hk, sk, d) read through
// their strides, from the forward's log-sum-exp and the execution lists.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/block_sparsity.py:807
// (_bs_dkv_kernel, launched at :1094) and :906 (_bs_dq_kernel, launched at
// :1169), both called by flash_attention_blocksparse_bwd (:996), restricted
// to the forward's features (csrc/block_sparse_fwd_sm90.cuh): mask_mod
// plans, broadcast plans (their lists are built per (b, head)), scale,
// softcap, GQA/MQA, head dim 64 or 128, bf16/fp16. The TPU schedule
// (transposed host worklists with chain flags, per-query-head dK/dV
// temporaries and their reshape-sums, delta from rowsum(dO * O)) is not
// carried over.
//
// Function: with the kept elements of the forward and s = q . k, P = exp(s
// * scale - lse) or exp(t * softcap - lse) with t = tanh(s * scale /
// softcap), 0 where not kept or where lse = -inf; dP = dO . v; delta = sum_j
// P dP per query row in fp32; dS = P (dP - delta) scale [(1 - t^2) with
// softcap]; dq = sum dS K, dv = sum P^T dO, dk = sum dS^T Q (dk and dv
// summed over each kv head's group of query heads). Every row below sq of
// dq and delta, and every key row below sk of dk and dv, is written (zeros
// where nothing is kept): the wrappers allocate them uninitialised. Kernel
// 10 reads kernel 11's delta unchanged.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): per kept
// (query head, row, column) triple, dK/dV 8 d flops (S, dP, dV, dK), dQ 6
// d (S, dP, dQ), against q, dO, k, v, the LSE (and delta) and the outputs
// moved once; kernel 11 does 10 d (S and dP twice); both over whole 64 x 64
// sub-tiles. At the plans' densities they are bound by operations.
//
// Design: a block is two 64-row (kernel 11) or 64-key (kernel 10) wgmma
// warpgroups, 256 threads; warpgroup i owns the 64-row or 64-key block 2m +
// i of its block's pair and that block's list. Thread 0 merges the two lists
// (ascending (index << 2) | mode) with two pointers (kernel 9's Merge, in
// shared memory, its next entries copied by cp.async a step ahead), and for
// each merged step writes the step and each warpgroup's mode, or "absent",
// into a ring slot beside the stage, then issues the stage's copies: TMA
// tiles and, for a warpgroup in mode 2, its sub-tile's 64 row words (512
// bytes by the bulk copy engine). A warpgroup absent from a step only
// releases the stage.
//  * dQ (kernel 11): kernel 14's dQ (dq_list_walk of csrc/flash_bwd_sm90
//    .cuh, both kernels' code) on kernel 9's lists, one block per (two
//    64-row blocks, query head, batch row), the heads fastest and the last
//    row blocks first. Q and dO are loaded once; a step brings a K and a V
//    tile of 64 keys. The merged list is walked twice, a sentinel (tile -1)
//    after each pass, the merge restarted between them, so pass 2 gets its
//    words again with its stages. Pass 1: S = Q K^T and dP = dO V^T (wgmma
//    from shared memory), delta += P dP. Pass 2: S and dP again, dS, then
//    dQ += dS K with dS as the register A operand and K read N-major.
//  * dK/dV (kernel 10): kernel 13's dK/dV steps (dkv_list_walk, below) on
//    the inverse lists, one block per (two 64-key blocks, kv head,
//    batch row), the heads fastest and the first key blocks first. K and V
//    of the 128 keys are loaded once; for each query head of the group in
//    turn, thread 0 merges the two key blocks' inverse lists of that head
//    (restarted per head, a sentinel after the last), and a step brings
//    the Q, dO, LSE and delta tiles of one 64-row block (1-D maps over the
//    contiguous (b, h, sq) rows). S^T = K Q^T and dP^T = V dO^T, then dV +=
//    P^T dO and dK += dS^T Q with P^T and dS^T as register A operands; dK
//    and dV sum the group in fp32. The words are per query row (bit c for
//    key 64 tile + c), so a thread tests, for each of its two keys (its
//    accumulator rows), the bit of that key in the word of each query row
//    of its accumulator columns.
// Masks by mode: mode 0 applies none; mode 1 the bounds (kernel 11: rows <
// sq and low_bits(sk - col0); kernel 10: keys < sk); mode 2 one bit per
// element. TMA fills rows past sq and keys past sk with zeros, which would
// score 0, not -inf: a sub-tile that reaches past sq or sk is never mode 0
// (kernels/block_sparsity.py build_execution_lists), rows past sq take lse
// +inf (P = 0), keys past sk are masked and never stored. A block whose
// lists are all empty issues no copy, waits on no barrier and writes zeros;
// with an odd number of row or key blocks the last block's second list is
// empty (its count is never read). Deterministic: no atomics; every output
// element is summed by one thread in a fixed order and written once.

#pragma once

#include <climits>

#include "block_sparse_fwd_sm90.cuh"
#include "flash_bwd_sm90.cuh"

namespace fa {
namespace bsbwd90 {

using namespace fa::sm90;
using fa::bs90::kTile;
using fa::bs90::kWordBytes;
using fa::bs90::Merge;
using fa::bs90::Step;
using fa::bwd90::Bool;
using fa::bwd90::DkvShared;
using fa::bwd90::dq_list_walk;
using fa::bwd90::DqShared;
using fa::bwd90::kBlockRows;
using fa::bwd90::kThreads;
using fa::bwd90::kWarpgroups;
using fa::bwd90::lse_base2;
using fa::bwd90::pack_a;
using fa::bwd90::set_smem;
using fa::bwd90::store_rows;

template <int D>
struct Cfg {
  static constexpr int kStages = 4;
  static constexpr int kQBytes = kBlockRows * D * 2;  // the Q or dO tile
  static constexpr int kTileBytes = kTile * D * 2;    // one K or V tile
  // 1024 bytes of slack to align the tiles for the swizzle.
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kTileBytes +
      kStages * kWarpgroups * kWordBytes + 8 * (1 + 2 * kStages) +
      sizeof(Merge) + kStages * sizeof(Step);
};

struct Params {
  const float* lse;  // (b, h, sq) contiguous, natural log
  float* delta;      // (b, h, sq) contiguous
  void* dq;          // (b, h, sq, d) through dq_b, dq_h, dq_s
  long long dq_b, dq_h, dq_s;
  int h, group, sq, sk, nqb;
  float scale;
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2 with
  // a softcap.
  float score_mul, cap_log2;
  // The forward's lists, list_len entries per (b, head, 64-row block) at
  // row (b * h + head) * nqb + block, counts[row] of them used.
  const int* counts;
  const int* tiles;
  const int* wofs;
  const unsigned long long* words;
  long long list_len;
};

// The kernel's hooks for dq_list_walk (csrc/flash_bwd_sm90.cuh): a ring
// item is a key tile and each warpgroup's mode (-1: absent). For a mode
// above 0, read() also takes this thread's two row words shifted to its
// columns (bit (e >> 2) * 8 + (e & 1) for element e) before the stage is
// released: mode 2's from the stage, mode 1's the bounds (rows < sq,
// low_bits(sk - col0)). Mode 0 applies no mask.
template <bool kSoftcap>
struct DqItems {
  struct Item {
    int mode;
    unsigned long long w[2] = {0ull, 0ull};
  };
  const Params& p;
  const unsigned long long* sW;  // [kStages][kWarpgroups][kTile]
  int cw, tig;
  const int (&r_local)[2];
  const int (&row)[2];

  __device__ __forceinline__ int read(const Step& st, int s, Item& it) const {
    const int tile = st.tile;
    it.mode = st.mode[cw];
    if (tile >= 0 && it.mode > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        it.w[i] = (it.mode == 2
                       ? sW[(s * kWarpgroups + cw) * kTile + r_local[i]]
                   : row[i] < p.sq ? bs::low_bits(p.sk - tile * kTile)
                                   : 0ull) >>
                  (2 * tig);
      }
    }
    return tile;
  }
  __device__ __forceinline__ bool on(const Item& it) const {
    return it.mode >= 0;
  }
  __device__ __forceinline__ bool unmasked(int, const Item& it) const {
    return it.mode == 0;
  }
  __device__ __forceinline__ Item mask(int, const Item& it) const {
    return it;
  }
  __device__ __forceinline__ float prob(const Item&, int, float s, float lse2,
                                        float& dmul) const {
    return bwd90::prob<kSoftcap>(p, s, lse2, dmul);
  }
  __device__ __forceinline__ bool visible(const Item& m, int e) const {
    return (m.w[(e >> 1) & 1] >> ((e >> 2) * 8 + (e & 1))) & 1ull;
  }
};

template <typename T, int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    bs_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const Params p) {
  using C = Cfg<D>;
  constexpr int kStages = C::kStages;
  constexpr int kBlocksD = D / 64;  // 128-byte column blocks of a row
  extern __shared__ unsigned char smem_bsbwd90[];
  unsigned char* sQ =
      smem_bsbwd90 + ((1024 - (smem_u32(smem_bsbwd90) & 1023)) & 1023);
  unsigned char* sdO = sQ + C::kQBytes;
  unsigned char* sK = sdO + C::kQBytes;
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
  const long long lse_row = (static_cast<long long>(b) * p.h + head) * p.sq;

  int r_local[2], row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r_local[i] = warp * 16 + gid + 8 * i;
    row[i] = wrow0 + r_local[i];
  }
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

    // The ring, filled by thread 0: pass 1's merged steps, a sentinel, pass
    // 2's, a sentinel (mg->done counts the sentinels); item y into stage y
    // % kStages once every warp has released item y - kStages.
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
        if (++mg->done == 1) {  // pass 2 walks the lists again
          mg->i[0] = mg->i[1] = 0;
          mg->read(0);
          mg->read(1);
        }
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
      mbar_expect_tx(q_full, 2 * C::kQBytes);
#pragma unroll
      for (int cb = 0; cb < kBlocksD; ++cb) {
        tma_load_4d(sQ + cb * kBlockRows * 128, &tq, q_full, cb * 64, row0,
                    head, b);
        tma_load_4d(sdO + cb * kBlockRows * 128, &tdo, q_full, cb * 64, row0,
                    head, b);
      }
      for (int y = 0; y < kStages && mg->done < 2; ++y) produce();
    }

    float lse2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = row[i] < p.sq;
      lse2[i] = lse_base2(ok ? p.lse[lse_row + row[i]] : 0.f, ok);
    }

    const DqItems<kSoftcap> items{
        p, sW, cw, tig, r_local, row};
    dq_list_walk<T, D, kTile, kStages, C::kTileBytes>(
        items, ring,
        [&](int x) {
          if (mg->done < 2 && mg->produced <= x - 1 + kStages) produce();
        },
        DqShared{sQ, sdO, sK, sV, q_full, full, empty}, tid, lane, cw, lse2,
        dq, delta);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (tig == 0 && row[i] < p.sq) p.delta[lse_row + row[i]] = delta[i];
  }
  store_rows<T, D>(static_cast<T*>(p.dq) + b * p.dq_b + head * p.dq_h,
                   p.dq_s, row, p.sq, tig, dq);
}

template <typename T, int D, bool kSoftcap>
int launch(const CUtensorMap* maps, const Params& p, int batch,
           cudaStream_t stream) {
  const size_t smem = Cfg<D>::kSmem;
  if (const int err = set_smem(bs_dq_sm90_kernel<T, D, kSoftcap>, smem)) {
    return err;
  }
  const dim3 grid(p.h, (p.nqb + 1) / 2, batch);
  bs_dq_sm90_kernel<T, D, kSoftcap><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_softcap(const CUtensorMap* maps, const Params& p, bool softcap,
                   int batch, cudaStream_t s) {
  return softcap ? launch<T, D, true>(maps, p, batch, s)
                 : launch<T, D, false>(maps, p, batch, s);
}

// Kernel 10's consumer, kernel 13's dK/dV steps (csrc/flash_sparse_bwd_sm90
// .cuh) with hooks, as kernel 11's dq_list_walk has: one warpgroup's walk
// (thread tid, t = tid % 128, lane, tig, warpgroup cw) over a ring of merged
// list steps, kBQ = 64 query rows a step: thread 0 fills item y into stage y % kStages, the walk ended by a
// sentinel (an entry below 0), and refill(x), called by thread 0 once item
// x is released, fills the stage of item x - 1, which the other warpgroup
// has most likely released by then. The hooks `h` read slot ring[s] of
// stage s, read(ring[s], it) (the item's entry, and this warpgroup's part
// `it`, of type H::Item), and give row0(entry, it) (the step's first
// query row; it may complete `it`), on(it) (whether this warpgroup takes the step; if not, it only
// releases the stage), rows() (the rows below which the LSE is read),
// stat_ofs(s) (where stage s's LSE and delta rows start in their tiles of
// kStatStride floats), mask(s, rb, it) and unmasked(rb, it) for the step,
// and prob(m, e, s, lse2, dmul) and visible(m, e) under mask m, for element
// e, whose query row is rb + 2 tig + col(e). The two warpgroups do not take turns, as
// kernel 2's do: the turns made kernel 13 1.22x slower at prefill-8k.
template <typename T, int D, int kBQ, int kStages, int kQBytes,
          int kStatStride, class H, class S, class F>
__device__ __forceinline__ void dkv_list_walk(
    const H& h, const S* ring, const F& refill, const DkvShared& sh, int tid,
    int t, int lane, int tig, int cw, float (&dk)[D / 2],
    float (&dv)[D / 2]) {
  using Item = typename H::Item;
  // Descriptors: this warpgroup's K and V rows (A); Q and dO K-major (B
  // of S^T and dP^T) and N-major (B of dK and dV).
  const uint64_t k_desc = make_desc(sh.sK + cw * 64 * 128, 16, 1024);
  const uint64_t v_desc = make_desc(sh.sV + cw * 64 * 128, 16, 1024);
  const uint64_t q_desc = make_desc(sh.sQ, 16, 1024);
  const uint64_t do_desc = make_desc(sh.sdO, 16, 1024);
  const uint64_t qn_desc = make_desc(sh.sQ, kBQ * 128, 1024);
  const uint64_t don_desc = make_desc(sh.sdO, kBQ * 128, 1024);
  float st[kBQ / 2];   // S^T, then P^T
  float dpt[kBQ / 2];  // dP^T, then dS^T
  uint32_t pa[kBQ / 16][4];
  uint32_t da[kBQ / 16][4];

  // P^T and dS^T of stage s's tile (its delta from row o) in place under
  // mask m.
  auto col = [](int e) { return (e >> 2) * 8 + (e & 1); };
  auto p_ds_step = [&](auto masked, int s, int o, const auto& m) {
    const float* lse2 = sh.sL2 + (cw * kStages + s) * kBQ + tig * 2;
    const float* dlt = sh.sD + s * kStatStride + o + tig * 2;
#pragma unroll
    for (int e = 0; e < kBQ / 2; ++e) {
      float dmul;
      float pr = h.prob(m, e, st[e], lse2[col(e)], dmul);
      if constexpr (decltype(masked)::value) {
        if (!h.visible(m, e)) pr = 0.f;
      }
      st[e] = pr;
      dpt[e] = pr * (dpt[e] - dlt[col(e)]) * dmul;
    }
  };

  mbar_wait(sh.kv_full, 0);
  for (int x = 0;; ++x) {
    const int s = x % kStages;
    mbar_wait(sh.full + s, (x / kStages) & 1);
    Item it;
    const int e = h.read(ring[s], it);
    if (e < 0) break;  // the last item: nothing follows it
    const int rb = h.row0(e, it);
    if (h.on(it)) {
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ka =
            ((kk >> 2) * kBlockRows * 128 + (kk & 3) * 32) >> 4;
        const uint32_t qb =
            (s * kQBytes + (kk >> 2) * kBQ * 128 + (kk & 3) * 32) >> 4;
        wgmma_ss<T, kBQ>(st, k_desc + ka, q_desc + qb, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ka =
            ((kk >> 2) * kBlockRows * 128 + (kk & 3) * 32) >> 4;
        const uint32_t qb =
            (s * kQBytes + (kk >> 2) * kBQ * 128 + (kk & 3) * 32) >> 4;
        wgmma_ss<T, kBQ>(dpt, v_desc + ka, do_desc + qb, kk > 0);
      }
      wgmma_commit();
      // While the products run: this warpgroup's copy of the tile's LSE
      // in base 2.
      const int o = h.stat_ofs(s);
      for (int c = t; c < kBQ; c += 128) {
        sh.sL2[(cw * kStages + s) * kBQ + c] =
            lse_base2(sh.sL[s * kStatStride + o + c], rb + c < h.rows());
      }
      named_barrier(3 + cw, 128);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      const auto m = h.mask(s, rb, it);
      if (h.unmasked(rb, it)) {
        p_ds_step(Bool<false>(), s, o, m);
      } else {
        p_ds_step(Bool<true>(), s, o, m);
      }
      pack_a<T, kBQ>(st, pa);
      pack_a<T, kBQ>(dpt, da);
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);

      // dV += P^T dO and dK += dS^T Q (dS already carries the scale).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint32_t step = (s * kQBytes + kk * 16 * 128) >> 4;
        wgmma_rs<T, D>(dv, pa[kk], don_desc + step, 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint32_t step = (s * kQBytes + kk * 16 * 128) >> 4;
        wgmma_rs<T, D>(dk, da[kk], qn_desc + step, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sh.empty + s);
    if (tid == 0) refill(x);
  }
}

// Kernel 10's shared memory: K and V of its 128 keys, then per stage a Q
// and a dO tile of 64 rows, their LSE and delta, each warpgroup's base-2
// copy of the LSE and its mode-2 words; the barriers, the merge, the ring,
// the merge's query head in the group and each stage's row offset. A 1-D
// TMA copy faults on a box whose first value is not 16-byte aligned, and a
// head's rows start anywhere in the (b, h, sq) rows when sq is not a
// multiple of 4: each LSE or delta tile is kStatBox values from up to 3
// rows before its first row, in a slot of kStatStride (128-byte aligned).
template <int D>
struct DkvCfg {
  static constexpr int kStages = 4;
  static constexpr int kKVBytes = kBlockRows * D * 2;  // the K or V tile
  static constexpr int kQBytes = kTile * D * 2;        // one Q or dO tile
  static constexpr int kStatBox = kTile + 4;
  static constexpr int kStatStride = kTile + 32;
  static constexpr size_t kSmem =
      1024 + 2 * kKVBytes +
      kStages * (2 * kQBytes + 2 * 4 * kStatStride + kWarpgroups * 4 * kTile) +
      kStages * kWarpgroups * kWordBytes + 8 * (1 + 2 * kStages) +
      sizeof(Merge) + kStages * sizeof(Step) + (1 + kStages) * sizeof(int);
};

struct DkvParams {
  void* dk;  // (b, hk, sk, d) through dk_*
  void* dv;  // (b, hk, sk, d) through dv_*
  long long dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  int h, group, sq, sk, nqb, nkb;
  float scale;
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2 with
  // a softcap.
  float score_mul, cap_log2;
  // The inverse lists, list_len entries per (b, query head, 64-key block)
  // at row (b * h + head) * nkb + block, counts[row] of them used: entries
  // (64-row block << 2) | mode, wofs the mode-2 word groups.
  const int* counts;
  const int* rows;
  const int* wofs;
  const unsigned long long* words;
  long long list_len;
};

// The kernel's hooks for dkv_list_walk (csrc/flash_bwd_sm90.cuh): a ring
// item is a step (head in group * nqb + 64-row block; -1 for the sentinel)
// and each warpgroup's mode (-1: absent). A step's mask holds, for each of
// this thread's two keys, bit j set when row rb + 2 tig + j keeps it: mode
// 1 the bounds (the key below sk; rows past sq are cut by their LSE), mode
// 2 the key's bit (key - wkey0) in the words of those rows, read from the
// stage. Mode 0 applies no mask.
template <bool kSoftcap>
struct DkvItems {
  struct Item {
    int mode;
  };
  struct Mask {
    unsigned long long rows[2];
  };
  const DkvParams& p;
  const unsigned long long* sW;  // [kStages][kWarpgroups][kTile]
  volatile int* sofs;            // [kStages]
  const int &cw, &tig, &wkey0;
  const int (&key)[2];

  __device__ __forceinline__ int read(const Step& st, Item& it) const {
    it.mode = st.mode[cw];
    return st.tile;
  }
  __device__ __forceinline__ int row0(int e, Item&) const {
    return (e % p.nqb) * kTile;
  }
  __device__ __forceinline__ bool on(const Item& it) const {
    return it.mode >= 0;
  }
  __device__ __forceinline__ int rows() const { return p.sq; }
  __device__ __forceinline__ int stat_ofs(int s) const { return sofs[s]; }
  __device__ __forceinline__ Mask mask(int s, int, const Item& it) const {
    Mask m;
    if (it.mode == 2) {
      // Element e's row is 2 tig + (e >> 2) * 8 + (e & 1) of the tile:
      // bit (e >> 2) * 8 + (e & 1) of the thread's masks.
      const unsigned long long* w = sW + (s * kWarpgroups + cw) * kTile + 2 * tig;
      m.rows[0] = m.rows[1] = 0ull;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const unsigned long long word = w[8 * j + c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            m.rows[i] |= ((word >> (key[i] - wkey0)) & 1ull) << (8 * j + c);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) m.rows[i] = key[i] < p.sk ? ~0ull : 0ull;
    }
    return m;
  }
  __device__ __forceinline__ bool unmasked(int, const Item& it) const {
    return it.mode == 0;
  }
  __device__ __forceinline__ float prob(const Mask&, int, float s, float lse2,
                                        float& dmul) const {
    return bwd90::prob<kSoftcap>(p, s, lse2, dmul);
  }
  __device__ __forceinline__ bool visible(const Mask& m, int e) const {
    return (m.rows[(e >> 1) & 1] >> ((e >> 2) * 8 + (e & 1))) & 1ull;
  }
};

template <typename T, int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    bs_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tlse,
                       const __grid_constant__ CUtensorMap tdelta,
                       const DkvParams p) {
  using C = DkvCfg<D>;
  constexpr int kStages = C::kStages;
  constexpr int kBlocksD = D / 64;  // 128-byte column blocks of a row
  extern __shared__ unsigned char smem_bsdkv90[];
  unsigned char* sK =
      smem_bsdkv90 + ((1024 - (smem_u32(smem_bsdkv90) & 1023)) & 1023);
  unsigned char* sV = sK + C::kKVBytes;
  unsigned char* sQ = sV + C::kKVBytes;  // [kStages] tiles
  unsigned char* sdO = sQ + kStages * C::kQBytes;
  float* sL = reinterpret_cast<float*>(sdO + kStages * C::kQBytes);
  float* sD = sL + kStages * C::kStatStride;
  float* sL2 = sD + kStages * C::kStatStride;  // [kWarpgroups][kStages][kTile]
  // [kStages][kWarpgroups][kTile]: the mode-2 words of each step.
  unsigned long long* sW =
      reinterpret_cast<unsigned long long*>(sL2 + kWarpgroups * kStages * kTile);
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(sW + kStages * kWarpgroups * kTile);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  Merge* mg = reinterpret_cast<Merge*>(empty + kStages);
  Step* ring = reinterpret_cast<Step*>(mg + 1);
  int* mj = reinterpret_cast<int*>(ring + kStages);  // the merge's head
  volatile int* sofs = mj + 1;                        // [kStages]

  const int g = blockIdx.x;
  const int b = blockIdx.z;
  const int pair = blockIdx.y;  // 64-key blocks 2 pair, 2 pair + 1
  const int key0 = pair * kBlockRows;
  const bool second = 2 * pair + 1 < p.nkb;
  // List row of query head j of the group for key block 2 pair.
  auto list_row = [&](int j) {
    return (static_cast<long long>(b) * p.h + g * p.group + j) * p.nkb +
           2 * pair;
  };
  int n_all = 0;
  for (int j = 0; j < p.group; ++j) {
    const long long row = list_row(j);
    n_all += __ldg(p.counts + row) + (second ? __ldg(p.counts + row + 1) : 0);
  }
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

  if (n_all > 0) {
    if (tid == 0) {
      mbar_init(kv_full, 1);
#pragma unroll
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, 4 * kWarpgroups);  // lane 0 of each warp
      }
      fence_barrier_init();
    }
    __syncthreads();

    // The ring, filled by thread 0: for each query head j of the group, the
    // merge of its two inverse lists, then a sentinel; item y into stage y
    // % kStages once every warp has released item y - kStages.
    auto start = [&](int j) {
      const long long row = list_row(j);
      mg->ent[0] = p.rows + row * p.list_len;
      mg->ent[1] = mg->ent[0] + p.list_len;
      mg->wofs[0] = p.wofs + row * p.list_len;
      mg->wofs[1] = mg->wofs[0] + p.list_len;
      mg->n[0] = __ldg(p.counts + row);
      mg->n[1] = second ? __ldg(p.counts + row + 1) : 0;
      mg->i[0] = mg->i[1] = 0;
      mg->read(0);
      mg->read(1);
      *mj = j;
    };
    auto produce = [&] {
      const int y = mg->produced;
      const int s = y % kStages;
      mbar_wait(empty + s, ((y / kStages) & 1) ^ 1);
      int mode[2], group[2];
      int qb = mg->next(mode, group);
      while (qb == INT_MAX && *mj + 1 < p.group) {
        start(*mj + 1);
        qb = mg->next(mode, group);
      }
      Step& st = ring[s];
      if (qb == INT_MAX) {
        st.tile = -1;
        mbar_arrive(full + s);
        mg->done = 1;
      } else {
        const int j = *mj;
        st.tile = j * p.nqb + qb;
        st.mode[0] = mode[0];
        st.mode[1] = mode[1];
        const int head = g * p.group + j;
        const int rb = qb * kTile;
        const int li = (b * p.h + head) * p.sq + rb;
        sofs[s] = li & 3;
        mbar_expect_tx(full + s, 2 * C::kQBytes + 2 * 4 * C::kStatBox +
                                     kWordBytes * ((mode[0] == 2) +
                                                   (mode[1] == 2)));
#pragma unroll
        for (int cb = 0; cb < kBlocksD; ++cb) {
          tma_load_4d(sQ + s * C::kQBytes + cb * kTile * 128, &tq, full + s,
                      cb * 64, rb, head, b);
          tma_load_4d(sdO + s * C::kQBytes + cb * kTile * 128, &tdo, full + s,
                      cb * 64, rb, head, b);
        }
        tma_load_1d(sL + s * C::kStatStride, &tlse, full + s, li & ~3);
        tma_load_1d(sD + s * C::kStatStride, &tdelta, full + s, li & ~3);
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
      mg->produced = mg->done = 0;
      start(0);
      mbar_expect_tx(kv_full, 2 * C::kKVBytes);
#pragma unroll
      for (int cb = 0; cb < kBlocksD; ++cb) {
        tma_load_4d(sK + cb * kBlockRows * 128, &tk, kv_full, cb * 64, key0, g,
                    b);
        tma_load_4d(sV + cb * kBlockRows * 128, &tv, kv_full, cb * 64, key0, g,
                    b);
      }
      for (int y = 0; y < kStages && !mg->done; ++y) produce();
    }

    const DkvItems<kSoftcap> items{p, sW, sofs, cw, tig, wkey0, key};
    dkv_list_walk<T, D, kTile, kStages, C::kQBytes, C::kStatStride>(
        items, ring,
        [&](int x) {
          if (!mg->done && mg->produced <= x - 1 + kStages) produce();
        },
        DkvShared{sK, sV, sQ, sdO, sL, sD, sL2, kv_full, full, empty}, tid, t,
        lane, tig, cw, dk, dv);
  }

  store_rows<T, D>(static_cast<T*>(p.dk) + b * p.dk_b + g * p.dk_h, p.dk_s,
                   key, p.sk, tig, dk);
  store_rows<T, D>(static_cast<T*>(p.dv) + b * p.dv_b + g * p.dv_h, p.dv_s,
                   key, p.sk, tig, dv);
}

template <typename T, int D, bool kSoftcap>
int launch_dkv(const CUtensorMap* maps, const DkvParams& p, int batch,
               cudaStream_t stream) {
  const size_t smem = DkvCfg<D>::kSmem;
  if (const int err = set_smem(bs_dkv_sm90_kernel<T, D, kSoftcap>, smem)) {
    return err;
  }
  const dim3 grid(p.h / p.group, (p.nkb + 1) / 2, batch);
  bs_dkv_sm90_kernel<T, D, kSoftcap><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv_softcap(const CUtensorMap* maps, const DkvParams& p,
                       bool softcap, int batch, cudaStream_t s) {
  return softcap ? launch_dkv<T, D, true>(maps, p, batch, s)
                 : launch_dkv<T, D, false>(maps, p, batch, s);
}

}  // namespace bsbwd90
}  // namespace fa
