// Block-sparse attention dQ for Hopper (kernel 11): dq and delta = sum_j P
// dP over a plan's kept elements, for q, dO (b, h, sq, d) and k, v (b, hk,
// sk, d) read through their strides, from the forward's log-sum-exp and
// execution lists.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/block_sparsity.py:906
// (_bs_dq_kernel, launched at :1169 by flash_attention_blocksparse_bwd
// :996), restricted to the forward's features (csrc/block_sparse_fwd_sm90
// .cuh): mask_mod plans, broadcast plans (their lists are built per (b,
// head)), scale, softcap, GQA/MQA, head dim 64 or 128, bf16/fp16.
//
// Function, as csrc/block_sparse_bwd.cu's: with the kept elements of the
// forward and s = q . k, P = exp(s * scale - lse) or exp(t * softcap -
// lse) with t = tanh(s * scale / softcap), 0 where not kept or where lse =
// -inf; dP = dO . v; delta = sum_j P dP per query row in fp32; dS = P (dP -
// delta) scale [(1 - t^2) with softcap]; dq = sum dS K. Every row below sq
// of dq and delta is written (zeros for a row that keeps nothing): the
// wrapper allocates both uninitialised. delta is read unchanged by kernel
// 10.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 6 d flops per
// kept (query head, row, column) triple (S, dP, dQ) against q, dO, k, v,
// the LSE and the outputs moved once; this kernel does 10 d (S and dP
// twice) over whole 64 x 64 sub-tiles. At the plans' densities it is bound
// by operations.
//
// Design: kernel 14's dQ (dq_list_walk of csrc/flash_bwd_sm90.cuh, both
// kernels' code) on kernel 9's lists (csrc/block_sparse_fwd_sm90.cuh). A block is two 64-row wgmma
// warpgroups, 256 threads, one block per (two 64-row blocks 2m and 2m + 1,
// query head, batch row), the heads fastest and the last row blocks first;
// warpgroup i owns block 2m + i and its list. Thread 0 loads Q and dO once
// by TMA, merges the two lists (ascending (index << 2) | mode) with two
// pointers (kernel 9's Merge, in shared memory, its next entries copied by
// cp.async a step ahead), and for each merged step writes the key tile and
// each warpgroup's mode, or "absent", into a ring slot beside the stage,
// then issues the stage's copies: the K and V tiles (64 keys, TMA) and, for
// a warpgroup in mode 2, its sub-tile's 64 row words (512 bytes by the bulk
// copy engine). The merged list is walked twice, a sentinel (tile -1)
// after each pass, the merge restarted between them, so pass 2 gets its
// words again with its stages. Pass 1: S = Q K^T and dP = dO V^T (wgmma
// from shared memory), delta += P dP. Pass 2: S and dP again, dS, then dQ
// += dS K with dS as the register A operand and K read N-major. A
// warpgroup absent from a step only releases the stage. Masks by mode:
// mode 0 applies none; mode 1 the bounds (rows < sq, low_bits(sk - col0));
// mode 2 one bit of the row's word per element. TMA fills keys past sk
// with zeros, which would score 0, not -inf: a sub-tile that reaches past
// sk is never mode 0 (kernels/block_sparsity.py build_execution_lists), so
// the bounds are always tested there; rows past sq take lse +inf. A block
// whose two lists are empty issues no copy, waits on no barrier and
// writes zeros; with an odd number of row blocks the last block's second
// list is empty (its count is never read). Rows >= sq are never stored.
// Deterministic: no atomics; every dq and delta element is summed by one
// thread in a fixed order and written once.

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
using fa::bwd90::dq_list_walk;
using fa::bwd90::DqShared;
using fa::bwd90::kBlockRows;
using fa::bwd90::kThreads;
using fa::bwd90::kWarpgroups;
using fa::bwd90::lse_base2;
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

}  // namespace bsbwd90
}  // namespace fa
