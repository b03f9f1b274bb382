// Dense flash-attention backward for Hopper (kernels 2 and 3): dQ, dK and
// dV from q (b, h, sq, d), k, v (b, hk, sk, d), dO and the forward's
// log-sum-exp, in two kernels, for tensors read through their strides.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_bwd.py:233
// (_bwd_dkv_kernel) and :449 (_bwd_dq_kernel), launched by
// flash_attention_bwd (:669), restricted to the forward's features
// (csrc/flash_fwd_sm90.cuh): scale, bottom-right-aligned causal, sliding
// window, GQA/MQA (dK and dV sum each kv head's group of query heads),
// softcap, head dim 64 or 128, bf16/fp16. The varlen backward
// (csrc/flash_varlen_bwd_sm90.cuh), the sparse backward
// (csrc/flash_sparse_bwd_sm90.cuh) and the block-sparse backward
// (csrc/block_sparse_bwd_sm90.cuh) are built from these pieces.
//
// Function, as _recompute_p_and_ds (flash_bwd.py:107-230) with the port's
// delta: with s = q . k,
//   t  = tanh(s * scale / softcap)              (softcap only)
//   P  = exp(s * scale - lse) or exp(t * softcap - lse), 0 where masked and
//        on rows whose lse is -inf (rows that see no key)
//   dP = dO . v,  delta = sum_j P dP (per query row, fp32)
//   dS = P (dP - delta) scale  [(1 - t^2) with softcap]
//   dV = sum P^T dO,  dK = sum dS^T Q,  dQ = sum dS K.
// delta is summed in the dQ kernel, which runs first, not taken as
// rowsum(dO * O) as the JAX package does: with a 16-bit O the rowsum no
// longer matches the P and dP recomputed here, and a k-projection gradient
// magnifies what that leaves in dS (kernels/flash_bwd.py).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): dK/dV needs
// 8 d flops per visible (query head, row, key) triple (S, dP, dV, dK), dQ
// 6 d (S, dP, dQ); this dQ kernel does 10 d (S and dP twice), the pair
// 18 d against the 10 d of one backward that keeps dQ in fp32 atomics. At
// the training shapes both are bound by operations.
//
// Design. Deterministic: no atomics; every output element is summed by one
// thread in a fixed order, and each kernel writes its outputs once. A block
// is two warpgroups of 64 rows each (wgmma's M), 256 threads, so ptxas may
// give a thread 255 registers. There is no producer warp: ptxas compiles a
// kernel to its launch bound and the register file is split over four
// quarters by warp, so a ninth warp (288 threads) cut every thread to 168
// registers and spilled 136-512 bytes at d = 128. Thread 0 issues every
// TMA copy (4-D tensor maps over (d, s, h, b) from the caller's strides,
// the 128-byte swizzle of csrc/sm90_utils.cuh) into a ring of kStages
// stages with "full" and "empty" mbarriers: the first stages up front,
// then at the end of each step the stage of the step before, which the
// other warpgroup has most likely released by then. The walked tiles are
// 128 wide at d = 64 (64 with a softcap) and 64 at d = 128: at d = 64 the
// wider tiles took dQ to 0.81x (with its turns dropped) and dK/dV to 0.84x
// of the 64-wide ones; with a softcap or at d = 128 their accumulators
// spill.
//  * dQ (kernel 3), Q-stationary: one block per (128 query rows, query
//    head, batch row), the last rows (the longest causal rows) first. Q and
//    dO are loaded once; the visible K/V tiles are walked twice.
//    Pass 1: S = Q K^T and dP = dO V^T (wgmma, both operands from shared
//    memory, K-major), P from the rows' LSE, and delta += P dP in fp32,
//    reduced over the quad at the end. Pass 2: S and dP again, dS in
//    registers, and dQ += dS K with dS packed to 16 bits as wgmma's
//    register A operand (the accumulator layout is the A layout) and K read
//    N-major through the transpose flag. Pass 2 is pipelined: the S and dP
//    of tile i are issued before dQ of tile i - 1, so dS of tile i is formed
//    while the tensor cores run that dQ product.
//  * dK/dV (kernel 2), KV-stationary: one block per (128 keys, kv head,
//    batch row), the first key tiles (the longest causal walks) first. K
//    and V are loaded once; the walk goes over the group's query heads and,
//    for each, the query tiles that see these keys: Q, dO, and the tiles'
//    LSE and delta (1-D maps over the contiguous (b, h, sq) rows); each
//    warpgroup turns the LSE tile into base 2 once, while its first
//    products run. S^T = K Q^T and dP^T = V dO^T (A from shared memory;
//    B = Q or dO, K-major), P^T and dS^T in registers, then dV += P^T dO
//    and dK += dS^T Q with P^T and dS^T as register A operands and dO and
//    Q read N-major from the same swizzled tiles, so no tile is copied
//    twice or transposed. dK and dV sum the group in fp32 registers. The
//    two warpgroups take turns to issue their products (0.91x at d = 128;
//    in the dQ kernel turns read 1.04x at d = 64 and are not taken).
// Tried and dropped: forming P while dP runs (S and dP as two wgmma
// groups): dQ 1.10x and dK/dV 1.02x at d = 64. Both kernels reach about
// 290 TFLOP/s of their own products at d = 64 and 425 at d = 128
// (PERF.md); the pair does 18 d flops per visible triple where one
// backward with fp32 dQ atomics does 10 d.
// TMA fills boxes past the tensors' ends with zeros, which would score 0:
// rows past sq take lse +inf (P = 0), keys past sk are masked, and only
// tiles that cross the diagonal, a window edge or an end pay for the mask.
//
// Features (csrc/attn_features.cuh), in instances of their own (kFeat !=
// 0; launched from csrc/flash_bwd_features.cu), as in the forward: the
// kernels' range structs (DenseFeatRange, DenseFeatDkvRange) carry the
// rules into the shared walks, which take them only where R::kFeat says
// so, so that kernels 7 and 8 and the feature-free instances compile as
// before. P is recomputed as _recompute_p_and_ds does: the ALiBi term after
// the softcap, every visibility rule, and with dropout the keep mask Z:
// dV takes P Z / (1 - p), and dP becomes dP Z / (1 - p) before delta (the
// dQ kernel's first pass) and dS = P (dP - delta) use it. The learnable
// sink needs nothing here: P = exp(S - LSE) carries it. Kernel 3 walks the
// forward's key-tile sequence (key_tiles), kernel 2 the query rows that
// query_rows gives (every row from the right edge on for a block with sink
// tokens, narrowed to the chunks); both mask every tile with segment ids.

#pragma once

#include <type_traits>

#include "attn_features.cuh"
#include "mma_utils.cuh"
#include "sm90_utils.cuh"

namespace fa {
namespace bwd90 {

using namespace fa::sm90;

constexpr int kWarpgroups = 2;
constexpr int kBlockRows = 64 * kWarpgroups;  // query (dQ) or key (dK/dV) rows
constexpr int kThreads = 128 * kWarpgroups;
// Keys per K/V tile of the dQ walk, and query rows per Q/dO tile of the
// dK/dV walk: 128 at d = 64 without a softcap, else 64 (at d = 128 the
// accumulators need the registers, and with a softcap its tanh terms; at
// 128 both kernels spilled 150-300 bytes there).
__host__ __device__ constexpr int walk_tile(int d, bool softcap) {
  return d == 64 && !softcap ? 128 : 64;
}

// The dQ kernel's key tile: walk_tile's, but 64 in a feature instance,
// whose 128-key tiles at d 64 spilled 192-284 bytes.
__host__ __device__ constexpr int dq_walk_tile(int d, bool softcap,
                                               int feat) {
  return walk_tile(d, softcap || feat != 0);
}

template <int D, bool kSoftcap>
struct DqCfg {
  static constexpr int kStages = 4;
  static constexpr int kBN = walk_tile(D, kSoftcap);
  static constexpr int kQBytes = kBlockRows * D * 2;  // the Q or dO tile
  static constexpr int kTileBytes = kBN * D * 2;      // one K or V tile
  // 1024 bytes of slack to align the tiles for the swizzle.
  static constexpr size_t kSmem = 1024 + 2 * kQBytes +
                                  2 * kStages * kTileBytes +
                                  8 * (1 + 2 * kStages);
};

template <int D, bool kSoftcap>
struct DkvCfg {
  static constexpr int kStages = 4;
  static constexpr int kBQ = walk_tile(D, kSoftcap);
  static constexpr int kKVBytes = kBlockRows * D * 2;  // the K or V tile
  static constexpr int kQBytes = kBQ * D * 2;          // one Q or dO tile
  static constexpr int kStatBytes = kBQ * 4;           // one LSE or delta tile
  // A 1-D TMA copy faults on a box whose first value is not 16-byte
  // aligned, and a tile's rows start anywhere in the LSE and delta rows
  // (sq not a multiple of 4, or a packed sequence): each LSE or delta tile
  // is kStatBox values from up to 3 rows before its first row, in a slot
  // of kStatStride (128-byte aligned for TMA); stat_ofs(s) is where stage
  // s's rows start.
  static constexpr int kStatBox = kBQ + 4;
  static constexpr int kStatStride = kBQ + 32;
  // Per stage: Q, dO, LSE, delta, each warpgroup's copy of the LSE in base
  // 2, and the rows' offset.
  static constexpr size_t kSmem =
      1024 + 2 * kKVBytes +
      kStages * (2 * kQBytes + 2 * 4 * kStatStride + kWarpgroups * kStatBytes) +
      8 * (1 + 2 * kStages) + 4 * kStages;
};

struct Params {
  const float* lse;  // (b, h, sq) contiguous, natural log (dQ kernel)
  float* delta;      // (b, h, sq) contiguous, written by the dQ kernel
  void* dq;          // (b, h, sq, d) through dq_b, dq_h, dq_s
  void* dk;          // (b, hk, sk, d) through dk_*
  void* dv;          // (b, hk, sk, d) through dv_*
  long long dq_b, dq_h, dq_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  int h, group, sq, sk;
  int left, right;  // normalised window; negative = unbounded
  float scale;
  // Score in base 2 as in the forward: x * score_mul, or
  // tanh(x * score_mul) * cap_log2 with a softcap.
  float score_mul, cap_log2;
};

template <bool B>
using Bool = std::integral_constant<bool, B>;

// A row's LSE in base 2; +inf for a row past the end or one that sees no
// key, so that its P is exp2(x - inf) = 0.
__device__ __forceinline__ float lse_base2(float lse, bool ok) {
  return ok && lse != -INFINITY ? lse * kLog2e : INFINITY;
}

// P of score s given its row's LSE in base 2, and dS's factor dmul: the
// scale, times 1 - t^2 under a softcap. P is any parameter block with
// scale, score_mul and cap_log2 (this header's, or the varlen dQ's).
template <bool kSoftcap, typename P>
__device__ __forceinline__ float prob(const P& p, float s, float lse2,
                                      float& dmul) {
  if constexpr (kSoftcap) {
    const float t = tanhf(s * p.score_mul);
    dmul = (1.f - t * t) * p.scale;
    return exp2_approx(t * p.cap_log2 - lse2);
  } else {
    dmul = p.scale;
    return exp2_approx(fmaf(s, p.score_mul, -lse2));
  }
}

// Accumulators of a 64 x N tile packed to 16 bits as wgmma's A operand,
// k16 step by k16 step.
template <typename T, int N>
__device__ __forceinline__ void pack_a(const float (&acc)[N / 2],
                                       uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[kk][j] = Mma<T>::pack(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
    }
  }
}

// Rows r of a 64 x D accumulator tile (this thread's two, first + 8 i) out
// to global memory, 4 bytes at a time.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long row_stride,
                                           const int (&row)[2], int rows,
                                           int tig, const float (&acc)[D / 2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= rows) continue;
    T* dst = base + static_cast<long long>(row[i]) * row_stride + tig * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          Mma<T>::pack(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// The dQ consumer, shared by kernels 3, 8, 11 and 14: each warpgroup keeps
// its 64 rows of Q and dO in shared memory (wgmma's A), and stage s of a
// ring holds kBN keys of K and V, kTileBytes each (B, K-major; K also
// N-major for dQ += dS K). Pass 1: S = Q K^T and dP = dO V^T, delta += P
// dP. Pass 2: S and dP again, dS = P (dP - delta) dmul in registers, packed
// to 16 bits as wgmma's register A operand (the accumulator layout is the A
// layout), and dQ += dS K. dq_range_walk walks a range of tiles (kernels 3
// and 8), dq_list_walk the merged lists of two 64-row blocks (kernels 11
// and 14); the kernels' hooks give their lengths, masks and P. The walks
// follow kernels 3's and 14's code step for step, which keeps ptxas's
// registers for both, instance by instance: the same instructions in the
// same order, the kernels' own thread indices passed in, the ring and the
// hooks' values passed as arguments or held by reference. A hook that held
// copies of kernel 14's lengths and diagonals, or the ring pointer, cost it
// two registers in every instance.

// A dQ block's shared memory: its 128 rows of Q and dO (sQ, sdO), the K
// and V stages of its ring (sK, sV), and the barriers: q_full for Q and dO,
// full and empty per stage.
struct DqShared {
  unsigned char* sQ;
  unsigned char* sdO;
  unsigned char* sK;
  unsigned char* sV;
  uint64_t* q_full;
  uint64_t* full;
  uint64_t* empty;
};

// S = Q K^T and dP = dO V^T of stage s, issued and committed: A the
// warpgroup's rows of Q and dO (q_desc, do_desc), B stage s of K and V
// (k_desc, v_desc).
template <typename T, int D, int kBN, int kTileBytes>
__device__ __forceinline__ void dq_issue_sdp(float (&sc)[kBN / 2],
                                             float (&dp)[kBN / 2],
                                             uint64_t q_desc, uint64_t do_desc,
                                             uint64_t k_desc, uint64_t v_desc,
                                             int s) {
  fence_regs(sc);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // k16 step kk: column block kk / 4, 32 bytes per step inside it.
    const uint32_t qa = ((kk >> 2) * kBlockRows * 128 + (kk & 3) * 32) >> 4;
    const uint32_t kb =
        (s * kTileBytes + (kk >> 2) * kBN * 128 + (kk & 3) * 32) >> 4;
    wgmma_ss<T, kBN>(sc, q_desc + qa, k_desc + kb, kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qa = ((kk >> 2) * kBlockRows * 128 + (kk & 3) * 32) >> 4;
    const uint32_t kb =
        (s * kTileBytes + (kk >> 2) * kBN * 128 + (kk & 3) * 32) >> 4;
    wgmma_ss<T, kBN>(dp, do_desc + qa, v_desc + kb, kk > 0);
  }
  wgmma_commit();
}

// dQ += dS K of stage s, issued and committed: dS in da, K N-major
// (kn_desc).
template <typename T, int D, int kBN, int kTileBytes>
__device__ __forceinline__ void dq_issue_dq(float (&dq)[D / 2],
                                            uint32_t (&da)[kBN / 16][4],
                                            uint64_t kn_desc, int s) {
  fence_regs(dq);
  fence_regs(da);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    wgmma_rs<T, D>(dq, da[kk],
                   kn_desc + ((s * kTileBytes + kk * 16 * 128) >> 4), 1);
  }
  wgmma_commit();
}

// Pass 1's step over one tile: delta += P dP. Element e of sc and dp lies
// in row (e >> 1) & 1 of the thread's two; pr(e, s, i, dmul) gives P of
// score s in row i and dS's factor dmul, and with Bool<true> P is 0 where
// visible(e) is false.
template <int N, bool kMasked, class Pr, class Vis>
__device__ __forceinline__ void dq_sum_step(Bool<kMasked>, const float (&sc)[N],
                                            const float (&dp)[N],
                                            float (&dsum)[2], const Pr& pr,
                                            const Vis& visible) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int i = (e >> 1) & 1;
    float dmul;
    float p = pr(e, sc[e], i, dmul);
    if constexpr (kMasked) {
      if (!visible(e)) p = 0.f;
    }
    dsum[i] += p * dp[e];
  }
}

// Pass 2's step over one tile: dS into sc.
template <int N, bool kMasked, class Pr, class Vis>
__device__ __forceinline__ void dq_ds_step(Bool<kMasked>, float (&sc)[N],
                                           const float (&dp)[N],
                                           const float (&delta)[2],
                                           const Pr& pr, const Vis& visible) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int i = (e >> 1) & 1;
    float dmul;
    float p = pr(e, sc[e], i, dmul);
    if constexpr (kMasked) {
      if (!visible(e)) p = 0.f;
    }
    sc[e] = p * (dp[e] - delta[i]) * dmul;
  }
}

// Both passes of one warpgroup (rows from wrow0, thread tid, lane, tig,
// warpgroup cw) over its block's range of K/V tiles (kernels 3 and 8),
// which thread 0 copies through the ring twice, step x into stage x %
// C::kStages by load_kv(x): pass 1 (steps 0..n - 1) sums delta, pass 2
// (steps n..2n - 1) accumulates dQ, the S and dP of tile i issued before
// dQ of tile i - 1, so that dS of tile i is formed while the tensor cores
// run that product. `r` gives the block's walk and lengths: tile_lo(),
// n_tiles(), n_steps(), rows(), keys(), off(), and step_keys(masked), a
// functor for the key bound of a step's mask (kernel 3 reads them from its
// parameters, kernel 8 from shared memory); with R::kSkipEmpty a warpgroup
// whose rows start at or past rows() only takes the stages and releases
// them. Row i of the thread's two has diagonal diag[i] and LSE lse2[i] in
// base 2.
template <typename T, int D, bool kSoftcap, class C, class P, class R,
          class L>
__device__ __forceinline__ void dq_range_walk(
    const P& p, const R& r, const L& load_kv, const DqShared& sh, int tid,
    int lane, int tig, int cw, int wrow0, const int (&diag)[2],
    const float (&lse2)[2], float (&dq)[D / 2], float (&delta)[2]) {
  constexpr int kStages = C::kStages;
  constexpr int kBN = C::kBN;
  // Step x's stage is free for step x + kStages once both warpgroups are
  // done with it; thread 0 refills the stage of step x - 1, which the other
  // warpgroup has most likely released by then, so that warp 0 seldom
  // waits.
  auto release = [&](int x) {
    __syncwarp();
    if (lane == 0) mbar_arrive(sh.empty + x % kStages);
    if (tid == 0 && x >= 1 && x - 1 + kStages < r.n_steps()) {
      load_kv(x - 1 + kStages);
    }
  };

  if (R::kSkipEmpty && r.n_tiles() > 0 && wrow0 >= r.rows()) {
    for (int x = 0; x < r.n_steps(); ++x) {
      mbar_wait(sh.full + x % kStages, (x / kStages) & 1);
      release(x);
    }
  } else if (r.n_tiles() > 0) {
    // Descriptors: this warpgroup's Q and dO rows (A), K and V K-major (B of
    // S and dP), K N-major (B of dQ += dS K).
    const uint64_t q_desc = make_desc(sh.sQ + cw * 64 * 128, 16, 1024);
    const uint64_t do_desc = make_desc(sh.sdO + cw * 64 * 128, 16, 1024);
    const uint64_t k_desc = make_desc(sh.sK, 16, 1024);
    const uint64_t v_desc = make_desc(sh.sV, 16, 1024);
    const uint64_t kn_desc = make_desc(sh.sK, kBN * 128, 1024);
    float sc[kBN / 2];
    float dp[kBN / 2];
    uint32_t da[kBN / 16][4];

    auto issue_sdp = [&](int x) {
      const int s = x % kStages;
      mbar_wait(sh.full + s, (x / kStages) & 1);
      dq_issue_sdp<T, D, kBN, C::kTileBytes>(sc, dp, q_desc, do_desc, k_desc,
                                             v_desc, s);
    };
    auto issue_dq = [&](int x) {
      dq_issue_dq<T, D, kBN, C::kTileBytes>(dq, da, kn_desc, x % kStages);
    };
    auto fence_sdp = [&] {
      fence_regs(sc);
      fence_regs(dp);
    };

    // Whether every row of this warpgroup sees every key of the tile: no
    // row past rows(), no key past keys(), no diagonal or window edge (and
    // with features, r.full: no chunk edge or segment ids).
    auto tile_full = [&](int col0) {
      const int off = r.off();
      const bool full = wrow0 + 64 <= r.rows() && col0 + kBN <= r.keys() &&
                        in_window(col0, wrow0 + 63 + off, p.left, -1) &&
                        in_window(col0 + kBN - 1, wrow0 + off, -1, p.right);
      if constexpr (R::kFeat != 0) {
        return full && r.full(col0, col0 + kBN - 1, wrow0 + off,
                              wrow0 + 63 + off);
      } else {
        return full;
      }
    };
    auto pr = [&](int, float s, int i, float& dmul) {
      return prob<kSoftcap>(p, s, lse2[i], dmul);
    };
    float dsum[2] = {0.f, 0.f};
    // Tile col0's step of pass 1 or, with Bool<true> as pass2, pass 2.
    auto step = [&](auto pass2, auto masked, int col0) {
      const auto keys = r.step_keys(masked);
      if constexpr (R::kFeat != 0) {
        // The range's rules: P with the ALiBi term, visibility, and with
        // dropout dP Z / (1 - p) in place.
        r.drop_dp(dp, col0, tig);
        auto prf = [&](int e, float s, int i, float& dmul) {
          return r.prob(s, col0 + (e >> 2) * 8 + tig * 2 + (e & 1), i, lse2[i],
                        dmul);
        };
        auto visible = [&](int e) {
          const int col = col0 + (e >> 2) * 8 + tig * 2 + (e & 1);
          return col < keys() && r.visible(col, (e >> 1) & 1);
        };
        if constexpr (decltype(pass2)::value) {
          dq_ds_step(masked, sc, dp, delta, prf, visible);
        } else {
          dq_sum_step(masked, sc, dp, dsum, prf, visible);
        }
      } else {
        auto visible = [&](int e) {
          const int i = (e >> 1) & 1;
          const int col = col0 + (e >> 2) * 8 + tig * 2 + (e & 1);
          return col < keys() && in_window(col, diag[i], p.left, p.right);
        };
        if constexpr (decltype(pass2)::value) {
          dq_ds_step(masked, sc, dp, delta, pr, visible);
        } else {
          dq_sum_step(masked, sc, dp, dsum, pr, visible);
        }
      }
    };
    auto tile_step = [&](auto pass2, int it) {
      int col0;
      if constexpr (R::kFeat != 0) {
        col0 = r.tile(it) * kBN;
      } else {
        col0 = (r.tile_lo() + it) * kBN;
      }
      if (tile_full(col0)) {
        step(pass2, Bool<false>(), col0);
      } else {
        step(pass2, Bool<true>(), col0);
      }
    };

    mbar_wait(sh.q_full, 0);
    const int n_tiles = r.n_tiles();
    for (int it = 0; it < n_tiles; ++it) {
      issue_sdp(it);
      wgmma_wait<0>();
      fence_sdp();
      release(it);
      tile_step(Bool<false>(), it);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) delta[i] = quad_sum(dsum[i]);

    // Pass 2, steps n_tiles.. of the ring.
    issue_sdp(n_tiles);
    wgmma_wait<0>();
    fence_sdp();
    tile_step(Bool<true>(), 0);
    pack_a<T, kBN>(sc, da);
    for (int it = 1; it < n_tiles; ++it) {
      issue_sdp(n_tiles + it);
      issue_dq(n_tiles + it - 1);
      wgmma_wait<1>();  // S and dP of tile it (committed first) are done
      fence_sdp();
      tile_step(Bool<true>(), it);
      wgmma_wait<0>();  // dQ of tile it - 1 is done
      fence_regs(dq);
      release(n_tiles + it - 1);
      pack_a<T, kBN>(sc, da);
    }
    issue_dq(2 * n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(dq);
    release(2 * n_tiles - 1);
  }
}

// Both passes of one warpgroup (thread tid, lane, warpgroup cw) over a ring
// of merged list steps (kernels 11 and 14), kBN = 64 keys a step: thread 0
// fills item y into stage y % kStages, each pass's steps ended by a
// sentinel (tile -1), and refill(x), called by thread 0 once item x is
// released, fills the stage of item x - 1, which the other warpgroup has
// most likely released by then. The hooks `h` read slot ring[s] of stage s,
// read(ring[s], s, it) (the item's key tile and this warpgroup's part `it`,
// of type H::Item), and give on(it) (whether this warpgroup takes the step;
// if not, it only releases the stage), unmasked(col0, it) and mask(col0,
// it) for the tile's first key col0, and prob(m, e, s, lse2, dmul) and
// visible(m, e) under mask m. Pass 2 forms dS
// and then runs dQ += dS K, step by step: pipelined as kernel 3 is, kernel
// 14 read 1.29x slower at prefill-8k, with a fifth stage so that the step
// held back cost no prefetch; the two warpgroups already overlap each
// other's products.
template <typename T, int D, int kBN, int kStages, int kTileBytes, class H,
          class S, class F>
__device__ __forceinline__ void dq_list_walk(
    const H& h, const S* ring, const F& refill, const DqShared& sh, int tid,
    int lane, int cw, const float (&lse2)[2], float (&dq)[D / 2],
    float (&delta)[2]) {
  using Item = typename H::Item;
  // Descriptors: this warpgroup's Q and dO rows (A), K and V K-major (B of
  // S and dP), K N-major (B of dQ += dS K).
  const uint64_t q_desc = make_desc(sh.sQ + cw * 64 * 128, 16, 1024);
  const uint64_t do_desc = make_desc(sh.sdO + cw * 64 * 128, 16, 1024);
  const uint64_t k_desc = make_desc(sh.sK, 16, 1024);
  const uint64_t v_desc = make_desc(sh.sV, 16, 1024);
  const uint64_t kn_desc = make_desc(sh.sK, kBN * 128, 1024);
  float sc[kBN / 2];
  float dp[kBN / 2];
  uint32_t da[kBN / 16][4];

  auto issue_sdp = [&](int s) {
    dq_issue_sdp<T, D, kBN, kTileBytes>(sc, dp, q_desc, do_desc, k_desc,
                                        v_desc, s);
  };
  auto fence_sdp = [&] {
    fence_regs(sc);
    fence_regs(dp);
  };
  auto issue_dq = [&](int s) {
    dq_issue_dq<T, D, kBN, kTileBytes>(dq, da, kn_desc, s);
  };

  int x = 0;  // the consumers' ring position
  auto wait_step = [&](Item& it) {
    const int s = x % kStages;
    mbar_wait(sh.full + s, (x / kStages) & 1);
    return h.read(ring[s], s, it);
  };
  auto release = [&] {
    __syncwarp();
    if (lane == 0) mbar_arrive(sh.empty + x % kStages);
    if (tid == 0) refill(x);
  };
  float dsum[2] = {0.f, 0.f};
  // A tile's step of pass 1 or, with Bool<true> as pass2, pass 2.
  auto step = [&](auto pass2, int col0, const Item& it) {
    const auto m = h.mask(col0, it);
    auto pr = [&](int e, float s, int i, float& dmul) {
      return h.prob(m, e, s, lse2[i], dmul);
    };
    auto visible = [&](int e) { return h.visible(m, e); };
    auto run = [&](auto masked) {
      if constexpr (decltype(pass2)::value) {
        dq_ds_step(masked, sc, dp, delta, pr, visible);
      } else {
        dq_sum_step(masked, sc, dp, dsum, pr, visible);
      }
    };
    if (h.unmasked(col0, it)) {
      run(Bool<false>());
    } else {
      run(Bool<true>());
    }
  };

  mbar_wait(sh.q_full, 0);
  for (;; ++x) {
    Item it;
    const int tile = wait_step(it);
    if (h.on(it) && tile >= 0) {
      issue_sdp(x % kStages);
      wgmma_wait<0>();
      fence_sdp();
    }
    release();
    if (tile < 0) break;
    if (h.on(it)) step(Bool<false>(), tile * kBN, it);
  }
  ++x;
#pragma unroll
  for (int i = 0; i < 2; ++i) delta[i] = quad_sum(dsum[i]);

  for (;; ++x) {
    Item it;
    const int tile = wait_step(it);
    if (tile < 0) break;  // the last item: nothing follows it
    if (h.on(it)) {
      const int s = x % kStages;
      const int col0 = tile * kBN;
      issue_sdp(s);
      wgmma_wait<0>();
      fence_sdp();
      step(Bool<true>(), col0, it);
      pack_a<T, kBN>(sc, da);
      issue_dq(s);
      wgmma_wait<0>();
      fence_regs(dq);
    }
    release();
  }
}

// The dK/dV consumer of kernels 2 and 7 (dkv_range_walk; kernel 10 runs
// kernel 13's steps in a walk of its own, csrc/block_sparse_bwd_sm90.cuh):
// each warpgroup keeps its 64 keys of K and V in shared memory (wgmma's A),
// and stage s of a ring holds kBQ query rows of Q and dO (B, K-major for S^T
// = K Q^T and dP^T = V dO^T, N-major for dV += P^T dO and dK += dS^T Q)
// with the rows' LSE and delta. P^T and dS^T are formed in registers and
// packed to 16 bits as the register A operands; dK and dV sum in fp32 over
// the walk. While S^T and dP^T run, each warpgroup copies the stage's LSE
// into base 2 (+inf for a row past the end or one that sees no key), so
// that each score takes one FFMA before its exponential. The walk follows
// kernel 2's code step for step, as the dQ walks do, with the kernels' own
// thread indices passed in and the hooks' values held by reference; every
// instance of kernel 2 keeps its registers.

// A dK/dV block's shared memory: its 128 keys of K and V (sK, sV), the Q
// and dO stages of its ring (sQ, sdO), the stages' LSE and delta (sL, sD)
// and each warpgroup's base-2 copy of the LSE (sL2, [kWarpgroups][kStages]
// rows), and the barriers: kv_full for K and V, full and empty per stage.
struct DkvShared {
  unsigned char* sK;
  unsigned char* sV;
  unsigned char* sQ;
  unsigned char* sdO;
  float* sL;
  float* sD;
  float* sL2;
  uint64_t* kv_full;
  uint64_t* full;
  uint64_t* empty;
};

// One warpgroup's walk (keys from wkey0, thread tid, t = tid % 128, lane,
// tig, warpgroup cw; this thread's two keys key[]) over its block's range
// of query tiles (kernels 2 and 7), which thread 0 copies through the ring,
// step it into stage it % C::kStages by load_q(it). `r` gives the block's
// walk and lengths: qt_lo(), n_qt(), n_iter() (n_qt() tiles for each query
// head of the group), rows(), keys(), off() (kernel 2 reads them from its
// parameters, kernel 7 from shared memory or, for keys() and off(), which
// each masked element reads, its registers), and stat_ofs(s), where stage
// s's LSE and delta rows start in their tiles of C::kStatStride floats
// (read from a 16-byte aligned start, which a 1-D TMA copy needs). The two
// warpgroups take turns to issue their products (named barriers 1 and 2 in
// a ring): one's products run while the other forms P^T and dS^T (0.91x at
// d 128 for kernel 2; 0.99x, no gain, for kernel 7 on gpt2m-packed's short
// documents, kept for one code path).
template <typename T, int D, bool kSoftcap, class C, class P, class R,
          class L>
__device__ __forceinline__ void dkv_range_walk(
    const P& p, const R& r, const L& load_q, const DkvShared& sh, int tid,
    int t, int lane, int tig, int cw, int wkey0, const int (&key)[2],
    float (&dk)[D / 2], float (&dv)[D / 2]) {
  constexpr int kStages = C::kStages;
  constexpr int kBQ = C::kBQ;
  if (r.n_iter() > 0) {
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

    // P^T and dS^T of step s's tile (query rows rb.., their delta from
    // row o of the stage's tile) in place; with features, by the range's
    // rules for the step's query head (r.head_rules(it)).
    auto p_ds_step = [&](auto masked, int s, int rb, int o, int it) {
      const float* lse2 = sh.sL2 + (cw * kStages + s) * kBQ;
      const float* dlt = sh.sD + s * C::kStatStride + o;
      if constexpr (R::kFeat != 0) {
        const auto hr = r.head_rules(it);
#pragma unroll
        for (int x = 0; x < kBQ / 2; ++x) {
          const int i = (x >> 1) & 1;
          const int c = (x >> 2) * 8 + tig * 2 + (x & 1);
          const int row = rb + c;
          float dmul;
          float pr = r.prob(hr, st[x], lse2[c], key[i], row, dmul);
          if constexpr (decltype(masked)::value) {
            if (!(key[i] < r.keys() && r.visible(key[i], row, i))) pr = 0.f;
          }
          // With dropout, dV takes P Z / (1 - p) and dS = P (dP Z /
          // (1 - p) - delta).
          float pz = pr;
          float dz = dpt[x];
          if constexpr ((R::kFeat & kFeatDrop) != 0) {
            const bool keep = r.keep(hr, row, key[i]);
            pz = keep ? pr * r.keep_scale() : 0.f;
            dz = keep ? dz * r.keep_scale() : 0.f;
          }
          st[x] = pz;
          dpt[x] = pr * (dz - dlt[c]) * dmul;
        }
      } else {
#pragma unroll
        for (int x = 0; x < kBQ / 2; ++x) {
          const int i = (x >> 1) & 1;
          const int c = (x >> 2) * 8 + tig * 2 + (x & 1);
          const int row = rb + c;
          float dmul;
          float pr = prob<kSoftcap>(p, st[x], lse2[c], dmul);
          if constexpr (decltype(masked)::value) {
            if (!(key[i] < r.keys() &&
                  in_window(key[i], row + r.off(), p.left, p.right))) {
              pr = 0.f;
            }
          }
          st[x] = pr;
          dpt[x] = pr * (dpt[x] - dlt[c]) * dmul;
        }
      }
    };

    auto turn_begin = [&] { named_barrier(1 + cw, 256); };
    auto turn_end = [&] { named_arrive(1 + (cw ^ 1), 256); };
    mbar_wait(sh.kv_full, 0);
    if (cw == 1) named_arrive(1, 256);
    for (int it = 0; it < r.n_iter(); ++it) {
      const int s = it % kStages;
      const int rb = (r.qt_lo() + it % r.n_qt()) * kBQ;
      turn_begin();
      mbar_wait(sh.full + s, (it / kStages) & 1);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ka = ((kk >> 2) * kBlockRows * 128 + (kk & 3) * 32) >> 4;
        const uint32_t qb =
            (s * C::kQBytes + (kk >> 2) * kBQ * 128 + (kk & 3) * 32) >> 4;
        wgmma_ss<T, kBQ>(st, k_desc + ka, q_desc + qb, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ka = ((kk >> 2) * kBlockRows * 128 + (kk & 3) * 32) >> 4;
        const uint32_t qb =
            (s * C::kQBytes + (kk >> 2) * kBQ * 128 + (kk & 3) * 32) >> 4;
        wgmma_ss<T, kBQ>(dpt, v_desc + ka, do_desc + qb, kk > 0);
      }
      wgmma_commit();
      turn_end();
      // While the products run: this warpgroup's copy of the tile's LSE in
      // base 2.
      const int o = r.stat_ofs(s);
      for (int c = t; c < kBQ; c += 128) {
        sh.sL2[(cw * kStages + s) * kBQ + c] =
            lse_base2(sh.sL[s * C::kStatStride + o + c], rb + c < r.rows());
      }
      named_barrier(3 + cw, 128);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      bool full_tile =
          rb + kBQ <= r.rows() && wkey0 + 64 <= r.keys() &&
          in_window(wkey0, rb + kBQ - 1 + r.off(), p.left, -1) &&
          in_window(wkey0 + 63, rb + r.off(), -1, p.right);
      if constexpr (R::kFeat != 0) {
        full_tile = full_tile && r.full(wkey0, wkey0 + 63, rb + r.off(),
                                        rb + kBQ - 1 + r.off());
      }
      if (full_tile) {
        p_ds_step(Bool<false>(), s, rb, o, it);
      } else {
        p_ds_step(Bool<true>(), s, rb, o, it);
      }
      pack_a<T, kBQ>(st, pa);
      pack_a<T, kBQ>(dpt, da);

      // dV += P^T dO and dK += dS^T Q (dS already carries the scale).
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
      turn_begin();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint32_t step = (s * C::kQBytes + kk * 16 * 128) >> 4;
        wgmma_rs<T, D>(dv, pa[kk], don_desc + step, 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint32_t step = (s * C::kQBytes + kk * 16 * 128) >> 4;
        wgmma_rs<T, D>(dk, da[kk], qn_desc + step, 1);
      }
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      __syncwarp();
      if (lane == 0) mbar_arrive(sh.empty + s);
      if (tid == 0 && it >= 1 && it - 1 + kStages < r.n_iter()) {
        load_q(it - 1 + kStages);
      }
    }
  }
}

// Kernel 2's block for dkv_range_walk: its tile range, the lengths read
// from its parameters where they are used, and the stages' row offsets.
struct DenseDkvRange {
  static constexpr int kFeat = 0;
  const Params& p;
  volatile int* sofs;
  int lo, n, n_it, off_;
  __device__ __forceinline__ int qt_lo() const { return lo; }
  __device__ __forceinline__ int n_qt() const { return n; }
  __device__ __forceinline__ int n_iter() const { return n_it; }
  __device__ __forceinline__ int rows() const { return p.sq; }
  __device__ __forceinline__ int keys() const { return p.sk; }
  __device__ __forceinline__ int off() const { return off_; }
  __device__ __forceinline__ int stat_ofs(int s) const { return sofs[s]; }
};

// Kernel 3's block for dq_range_walk: its tile range, and the lengths read
// from its parameters where they are used.
struct DenseRange {
  static constexpr bool kSkipEmpty = false;
  static constexpr int kFeat = 0;
  const Params& p;
  int lo, n, n2, off_;
  __device__ __forceinline__ int tile_lo() const { return lo; }
  __device__ __forceinline__ int n_tiles() const { return n; }
  __device__ __forceinline__ int n_steps() const { return n2; }
  __device__ __forceinline__ int rows() const { return p.sq; }
  __device__ __forceinline__ int keys() const { return p.sk; }
  __device__ __forceinline__ int off() const { return off_; }
  template <class M>
  __device__ __forceinline__ auto step_keys(M) const {
    return [this] { return p.sk; };
  }
};

// The parameters of an instance with features.
struct FeatParams : Params {
  Features f;
};

template <int kFeat>
using ParamsOf = std::conditional_t<kFeat == 0, Params, FeatParams>;

// Score s's P in base 2 with the ALiBi term slope2 |col - diag| (an
// extended instance), and dS's factor dmul as prob gives it. P is any
// parameter block with scale, score_mul and cap_log2 (this header's, or the
// varlen kernels').
template <bool kSoftcap, typename P>
__device__ __forceinline__ float prob_alibi(const P& p, float s,
                                            float lse2, float slope2,
                                            int dist, float& dmul) {
  float s2;
  if constexpr (kSoftcap) {
    const float t = tanhf(s * p.score_mul);
    dmul = (1.f - t * t) * p.scale;
    s2 = t * p.cap_log2;
  } else {
    dmul = p.scale;
    s2 = s * p.score_mul;
  }
  return exp2_approx(s2 - slope2 * fabsf(static_cast<float>(dist)) - lse2);
}

// Kernel 3's block for dq_range_walk with features (kF = kFeat): its walk
// (the forward's key_tiles sequence in an extended instance) and, for this
// thread's two rows (diagonals diag[i]), the rules: the head's ALiBi slope
// in base 2, the rows' segment ids and dropout hash parts.
template <int kF, bool kSoftcap>
struct DenseFeatRange {
  static constexpr bool kSkipEmpty = false;
  static constexpr int kFeat = kF;
  static constexpr bool kExt = (kF & kFeatExt) != 0;
  const FeatParams& p;
  int lo, n, n2, off_;
  KeyTiles kt;
  const int (&diag)[2];
  float slope2;
  int qseg[2];
  const int* kvs;  // this batch row's kv segment ids
  uint32_t drop_row[2];
  __device__ __forceinline__ int n_tiles() const { return n; }
  __device__ __forceinline__ int n_steps() const { return n2; }
  __device__ __forceinline__ int rows() const { return p.sq; }
  __device__ __forceinline__ int keys() const { return p.sk; }
  __device__ __forceinline__ int off() const { return off_; }
  template <class M>
  __device__ __forceinline__ auto step_keys(M) const {
    return [this] { return p.sk; };
  }
  __device__ __forceinline__ int tile(int it) const {
    if constexpr (kExt) {
      return kt.tile(it);
    } else {
      return lo + it;
    }
  }
  // Whether the chunk and the segment ids leave a tile of keys c_lo..c_hi
  // whole for rows of diagonals d_lo..d_hi (the window is tested apart).
  __device__ __forceinline__ bool full(int c_lo, int c_hi, int d_lo,
                                       int d_hi) const {
    if constexpr (kExt) {
      return !p.f.q_seg && chunk_full(c_lo, c_hi, d_lo, d_hi, p.f);
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
      return visible_ext(col, diag[i], p.left, p.right, p.f) &&
             (!p.f.q_seg || qseg[i] == kvs[col]);
    } else {
      return in_window(col, diag[i], p.left, p.right);
    }
  }
  // dP Z / (1 - p) in place, with dropout.
  template <int N>
  __device__ __forceinline__ void drop_dp(float (&dp)[N], int col0,
                                          int tig) const {
    if constexpr ((kF & kFeatDrop) != 0) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int col = col0 + (e >> 2) * 8 + tig * 2 + (e & 1);
        dp[e] = dropout_keep(drop_row[(e >> 1) & 1], col, p.f.keep_threshold)
                    ? dp[e] * p.f.keep_scale
                    : 0.f;
      }
    }
  }
};

// Kernel 2's block for dkv_range_walk with features: its range (the rows
// query_rows gives in an extended instance), and the rules for this
// thread's two keys (their segment ids) and each step's query head
// (head_rules: its ALiBi slope in base 2 and dropout hash base).
template <int kF, bool kSoftcap>
struct DenseFeatDkvRange {
  static constexpr int kFeat = kF;
  static constexpr bool kExt = (kF & kFeatExt) != 0;
  const FeatParams& p;
  volatile int* sofs;
  int lo, n, n_it, off_;
  int b, g;
  int kvseg[2];
  __device__ __forceinline__ int qt_lo() const { return lo; }
  __device__ __forceinline__ int n_qt() const { return n; }
  __device__ __forceinline__ int n_iter() const { return n_it; }
  __device__ __forceinline__ int rows() const { return p.sq; }
  __device__ __forceinline__ int keys() const { return p.sk; }
  __device__ __forceinline__ int off() const { return off_; }
  __device__ __forceinline__ int stat_ofs(int s) const { return sofs[s]; }
  struct HeadRules {
    float slope2;
    uint32_t base;
  };
  // Step it's query head's rules.
  __device__ __forceinline__ HeadRules head_rules(int it) const {
    const int head = g * p.group + it / n;
    HeadRules hr;
    hr.slope2 = kExt && p.f.slopes
                    ? p.f.slopes[b * p.f.slope_b + head] * kLog2e
                    : 0.f;
    hr.base = (kF & kFeatDrop) != 0 ? dropout_base(p.f.seed, b, head) : 0u;
    return hr;
  }
  __device__ __forceinline__ bool full(int k_lo, int k_hi, int d_lo,
                                       int d_hi) const {
    if constexpr (kExt) {
      return !p.f.q_seg && chunk_full(k_lo, k_hi, d_lo, d_hi, p.f);
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
  // Key `key` (thread's key i) from query row `row`; rows past sq take
  // P = 0 through their LSE, but read no segment id.
  __device__ __forceinline__ bool visible(int key, int row, int i) const {
    if constexpr (kExt) {
      return visible_ext(key, row + off_, p.left, p.right, p.f) &&
             (!p.f.q_seg ||
              (row < p.sq && p.f.q_seg[b * p.f.q_seg_b + row] == kvseg[i]));
    } else {
      return in_window(key, row + off_, p.left, p.right);
    }
  }
  __device__ __forceinline__ bool keep(const HeadRules& hr, int row,
                                       int key) const {
    return dropout_keep(dropout_row(hr.base, row), key, p.f.keep_threshold);
  }
  __device__ __forceinline__ float keep_scale() const {
    return p.f.keep_scale;
  }
};

template <typename T, int D, bool kSoftcap, int kFeat = 0>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const ParamsOf<kFeat> p) {
  constexpr bool kExt = (kFeat & kFeatExt) != 0;
  // A feature instance walks 64-key tiles at d 64 too (dq_walk_tile).
  using C = DqCfg<D, kSoftcap || kFeat != 0>;
  static_assert(C::kBN == dq_walk_tile(D, kSoftcap, kFeat), "dQ key tile");
  constexpr int kStages = C::kStages;
  constexpr int kBN = C::kBN;
  constexpr int kBlocksD = D / 64;  // 128-byte column blocks of a row
  extern __shared__ unsigned char smem_bwd90[];
  unsigned char* sQ =
      smem_bwd90 + ((1024 - (smem_u32(smem_bwd90) & 1023)) & 1023);
  unsigned char* sdO = sQ + C::kQBytes;
  unsigned char* sK = sdO + C::kQBytes;
  unsigned char* sV = sK + kStages * C::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * C::kTileBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;
  const int off = p.sk - p.sq;
  const int row_last = min(row0 + kBlockRows, p.sq) - 1;
  const int col_lo = p.left >= 0 ? max(row0 + off - p.left, 0) : 0;
  const int col_hi =
      p.right >= 0 ? min(row_last + off + p.right, p.sk - 1) : p.sk - 1;
  const int tile_lo = col_lo / kBN;
  const int n_range = col_hi >= col_lo ? col_hi / kBN - tile_lo + 1 : 0;
  // An extended instance walks the forward's sequence (key_tiles).
  KeyTiles kt = {};
  if constexpr (kExt) {
    kt = key_tiles(row0, row_last, off, p.left, p.right, p.sk, kBN, p.f);
  }
  const int n_tiles = kExt ? kt.n : n_range;
  auto tile_of = [&](int it) {
    if constexpr (kExt) {
      return kt.tile(it);
    } else {
      return tile_lo + it;
    }
  };
  const int tid = threadIdx.x;

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

  // The copies, all issued by thread 0: Q and dO once, then the visible
  // K/V tiles twice (pass 1 sums delta, pass 2 accumulates dQ), step x
  // into stage x % kStages once every warp has released step x - kStages.
  const int n_steps = 2 * n_tiles;
  auto load_kv = [&](int x) {
    const int s = x % kStages;
    const int key0 = tile_of(x % n_tiles) * kBN;
    const int g = head / p.group;
    mbar_wait(empty + s, ((x / kStages) & 1) ^ 1);
    mbar_expect_tx(full + s, 2 * C::kTileBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocksD; ++cb) {
      tma_load_4d(sK + s * C::kTileBytes + cb * kBN * 128, &tk, full + s,
                  cb * 64, key0, g, b);
      tma_load_4d(sV + s * C::kTileBytes + cb * kBN * 128, &tv, full + s,
                  cb * 64, key0, g, b);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(q_full, 2 * C::kQBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocksD; ++cb) {
      tma_load_4d(sQ + cb * kBlockRows * 128, &tq, q_full, cb * 64, row0, head,
                  b);
      tma_load_4d(sdO + cb * kBlockRows * 128, &tdo, q_full, cb * 64, row0,
                  head, b);
    }
    for (int x = 0; x < min(kStages, n_steps); ++x) load_kv(x);
  }

  const int cw = tid >> 7;  // warpgroup: rows 64 cw..
  const int t = tid & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wrow0 = row0 + cw * 64;
  const long long lrow = (static_cast<long long>(b) * p.h + head) * p.sq;

  int row[2], diag[2];
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = wrow0 + warp * 16 + gid + 8 * i;
    diag[i] = row[i] + off;
    const bool ok = row[i] < p.sq;
    lse2[i] = lse_base2(ok ? p.lse[lrow + row[i]] : 0.f, ok);
  }
  float dq[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
  float delta[2] = {0.f, 0.f};

  const DqShared sh{sQ, sdO, sK, sV, q_full, full, empty};
  if constexpr (kFeat == 0) {
    dq_range_walk<T, D, kSoftcap, C>(
        p, DenseRange{p, tile_lo, n_tiles, n_steps, off}, load_kv, sh, tid,
        lane, tig, cw, wrow0, diag, lse2, dq, delta);
  } else {
    DenseFeatRange<kFeat, kSoftcap> r{p,  tile_lo, n_tiles, n_steps,
                                      off, kt,     diag};
    r.slope2 = kExt && p.f.slopes
                   ? p.f.slopes[b * p.f.slope_b + head] * kLog2e
                   : 0.f;
    r.kvs = p.f.kv_seg + b * p.f.kv_seg_b;
    const uint32_t base = dropout_base(p.f.seed, b, head);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r.qseg[i] = kExt && p.f.q_seg && row[i] < p.sq
                      ? p.f.q_seg[b * p.f.q_seg_b + row[i]]
                      : 0;
      r.drop_row[i] = dropout_row(base, row[i]);
    }
    dq_range_walk<T, D, kSoftcap, C>(p, r, load_kv, sh, tid, lane, tig, cw,
                                     wrow0, diag, lse2, dq, delta);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (tig == 0 && row[i] < p.sq) p.delta[lrow + row[i]] = delta[i];
  }
  store_rows<T, D>(static_cast<T*>(p.dq) + b * p.dq_b + head * p.dq_h,
                   p.dq_s, row, p.sq, tig, dq);
}

template <typename T, int D, bool kSoftcap, int kFeat = 0>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tlse,
                        const __grid_constant__ CUtensorMap tdelta,
                        const ParamsOf<kFeat> p) {
  constexpr bool kExt = (kFeat & kFeatExt) != 0;
  using C = DkvCfg<D, kSoftcap>;
  constexpr int kStages = C::kStages;
  constexpr int kBQ = C::kBQ;
  constexpr int kBlocksD = D / 64;
  extern __shared__ unsigned char smem_bwd90[];
  unsigned char* sK =
      smem_bwd90 + ((1024 - (smem_u32(smem_bwd90) & 1023)) & 1023);
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
  volatile int* sofs = reinterpret_cast<int*>(empty + kStages);  // [kStages]

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int key0 = blockIdx.x * kBlockRows;
  const int off = p.sk - p.sq;
  const int key_last = min(key0 + kBlockRows, p.sk) - 1;
  // Query rows that see any key of the block, in tiles of kBQ, for each
  // query head of the group: step it reads query head g * group + it /
  // n_qt, rows (qt_lo + it % n_qt) * kBQ..
  int q_hi;
  int q_lo;
  if constexpr (kExt) {
    q_lo = query_rows(key0, key_last, off, p.left, p.right, p.sq, p.f, q_hi);
  } else {
    q_lo = p.right >= 0 ? max(key0 - off - p.right, 0) : 0;
    q_hi = p.left >= 0 ? min(key_last - off + p.left, p.sq - 1) : p.sq - 1;
  }
  const int qt_lo = q_lo / kBQ;
  const int n_qt = q_hi >= q_lo ? q_hi / kBQ - qt_lo + 1 : 0;
  const int n_iter = n_qt * p.group;
  const int tid = threadIdx.x;

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

  // The copies, all issued by thread 0: K and V once, then per step a Q,
  // dO, LSE and delta tile, step it into stage it % kStages once every
  // warp has released step it - kStages.
  auto load_q = [&](int it) {
    const int s = it % kStages;
    const int head = g * p.group + it / n_qt;
    const int rb = (qt_lo + it % n_qt) * kBQ;
    const int li = (b * p.h + head) * p.sq + rb;
    mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
    sofs[s] = li & 3;
    mbar_expect_tx(full + s, 2 * C::kQBytes + 2 * 4 * C::kStatBox);
#pragma unroll
    for (int cb = 0; cb < kBlocksD; ++cb) {
      tma_load_4d(sQ + s * C::kQBytes + cb * kBQ * 128, &tq, full + s, cb * 64,
                  rb, head, b);
      tma_load_4d(sdO + s * C::kQBytes + cb * kBQ * 128, &tdo, full + s,
                  cb * 64, rb, head, b);
    }
    tma_load_1d(sL + s * C::kStatStride, &tlse, full + s, li & ~3);
    tma_load_1d(sD + s * C::kStatStride, &tdelta, full + s, li & ~3);
  };
  if (tid == 0 && n_iter > 0) {
    mbar_expect_tx(kv_full, 2 * C::kKVBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocksD; ++cb) {
      tma_load_4d(sK + cb * kBlockRows * 128, &tk, kv_full, cb * 64, key0, g,
                  b);
      tma_load_4d(sV + cb * kBlockRows * 128, &tv, kv_full, cb * 64, key0, g,
                  b);
    }
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

  const DkvShared sh{sK, sV, sQ, sdO, sL, sD, sL2, kv_full, full, empty};
  if constexpr (kFeat == 0) {
    dkv_range_walk<T, D, kSoftcap, C>(
        p, DenseDkvRange{p, sofs, qt_lo, n_qt, n_iter, off}, load_q, sh, tid,
        t, lane, tig, cw, wkey0, key, dk, dv);
  } else {
    DenseFeatDkvRange<kFeat, kSoftcap> r{p, sofs, qt_lo, n_qt, n_iter, off,
                                         b, g};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r.kvseg[i] = kExt && p.f.q_seg && key[i] < p.sk
                       ? p.f.kv_seg[b * p.f.kv_seg_b + key[i]]
                       : 0;
    }
    dkv_range_walk<T, D, kSoftcap, C>(p, r, load_q, sh, tid, t, lane, tig, cw,
                                      wkey0, key, dk, dv);
  }

  store_rows<T, D>(static_cast<T*>(p.dk) + b * p.dk_b + g * p.dk_h, p.dk_s,
                   key, p.sk, tig, dk);
  store_rows<T, D>(static_cast<T*>(p.dv) + b * p.dv_b + g * p.dv_h, p.dv_s,
                   key, p.sk, tig, dv);
}

inline Params make_params(int h, int hk, int sq, int sk, float scale,
                          int window_left, int window_right, float softcap) {
  Params p = {};
  p.h = h;
  p.group = h / hk;
  p.sq = sq;
  p.sk = sk;
  p.left = window_left;
  p.right = window_right;
  p.scale = scale;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * kLog2e;
  p.cap_log2 = softcap * kLog2e;
  return p;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int D, bool kSoftcap, int kFeat = 0>
int launch_dq(const CUtensorMap& tq, const CUtensorMap& tdo,
              const CUtensorMap& tk, const CUtensorMap& tv,
              const ParamsOf<kFeat>& p, int batch, cudaStream_t stream) {
  const size_t smem = DqCfg<D, kSoftcap || kFeat != 0>::kSmem;
  if (const int err =
          set_smem(bwd_dq_sm90_kernel<T, D, kSoftcap, kFeat>, smem)) {
    return err;
  }
  const dim3 grid((p.sq + kBlockRows - 1) / kBlockRows, p.h, batch);
  bwd_dq_sm90_kernel<T, D, kSoftcap, kFeat>
      <<<grid, kThreads, smem, stream>>>(tq, tdo, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kSoftcap, int kFeat = 0>
int launch_dkv(const CUtensorMap& tq, const CUtensorMap& tdo,
               const CUtensorMap& tk, const CUtensorMap& tv,
               const CUtensorMap& tlse, const CUtensorMap& tdelta,
               const ParamsOf<kFeat>& p, int batch, cudaStream_t stream) {
  const size_t smem = DkvCfg<D, kSoftcap>::kSmem;
  if (const int err =
          set_smem(bwd_dkv_sm90_kernel<T, D, kSoftcap, kFeat>, smem)) {
    return err;
  }
  const dim3 grid((p.sk + kBlockRows - 1) / kBlockRows, p.h / p.group, batch);
  bwd_dkv_sm90_kernel<T, D, kSoftcap, kFeat>
      <<<grid, kThreads, smem, stream>>>(tq, tdo, tk, tv, tlse, tdelta, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq_softcap(const CUtensorMap& tq, const CUtensorMap& tdo,
                      const CUtensorMap& tk, const CUtensorMap& tv,
                      const Params& p, bool softcap, int batch,
                      cudaStream_t stream) {
  return softcap ? launch_dq<T, D, true>(tq, tdo, tk, tv, p, batch, stream)
                 : launch_dq<T, D, false>(tq, tdo, tk, tv, p, batch, stream);
}

template <typename T, int D>
int launch_dkv_softcap(const CUtensorMap& tq, const CUtensorMap& tdo,
                       const CUtensorMap& tk, const CUtensorMap& tv,
                       const CUtensorMap& tlse, const CUtensorMap& tdelta,
                       const Params& p, bool softcap, int batch,
                       cudaStream_t stream) {
  return softcap ? launch_dkv<T, D, true>(tq, tdo, tk, tv, tlse, tdelta, p,
                                          batch, stream)
                 : launch_dkv<T, D, false>(tq, tdo, tk, tv, tlse, tdelta, p,
                                           batch, stream);
}

// The instances with features: kFeat 1-3 (kFeatExt | kFeatDrop), softcap
// or not. Return -3 for kFeat 0, which launch_dq_softcap and
// launch_dkv_softcap take.
template <typename T, int D>
int launch_dq_features(const CUtensorMap& tq, const CUtensorMap& tdo,
                       const CUtensorMap& tk, const CUtensorMap& tv,
                       const FeatParams& p, bool softcap, int feat, int batch,
                       cudaStream_t s) {
  switch (feat + 4 * softcap) {
    case 1: return launch_dq<T, D, false, 1>(tq, tdo, tk, tv, p, batch, s);
    case 2: return launch_dq<T, D, false, 2>(tq, tdo, tk, tv, p, batch, s);
    case 3: return launch_dq<T, D, false, 3>(tq, tdo, tk, tv, p, batch, s);
    case 5: return launch_dq<T, D, true, 1>(tq, tdo, tk, tv, p, batch, s);
    case 6: return launch_dq<T, D, true, 2>(tq, tdo, tk, tv, p, batch, s);
    case 7: return launch_dq<T, D, true, 3>(tq, tdo, tk, tv, p, batch, s);
    default: return -3;
  }
}

template <typename T, int D>
int launch_dkv_features(const CUtensorMap& tq, const CUtensorMap& tdo,
                        const CUtensorMap& tk, const CUtensorMap& tv,
                        const CUtensorMap& tl, const CUtensorMap& td,
                        const FeatParams& p, bool softcap, int feat,
                        int batch, cudaStream_t s) {
  switch (feat + 4 * softcap) {
    case 1:
      return launch_dkv<T, D, false, 1>(tq, tdo, tk, tv, tl, td, p, batch, s);
    case 2:
      return launch_dkv<T, D, false, 2>(tq, tdo, tk, tv, tl, td, p, batch, s);
    case 3:
      return launch_dkv<T, D, false, 3>(tq, tdo, tk, tv, tl, td, p, batch, s);
    case 5:
      return launch_dkv<T, D, true, 1>(tq, tdo, tk, tv, tl, td, p, batch, s);
    case 6:
      return launch_dkv<T, D, true, 2>(tq, tdo, tk, tv, tl, td, p, batch, s);
    case 7:
      return launch_dkv<T, D, true, 3>(tq, tdo, tk, tv, tl, td, p, batch, s);
    default:
      return -3;
  }
}

}  // namespace bwd90
}  // namespace fa
