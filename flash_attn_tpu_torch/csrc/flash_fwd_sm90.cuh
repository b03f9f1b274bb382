// Dense flash-attention forward for Hopper (kernel 1): out =
// softmax(scale * Q K^T [masked]) V and the fp32 log-sum-exp of every query
// row, for q (b, h, sq, d) and k, v (b, hk, sk, d) read through their
// strides.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_fwd.py:95
// (_fwd_kernel, launched at :930 by flash_attention_fwd :540), restricted to
// the features the training path uses: scale, bottom-right-aligned causal,
// sliding window (left, right), GQA/MQA, softcap, head dim 64 or 128,
// bf16/fp16. Query row i of head hq sees key column j of kv head
// hq / (h / hk) iff j < sk and, with diag = i + sk - sq, j >= diag - left
// (left >= 0) and j <= diag + right (right >= 0). Scores are s * scale, or
// tanh(s * scale / softcap) * softcap; online softmax in fp32 (base 2);
// out = acc / l in q's type, lse = m + ln(l) in fp32, natural log; a row
// that sees no column gives out 0 and lse -inf.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * d flops per
// visible (query head, row, column) triple against q, k, v and out moved
// once; at the training shape (s 2048, d 64, causal) ~300 flops per byte,
// at the card's ridge, so it is bound by the tensor cores.
//
// Design. One block per (64 x consumers query rows, query head, batch row),
// the blocks of the last rows (the longest causal rows) first:
//  * a producer warpgroup, whose registers setmaxnreg lowers to 24: one
//    thread loads Q once and then every visible 128-key K and V tile by TMA
//    (4-D tensor maps over (d, s, h, b) built from the caller's strides, so
//    a (b, s, h, d) tensor viewed as (b, h, s, d) needs no copy) into a ring
//    of kStages stages, each with "full" barriers for K and V and "empty"
//    ones the consumers release (K once S is done, V once P V is);
//  * consumer warpgroups, 64 query rows each (wgmma's M): two at d 128
//    (registers raised to 240), three at d 64 (160), where the exponentials
//    weigh most against the products. S = Q K^T is wgmma m64n128k16 with both operands read
//    from shared memory through descriptors; the online softmax runs on the
//    S accumulators (two rows per thread, reduced over the quad), with the
//    mask applied only on tiles that cross the diagonal, a window edge or
//    the end of the keys (TMA fills keys past sk with zeros, which would
//    score 0, not -inf); P, packed to 16 bits, is the register A operand of
//    O += P V (wgmma m64nDk16), whose B operand V is read N-major through
//    the transpose flag, so V needs no transposing copy. Each warpgroup
//    pipelines its walk: it issues S of tile i and P V of tile i - 1, then
//    runs tile i's softmax while the tensor cores do that P V. The
//    warpgroups take turns to issue (named barriers in a ring), so one's
//    products run while the others do their softmax.
// Every tile uses the 128-byte swizzle (csrc/sm90_utils.cuh). The consumer
// warpgroups share each K/V tile, so a tile copied serves 128 or 192 query
// rows. The epilogue stages O / l through the warpgroup's own
// rows of the Q tile and writes each row with 16-byte stores.
//
// Tried and dropped: exponentials through fp16x2 (half the MUFU work) ran
// 4% slower at d 64 and moved the LSE by up to 6e-4. Not done yet: TMA
// stores, persistent blocks.
//
// Features (csrc/attn_features.cuh), in instances of their own (kFeat !=
// 0; launched from csrc/flash_fwd_features.cu), so that the feature-free
// ones compile as before: ALiBi, segment ids, attention_chunk, sink tokens
// and the learnable sink (kFeatExt), dropout (kFeatDrop). An extended
// instance walks key_tiles' sequence (the tiles of the sink tokens, then
// the window's range narrowed to the rows' chunks), scales the scores to
// base 2 before the max (ALiBi subtracts its term there), and masks every
// tile that some rule cuts (with segment ids, every tile). Dropout keeps
// m and l of the undropped P, zeroes the dropped P before P V, and scales
// out by 1 / (1 - p). These instances are right, not tuned: each rule is
// a runtime test inside them.

#pragma once

#include <type_traits>

#include "attn_features.cuh"
#include "mma_utils.cuh"
#include "sm90_utils.cuh"

namespace fa {
namespace fwd90 {

using namespace fa::sm90;

constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kProducerRegs = 24;
// Named barriers: 1 + w, the epilogue of consumer warpgroup w; kTurnBarrier
// + w, its turn to issue wgmma (0 is __syncthreads').
constexpr int kTurnBarrier = 4;

// Query rows per block: 64 per consumer warpgroup, three at d = 64 (a third
// warpgroup's softmax hides behind the other two's wgmma), two at d = 128
// (whose accumulators need the registers).
// The extended feature instances at d = 64 spill 300-550 bytes at three,
// but two (no spill) ran 1.15-1.17x slower in two of three cases.
__host__ __device__ constexpr int block_m(int d) { return d == 64 ? 192 : 128; }

template <int D>
struct Cfg {
  static constexpr int kConsumers = block_m(D) / 64;
  static constexpr int kBlockM = block_m(D);
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // What setmaxnreg gives each consumer thread: the register file less the
  // producer's share, over the consumers (a multiple of 8).
  static constexpr int kConsumerRegs =
      (65536 / 128 - kProducerRegs) / kConsumers / 8 * 8;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;  // one K or V tile
  static constexpr int kBarriers = 1 + 4 * kStages;
  // 1024 bytes of slack to align the tiles for the swizzle.
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * kBarriers;
};

struct Params {
  void* out;   // (b, h, sq, d) through o_b, o_h, o_s (multiples of 8)
  float* lse;  // (b, h, sq) contiguous
  long long o_b, o_h, o_s;
  int h, group, sq, sk;
  int left, right;  // normalised window; negative = unbounded
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2
  // with a softcap (score_mul = scale / softcap, cap_log2 = softcap*log2 e).
  float score_mul, cap_log2;
};

// The parameters of an instance with features.
struct FeatParams : Params {
  Features f;
};

template <int kFeat>
using ParamsOf = std::conditional_t<kFeat == 0, Params, FeatParams>;

template <typename T, int D, bool kSoftcap, int kFeat = 0>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const ParamsOf<kFeat> p) {
  constexpr bool kExt = (kFeat & kFeatExt) != 0;
  constexpr bool kDrop = (kFeat & kFeatDrop) != 0;
  using C = Cfg<D>;
  constexpr int kStages = C::kStages;
  constexpr int kBlockM = C::kBlockM;
  constexpr int kBlocksD = D / 64;  // 128-byte column blocks of a row
  extern __shared__ unsigned char smem_sm90[];
  unsigned char* sQ =
      smem_sm90 + ((1024 - (smem_u32(smem_sm90) & 1023)) & 1023);
  unsigned char* sK = sQ + C::kQBytes;
  unsigned char* sV = sK + kStages * C::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * C::kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int off = p.sk - p.sq;
  const int row_last = min(row0 + kBlockM, p.sq) - 1;
  const int col_lo = p.left >= 0 ? max(row0 + off - p.left, 0) : 0;
  const int col_hi =
      p.right >= 0 ? min(row_last + off + p.right, p.sk - 1) : p.sk - 1;
  const int tile_lo = col_lo / kBlockN;
  const int n_range = col_hi >= col_lo ? col_hi / kBlockN - tile_lo + 1 : 0;
  // An extended instance walks key_tiles' sequence instead.
  KeyTiles kt = {};
  if constexpr (kExt) {
    kt = key_tiles(row0, row_last, off, p.left, p.right, p.sk, kBlockN, p.f);
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
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0 && n_tiles > 0) {
      const int g = head / p.group;
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int cb = 0; cb < kBlocksD; ++cb) {
        tma_load_4d(sQ + cb * kBlockM * 128, &tq, q_full, cb * 64, row0, head,
                    b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int parity = ((it / kStages) & 1) ^ 1;
        const int key0 = tile_of(it) * kBlockN;
        mbar_wait(k_empty + s, parity);
        mbar_expect_tx(k_full + s, C::kTileBytes);
#pragma unroll
        for (int cb = 0; cb < kBlocksD; ++cb) {
          tma_load_4d(sK + s * C::kTileBytes + cb * kBlockN * 128, &tk,
                      k_full + s, cb * 64, key0, g, b);
        }
        mbar_wait(v_empty + s, parity);
        mbar_expect_tx(v_full + s, C::kTileBytes);
#pragma unroll
        for (int cb = 0; cb < kBlocksD; ++cb) {
          tma_load_4d(sV + s * C::kTileBytes + cb * kBlockN * 128, &tv,
                      v_full + s, cb * 64, key0, g, b);
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
      row_ok[i] = r < p.sq;
      diag[i] = r + off;
    }
    // Features: this thread's rows' dropout hash parts, segment ids and
    // the head's ALiBi slope in base 2.
    uint32_t drop_row[2];
    int qseg[2];
    float slope2 = 0.f;
    if constexpr (kDrop) {
      const uint32_t base = dropout_base(p.f.seed, b, head);
#pragma unroll
      for (int i = 0; i < 2; ++i) drop_row[i] = dropout_row(base, diag[i] - off);
    }
    if constexpr (kExt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qseg[i] = p.f.q_seg && row_ok[i]
                      ? p.f.q_seg[b * p.f.q_seg_b + diag[i] - off]
                      : 0;
      }
      if (p.f.slopes) slope2 = p.f.slopes[b * p.f.slope_b + head] * kLog2e;
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
        if constexpr (D == 64) {
          Wgmma<T>::rs_n64(o, pa[kk], vd, 1);
        } else {
          Wgmma<T>::rs_n128(o, pa[kk], vd, 1);
        }
      }
      wgmma_commit();
    };
    auto release = [&](uint64_t* bars, int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + it % kStages);
    };
    // Softcap, mask (only on a tile some row sees in part), scale (base 2)
    // and the online softmax of tile `it`: sc becomes P, and alpha the
    // factor O must be rescaled by.
    auto softmax = [&](float (&sc)[64], int it, float (&alpha)[2]) {
      const int col0 = tile_of(it) * kBlockN;
      const bool full =
          wrow0 + 64 <= p.sq && col0 + kBlockN <= p.sk &&
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
        const bool ext_full =
            full && !p.f.q_seg &&
            chunk_full(col0, col0 + kBlockN - 1, wrow0 + off,
                       wrow0 + 63 + off, p.f);
        if (!ext_full) {
          const int* kvs = p.f.kv_seg + b * p.f.kv_seg_b;
#pragma unroll
          for (int x = 0; x < 64; ++x) {
            const int i = (x >> 1) & 1;
            const int col = col0 + (x >> 2) * 8 + tig * 2 + (x & 1);
            if (!(row_ok[i] && col < p.sk &&
                  visible_ext(col, diag[i], p.left, p.right, p.f) &&
                  (!p.f.q_seg || qseg[i] == kvs[col]))) {
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
          if (!(row_ok[i] && col < p.sk &&
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
          // m and l take the undropped P; P V the kept entries.
          const int col = col0 + (x >> 2) * 8 + tig * 2 + (x & 1);
          sc[x] = dropout_keep(drop_row[i], col, p.f.keep_threshold) ? pe : 0.f;
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

    // The consumer warpgroups take turns to issue their wgmma, in a ring:
    // warpgroup cw waits on barrier kTurnBarrier + cw, issues, and lets the
    // next one go. The products of one warpgroup then run while the others
    // do their softmax, instead of all of them contending at once. The
    // last warpgroup hands warpgroup 0 its first turn.
    auto turn_begin = [&] { named_barrier(kTurnBarrier + cw, 256); };
    auto turn_end = [&] {
      named_arrive(kTurnBarrier + (cw + 1) % C::kConsumers, 256);
    };
    if (n_tiles > 0 && cw == C::kConsumers - 1) named_arrive(kTurnBarrier, 256);

    if (n_tiles > 0 && wrow0 >= p.sq) {
      // No rows here (the last block's tail): take the turns and release
      // the tiles.
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
    // as Q was), then every row out with 16-byte stores.
    float lsum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) lsum[i] = quad_sum(l[i]);
    named_barrier(1 + cw, 128);  // the warpgroup is done reading Q
    unsigned char* so = sQ + cw * 64 * 128;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + gid + 8 * i;
      float inv = lsum[i] > 0.f ? 1.f / lsum[i] : 0.f;
      float lse_ext = 0.f;
      if constexpr (kExt) {
        const bool has_sink = p.f.sink != nullptr;
        inv = finalize_row(m[i], lsum[i], has_sink,
                           has_sink ? p.f.sink[head] * kLog2e : 0.f, lse_ext);
      }
      if constexpr (kDrop) inv *= p.f.keep_scale;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int chunk = (j & 7) ^ (r & 7);
        *reinterpret_cast<uint32_t*>(so + (j >> 3) * kBlockM * 128 + r * 128 +
                                     chunk * 16 + tig * 4) =
            Mma<T>::pack(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
      const int row = wrow0 + r;
      if (tig == 0 && row_ok[i]) {
        p.lse[(static_cast<long long>(b) * p.h + head) * p.sq + row] =
            kExt ? lse_ext
                 : lsum[i] > 0.f ? (m[i] + log2f(lsum[i])) * kLn2 : -INFINITY;
      }
    }
    named_barrier(1 + cw, 128);
    T* out = static_cast<T*>(p.out) + b * p.o_b + head * p.o_h;
    constexpr int kChunks = D / 8;  // 16-byte chunks of a row
#pragma unroll
    for (int idx = t; idx < 64 * kChunks; idx += 128) {
      const int r = idx / kChunks;
      const int j = idx % kChunks;
      const int row = wrow0 + r;
      if (row < p.sq) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            so + (j >> 3) * kBlockM * 128 + r * 128 + (((j & 7) ^ (r & 7)) * 16));
        *reinterpret_cast<uint4*>(out + row * p.o_s + j * 8) = val;
      }
    }
  }
}

template <typename T, int D, bool kSoftcap, int kFeat = 0>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const ParamsOf<kFeat>& p, int batch, cudaStream_t stream) {
  const size_t smem = Cfg<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_sm90_kernel<T, D, kSoftcap, kFeat>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBlockM = Cfg<D>::kBlockM;
  const dim3 grid((p.sq + kBlockM - 1) / kBlockM, p.h, batch);
  fwd_sm90_kernel<T, D, kSoftcap, kFeat>
      <<<grid, Cfg<D>::kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_softcap(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Params& p, bool softcap,
                   int batch, cudaStream_t stream) {
  return softcap ? launch<T, D, true>(tq, tk, tv, p, batch, stream)
                 : launch<T, D, false>(tq, tk, tv, p, batch, stream);
}

// An instance with features: kFeat 1-3 (kFeatExt | kFeatDrop), softcap or
// not. Returns -3 for kFeat 0, which launch_softcap takes.
template <typename T, int D>
int launch_features(const CUtensorMap& tq, const CUtensorMap& tk,
                    const CUtensorMap& tv, const FeatParams& p, bool softcap,
                    int feat, int batch, cudaStream_t stream) {
  switch (feat + 4 * softcap) {
    case 1: return launch<T, D, false, 1>(tq, tk, tv, p, batch, stream);
    case 2: return launch<T, D, false, 2>(tq, tk, tv, p, batch, stream);
    case 3: return launch<T, D, false, 3>(tq, tk, tv, p, batch, stream);
    case 5: return launch<T, D, true, 1>(tq, tk, tv, p, batch, stream);
    case 6: return launch<T, D, true, 2>(tq, tk, tv, p, batch, stream);
    case 7: return launch<T, D, true, 3>(tq, tk, tv, p, batch, stream);
    default: return -3;
  }
}

}  // namespace fwd90
}  // namespace fa
