// Block-sparse attention backward: kernel 11 (dQ and delta, Q-stationary,
// over the forward's lists) and kernel 10 (dK/dV, KV-stationary, over the
// inverse lists), from Q, K, V, dO and the forward's log-sum-exp.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/block_sparsity.py:906
// (_bs_dq_kernel, launched at :1169) and :807 (_bs_dkv_kernel, launched at
// :1094), both by flash_attention_blocksparse_bwd :996, restricted to the
// forward's features (csrc/block_sparse_fwd.cu): mask_mod plans, scale,
// softcap, GQA/MQA, head dim 64 or 128, bf16/fp16. The TPU schedule
// (transposed host worklists with chain flags, per-query-head dK/dV
// temporaries and their reshape-sums, delta from rowsum(dO * O)) is not
// carried over.
//
// Function. With the kept elements of csrc/block_sparse_fwd.cu and s =
// q . k: t = tanh(s * scale / softcap) (softcap only); P = exp(s * scale -
// lse) or exp(t * softcap - lse), 0 where not kept or where lse = -inf;
// dP = dO . v; delta = sum_j P dP per query row; dS = P (dP - delta) scale
// [(1 - t^2) with softcap]; dV = sum P^T dO, dK = sum dS^T Q (summed over
// each kv head's group of query heads), dQ = sum dS K. delta is computed
// exactly in fp32 by the dQ kernel, in a first pass over its tiles, and
// written for the dK/dV kernel (the port's rule, ROADMAP "delta"; the JAX
// code takes rowsum(dO * O)). Every row of dq and delta, and every key row
// of dk and dv, is written.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): per kept
// (query head, row, column) triple, dK/dV 8 * d flops (S, dP, dV, dK), dQ
// 6 * d (S, dP, dQ), against each kernel's inputs read and outputs written
// once; the larger of the two.
//
// Design (simple first), the dense backward's tile steps
// (csrc/flash_bwd_tile.cuh) written out on their own. Deterministic: no
// atomics; every output element is summed by one thread in a fixed order.
//  * dQ: one block of 4 warps per (64 query rows, query head, batch row);
//    Q and dO in registers as A fragments; the block walks its listed key
//    tiles twice (K and V double-buffered), the first pass summing delta,
//    the second accumulating dQ in fp32 registers. Each thread reads its
//    two rows' words per tile.
//  * dK/dV: one block of 4 warps per (64 key rows, kv head, batch row); K
//    and V stay in shared memory; the block walks, for each query head of
//    the group in turn, that head's inverse list of 64-row blocks, with Q,
//    dO, lse, delta and the rows' words double-buffered; dK and dV
//    accumulate in fp32 registers and are written once.
// At head dim 128 the walked tiles are 32 wide (two halves of a 64-wide
// sub-tile, each with its half of the words) to keep the accumulators in
// registers.

#include "block_sparse.cuh"

namespace {

using namespace fa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = bs::kSub;  // key rows (dK/dV) or query rows (dQ)

template <int D>
struct Tiles {
  static constexpr int kInner = D == 64 ? 64 : 32;  // walked tile width
};

struct Params {
  const void* q;     // (b, h, sq, d)
  const void* k;     // (b, hk, sk, d)
  const void* v;     // (b, hk, sk, d)
  const void* dout;  // (b, h, sq, d)
  const float* lse;  // (b, h, sq), natural log
  float* delta;      // (b, h, sq): written by dQ, read by dK/dV
  void* dq;          // (b, h, sq, d)
  void* dk;          // (b, hk, sk, d)
  void* dv;          // (b, hk, sk, d)
  // Element strides (batch, head, seq).
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, do_b, do_h, do_s;
  long long dq_b, dq_h, dq_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  int h, group, sq, sk, nqb, nkb;
  float scale;
  // Score in base 2 as in the forward.
  float score_mul, cap_log2;
  // dQ: the forward's lists, per (b, head, 64-row block) at row
  // (b * h + head) * nqb + block. dK/dV: the inverse lists, per (b, query
  // head, 64-key block) at row (b * h + head) * nkb + block. list_len
  // entries a row, counts[row] used.
  const int* counts;
  const int* entries;
  const int* wofs;
  const unsigned long long* words;
  long long list_len;
};

// P of one score s given its row's lse (base 2), and the factor d(score)
// / d(s) that dS carries (scale, times 1 - t^2 under a softcap).
template <bool kSoftcap>
__device__ __forceinline__ float prob_of(const Params& p, float s, float lse2,
                                         bool ok, float& dmul) {
  float x;
  if (kSoftcap) {
    const float t = tanhf(s * p.score_mul);
    x = t * p.cap_log2;
    dmul = (1.f - t * t) * p.scale;
  } else {
    x = s * p.score_mul;
    dmul = p.scale;
  }
  return ok ? exp2f(x - lse2) : 0.f;
}

template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* base,
                                          long long row_stride, int first,
                                          int rows, int limit, int tid) {
  // rows x D elements from rows first.. of a strided tensor into a padded
  // smem tile; rows at or past `limit` are zero-filled.
  constexpr int kChunks = D / 8;
  for (int c = tid; c < rows * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int part = c % kChunks;
    const int r = first + row;
    const long long src = static_cast<long long>(max(min(r, limit - 1), 0));
    cp_async_16(dst + row * (D + 8) + part * 8,
                base + src * row_stride + part * 8, r < limit ? 16 : 0);
  }
}

template <typename T, int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads) block_sparse_dq_kernel(
    const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kBN = Tiles<D>::kInner;
  constexpr int kSub = kTileRows / kBN;  // walked tiles per listed sub-tile
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kNTiles = kBN / 8;
  constexpr int kDTiles = D / 8;
  constexpr unsigned long long kAll = ~0ull >> (64 - kBN);
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][kBN][kStride]
  T* sV = sK + 2 * kBN * kStride;          // [2][kBN][kStride]

  const int m_block = blockIdx.x;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int g = head / p.group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int row0 = m_block * kTileRows;

  const long long lrow =
      (static_cast<long long>(b) * p.h + head) * p.nqb + m_block;
  const long long lbase = lrow * p.list_len;
  const int n_tiles = p.counts[lrow] * kSub;
  // Walked tile x: half x % kSub of the (x / kSub)-th listed sub-tile.
  auto tile_at = [&](int x) {
    return (__ldg(p.entries + lbase + x / kSub) >> 2) * kSub + x % kSub;
  };

  int r_local[2], row[2];
  bool row_ok[2];
  float lse2[2];
  float dlt[2] = {0.f, 0.f};   // delta, summed in the first pass
  float dsum[2] = {0.f, 0.f};  // this thread's partial sums of P * dP
  long long li[2];
  const T* qrow[2];
  const T* dorow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r_local[i] = warp * 16 + gid + 8 * i;
    row[i] = row0 + r_local[i];
    row_ok[i] = row[i] < p.sq;
    qrow[i] = static_cast<const T*>(p.q) + b * p.q_b + head * p.q_h +
              static_cast<long long>(row[i]) * p.q_s;
    dorow[i] = static_cast<const T*>(p.dout) + b * p.do_b + head * p.do_h +
               static_cast<long long>(row[i]) * p.do_s;
    li[i] = (static_cast<long long>(b) * p.h + head) * p.sq + row[i];
    lse2[i] = row_ok[i] ? p.lse[li[i]] * kLog2e : -INFINITY;
  }

  uint32_t qf[kKSteps][4];
  uint32_t df[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = ks * 16 + tig * 2 + (j >> 1) * 8;
      qf[ks][j] = row_ok[j & 1] ? ld_u32(qrow[j & 1] + col) : 0u;
      df[ks][j] = row_ok[j & 1] ? ld_u32(dorow[j & 1] + col) : 0u;
    }
  }

  float dq[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt) {
    dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;
  }

  const T* kbase = static_cast<const T*>(p.k) + b * p.k_b + g * p.k_h;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_b + g * p.v_h;
  auto load_tile = [&](int tile, int stage) {
    load_rows<T, D>(sK + stage * kBN * kStride, kbase, p.k_s, tile * kBN, kBN,
                    p.sk, tid);
    load_rows<T, D>(sV + stage * kBN * kStride, vbase, p.v_s, tile * kBN, kBN,
                    p.sk, tid);
  };

  // Two passes over the walked tiles: iterations [0, n_tiles) sum delta,
  // [n_tiles, 2 n_tiles) accumulate dQ; the copies run on across the
  // boundary.
  const int n_iter = 2 * n_tiles;
  if (n_iter > 0) load_tile(tile_at(0), 0);
  cp_async_commit();

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iter) load_tile(tile_at((it + 1) % n_tiles), stage ^ 1);
    cp_async_commit();
    const int x = it % n_tiles;
    const int ent = __ldg(p.entries + lbase + x / kSub);
    const int col0 = (ent >> 2) * kTileRows;
    unsigned long long w[2];  // this half's bits, bit c for column c
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      w[i] = (bs::row_word(ent & 3, __ldg(p.wofs + lbase + x / kSub), row[i],
                           r_local[i], col0, p.sq, p.sk, p.words) >>
              ((x % kSub) * kBN)) & kAll;
    }
    cp_async_wait_1();
    __syncthreads();
    if (it == n_tiles) {
#pragma unroll
      for (int i = 0; i < 2; ++i) dlt[i] = quad_sum(dsum[i]);
    }

    const T* k_t = sK + stage * kBN * kStride;
    const T* v_t = sV + stage * kBN * kStride;

    // S = Q K^T and dP = dO V^T of this warp's 16 rows.
    float s[kNTiles][4];
    float dp[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      const T* krow = k_t + (nt * 8 + gid) * kStride + tig * 2;
      const T* vrow = v_t + (nt * 8 + gid) * kStride + tig * 2;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        Mma<T>::run(s[nt], qf[ks], ld_u32(krow + ks * 16),
                    ld_u32(krow + ks * 16 + 8));
        Mma<T>::run(dp[nt], df[ks], ld_u32(vrow + ks * 16),
                    ld_u32(vrow + ks * 16 + 8));
      }
    }
    auto kept = [&](int nt, int e) {
      const int c = nt * 8 + tig * 2 + (e & 1);
      return ((w[e >> 1] >> c) & 1ull) && lse2[e >> 1] > -INFINITY;
    };

    // The two passes are separate branches around whole tiles, so neither
    // pays for the other's arithmetic.
    if (it < n_tiles) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dmul;
          dsum[e >> 1] += prob_of<kSoftcap>(p, s[nt][e], lse2[e >> 1],
                                            kept(nt, e), dmul) * dp[nt][e];
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dmul;
          const float prob = prob_of<kSoftcap>(p, s[nt][e], lse2[e >> 1],
                                               kept(nt, e), dmul);
          s[nt][e] = prob * (dp[nt][e] - dlt[e >> 1]) * dmul;
        }
      }
      // dQ += dS K (dS already carries the scale).
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t a[4] = {Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                               Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                               Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const T* kr = k_t + (kk * 16 + tig * 2) * kStride + gid;
#pragma unroll
        for (int nt = 0; nt < kDTiles; ++nt) {
          const T* kc = kr + nt * 8;
          Mma<T>::run(dq[nt], a, pack_u16(kc, kc + kStride),
                      pack_u16(kc + 8 * kStride, kc + 9 * kStride));
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row_ok[i] && tig == 0) p.delta[li[i]] = dlt[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    T* dqr = static_cast<T*>(p.dq) + b * p.dq_b + head * p.dq_h +
             static_cast<long long>(row[i]) * p.dq_s;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      *reinterpret_cast<uint32_t*>(dqr + nt * 8 + tig * 2) =
          Mma<T>::pack(dq[nt][2 * i], dq[nt][2 * i + 1]);
    }
  }
}

template <typename T, int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads) block_sparse_dkv_kernel(
    const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kBQ = Tiles<D>::kInner;
  constexpr int kSub = kTileRows / kBQ;  // walked tiles per listed sub-block
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kQTiles = kBQ / 8;
  constexpr int kDTiles = D / 8;
  T* sK = reinterpret_cast<T*>(smem_raw);  // [kTileRows][kStride]
  T* sV = sK + kTileRows * kStride;        // [kTileRows][kStride]
  T* sQ = sV + kTileRows * kStride;        // [2][kBQ][kStride]
  T* sdO = sQ + 2 * kBQ * kStride;         // [2][kBQ][kStride]
  float* sL = reinterpret_cast<float*>(sdO + 2 * kBQ * kStride);  // [2][kBQ]
  float* sD = sL + 2 * kBQ;                                       // [2][kBQ]
  // [2][kBQ] row words, 8-byte aligned after the 4 float rows.
  unsigned long long* sW = reinterpret_cast<unsigned long long*>(sD + 2 * kBQ);

  const int n_block = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int col0 = n_block * kTileRows;

  // The walk: for each query head of the group, its inverse list's
  // sub-blocks, each as kSub walked tiles. A cursor (head in group j,
  // entry e) names a sub-block; iteration `it` walks half it % kSub of the
  // sub-block the load cursor held when that iteration's tiles were
  // loaded (everything the step needs is in shared memory).
  auto list_row = [&](int j) {
    return ((static_cast<long long>(b) * p.h + g * p.group + j) * p.nkb +
            n_block);
  };
  auto count_of = [&](int j) { return __ldg(p.counts + list_row(j)); };
  int n_iter = 0;
  for (int j = 0; j < p.group; ++j) n_iter += count_of(j) * kSub;
  struct Cursor {
    int j, e;
  };
  auto settle = [&](Cursor c) {  // skip heads whose list is used up
    while (c.j < p.group && c.e >= count_of(c.j)) {
      ++c.j;
      c.e = 0;
    }
    return c;
  };

  int kv_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kv_row[i] = warp * 16 + gid + 8 * i;  // - col0

  auto load_q = [&](Cursor c, int half, int stage) {
    const int head = g * p.group + c.j;
    const long long at = list_row(c.j) * p.list_len + c.e;
    const int ent = __ldg(p.entries + at);
    const int row_base = (ent >> 2) * kTileRows + half * kBQ;
    load_rows<T, D>(sQ + stage * kBQ * kStride,
                    static_cast<const T*>(p.q) + b * p.q_b + head * p.q_h,
                    p.q_s, row_base, kBQ, p.sq, tid);
    load_rows<T, D>(sdO + stage * kBQ * kStride,
                    static_cast<const T*>(p.dout) + b * p.do_b + head * p.do_h,
                    p.do_s, row_base, kBQ, p.sq, tid);
    if (tid < kBQ) {
      const int r = row_base + tid;
      const long long li = (static_cast<long long>(b) * p.h + head) * p.sq + r;
      sL[stage * kBQ + tid] = r < p.sq ? p.lse[li] * kLog2e : -INFINITY;
      sD[stage * kBQ + tid] = r < p.sq ? p.delta[li] : 0.f;
      sW[stage * kBQ + tid] = bs::row_word(ent & 3, __ldg(p.wofs + at), r,
                                           half * kBQ + tid, col0, p.sq, p.sk,
                                           p.words);
    }
  };

  Cursor nxt = settle(Cursor{0, 0});
  if (n_iter > 0) {
    load_rows<T, D>(sK, static_cast<const T*>(p.k) + b * p.k_b + g * p.k_h,
                    p.k_s, col0, kTileRows, p.sk, tid);
    load_rows<T, D>(sV, static_cast<const T*>(p.v) + b * p.v_b + g * p.v_h,
                    p.v_s, col0, kTileRows, p.sk, tid);
    load_q(nxt, 0, 0);
  }
  cp_async_commit();

  float dk[kDTiles][4];
  float dv[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
  }

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iter) {
      const int half = (it + 1) % kSub;
      if (half == 0) nxt = settle(Cursor{nxt.j, nxt.e + 1});
      load_q(nxt, half, stage ^ 1);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const T* q_t = sQ + stage * kBQ * kStride;
    const T* do_t = sdO + stage * kBQ * kStride;
    const float* lse2 = sL + stage * kBQ;
    const float* dlt = sD + stage * kBQ;
    const unsigned long long* wrow = sW + stage * kBQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows.
    float st[kQTiles][4];
    float dpt[kQTiles][4];
#pragma unroll
    for (int nt = 0; nt < kQTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    }
    const T* krow = sK + (warp * 16 + gid) * kStride + tig * 2;
    const T* vrow = sV + (warp * 16 + gid) * kStride + tig * 2;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const uint32_t ak[4] = {
          ld_u32(krow + ks * 16), ld_u32(krow + 8 * kStride + ks * 16),
          ld_u32(krow + ks * 16 + 8), ld_u32(krow + 8 * kStride + ks * 16 + 8)};
      const uint32_t av[4] = {
          ld_u32(vrow + ks * 16), ld_u32(vrow + 8 * kStride + ks * 16),
          ld_u32(vrow + ks * 16 + 8), ld_u32(vrow + 8 * kStride + ks * 16 + 8)};
#pragma unroll
      for (int nt = 0; nt < kQTiles; ++nt) {
        const T* qr = q_t + (nt * 8 + gid) * kStride + ks * 16 + tig * 2;
        const T* dr = do_t + (nt * 8 + gid) * kStride + ks * 16 + tig * 2;
        Mma<T>::run(st[nt], ak, ld_u32(qr), ld_u32(qr + 8));
        Mma<T>::run(dpt[nt], av, ld_u32(dr), ld_u32(dr + 8));
      }
    }

    // P^T and dS^T in place (st <- P^T, dpt <- dS^T).
#pragma unroll
    for (int nt = 0; nt < kQTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + tig * 2 + (e & 1);
        const bool ok = ((wrow[qi] >> kv_row[e >> 1]) & 1ull) &&
                        lse2[qi] > -INFINITY;
        float dmul;
        const float prob = prob_of<kSoftcap>(p, st[nt][e], lse2[qi], ok, dmul);
        st[nt][e] = prob;
        dpt[nt][e] = prob * (dpt[nt][e] - dlt[qi]) * dmul;
      }
    }

    // dV += P^T dO and dK += dS^T Q (dS already carries the scale).
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      const uint32_t ap[4] = {Mma<T>::pack(st[2 * kk][0], st[2 * kk][1]),
                              Mma<T>::pack(st[2 * kk][2], st[2 * kk][3]),
                              Mma<T>::pack(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              Mma<T>::pack(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t ad[4] = {Mma<T>::pack(dpt[2 * kk][0], dpt[2 * kk][1]),
                              Mma<T>::pack(dpt[2 * kk][2], dpt[2 * kk][3]),
                              Mma<T>::pack(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              Mma<T>::pack(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
      const T* dor = do_t + (kk * 16 + tig * 2) * kStride + gid;
      const T* qr = q_t + (kk * 16 + tig * 2) * kStride + gid;
#pragma unroll
      for (int nt = 0; nt < kDTiles; ++nt) {
        const T* dc = dor + nt * 8;
        const T* qc = qr + nt * 8;
        Mma<T>::run(dv[nt], ap, pack_u16(dc, dc + kStride),
                    pack_u16(dc + 8 * kStride, dc + 9 * kStride));
        Mma<T>::run(dk[nt], ad, pack_u16(qc, qc + kStride),
                    pack_u16(qc + 8 * kStride, qc + 9 * kStride));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = col0 + kv_row[i];
    if (j >= p.sk) continue;
    T* dkr = static_cast<T*>(p.dk) + b * p.dk_b + g * p.dk_h +
             static_cast<long long>(j) * p.dk_s;
    T* dvr = static_cast<T*>(p.dv) + b * p.dv_b + g * p.dv_h +
             static_cast<long long>(j) * p.dv_s;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      *reinterpret_cast<uint32_t*>(dkr + nt * 8 + tig * 2) =
          Mma<T>::pack(dk[nt][2 * i], dk[nt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvr + nt * 8 + tig * 2) =
          Mma<T>::pack(dv[nt][2 * i], dv[nt][2 * i + 1]);
    }
  }
}

template <bool kDkv, typename T, int D, bool kSoftcap>
int launch(const Params& p, int n_blocks, int heads, int batch,
           cudaStream_t stream) {
  constexpr int kInner = Tiles<D>::kInner;
  const size_t smem =
      kDkv ? (2 * kTileRows + 4 * kInner) * (D + 8) * sizeof(T) +
                 4 * kInner * sizeof(float) +
                 2 * kInner * sizeof(unsigned long long)
           : 4 * kInner * (D + 8) * sizeof(T);
  const auto kernel = kDkv ? block_sparse_dkv_kernel<T, D, kSoftcap>
                           : block_sparse_dq_kernel<T, D, kSoftcap>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_blocks, heads, batch), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The softcap is a template parameter, as in the forward. kDkv picks the
// kernel; n_blocks and heads are the grid's first two dimensions.
template <bool kDkv>
int dispatch(const Params& p, bool softcap, int n_blocks, int heads,
             int batch, int d, int is_fp16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    if (d == 64)
      return softcap ? launch<kDkv, __half, 64, true>(p, n_blocks, heads, batch, s)
                     : launch<kDkv, __half, 64, false>(p, n_blocks, heads, batch, s);
    if (d == 128)
      return softcap ? launch<kDkv, __half, 128, true>(p, n_blocks, heads, batch, s)
                     : launch<kDkv, __half, 128, false>(p, n_blocks, heads, batch, s);
  } else {
    if (d == 64)
      return softcap
                 ? launch<kDkv, __nv_bfloat16, 64, true>(p, n_blocks, heads, batch, s)
                 : launch<kDkv, __nv_bfloat16, 64, false>(p, n_blocks, heads, batch, s);
    if (d == 128)
      return softcap
                 ? launch<kDkv, __nv_bfloat16, 128, true>(p, n_blocks, heads, batch, s)
                 : launch<kDkv, __nv_bfloat16, 128, false>(p, n_blocks, heads, batch, s);
  }
  return -1;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, float* delta,
                   const long long* s, const int* counts, const int* entries,
                   const int* wofs, const unsigned long long* words,
                   long long list_len, int h, int hk, int sq, int sk,
                   float scale, float softcap) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.q_b = s[0];
  p.q_h = s[1];
  p.q_s = s[2];
  p.k_b = s[3];
  p.k_h = s[4];
  p.k_s = s[5];
  p.v_b = s[6];
  p.v_h = s[7];
  p.v_s = s[8];
  p.do_b = s[9];
  p.do_h = s[10];
  p.do_s = s[11];
  p.h = h;
  p.group = h / hk;
  p.sq = sq;
  p.sk = sk;
  p.nqb = (sq + kTileRows - 1) / kTileRows;
  p.nkb = (sk + kTileRows - 1) / kTileRows;
  p.scale = scale;
  const bool has_softcap = softcap > 0.f;
  p.score_mul = has_softcap ? scale / softcap : scale * kLog2e;
  p.cap_log2 = softcap * kLog2e;
  p.counts = counts;
  p.entries = entries;
  p.wofs = wofs;
  p.words = words;
  p.list_len = list_len;
  return p;
}

}  // namespace

// q (b, h, sq, d), k and v (b, hk, sk, d), dout as q; strides: 15 element
// strides (batch, head, seq) of q, k, v, dout, dq. lse (b, h, sq) fp32.
// counts (b, h, cdiv(sq, 64)); tiles and wofs hold list_len entries per
// count (the forward's lists); words the mode-2 groups. Writes dq and
// delta (b, h, sq) fp32 = sum_j P dP, every row. Returns 0, a cudaError_t
// from the launch, or -1 for an unsupported head dim.
extern "C" int block_sparse_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, const long long* strides,
    const int* counts, const int* tiles, const int* wofs,
    const unsigned long long* words, long long list_len, int batch, int h,
    int hk, int sq, int sk, int d, float scale, float softcap, int is_fp16,
    void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, strides, counts, tiles,
                         wofs, words, list_len, h, hk, sq, sk, scale, softcap);
  p.dq = dq;
  p.dq_b = strides[12];
  p.dq_h = strides[13];
  p.dq_s = strides[14];
  return dispatch<false>(p, softcap > 0.f, p.nqb, h, batch, d, is_fp16,
                         stream);
}

// strides: 18 element strides (batch, head, seq) of q, k, v, dout, dk, dv.
// lse and delta (b, h, sq) fp32 (delta from block_sparse_bwd_dq).
// inv_counts (b, h, cdiv(sk, 64)); inv_rows and inv_wofs hold inv_len
// entries per count: per query head, its 64-row blocks that keep any key
// of the 64-key block. Writes every key row of dk and dv (b, hk, sk, d),
// each kv head's group of query heads summed.
extern "C" int block_sparse_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dk, void* dv,
    const long long* strides, const int* inv_counts, const int* inv_rows,
    const int* inv_wofs, const unsigned long long* words, long long inv_len,
    int batch, int h, int hk, int sq, int sk, int d, float scale,
    float softcap, int is_fp16, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, strides, inv_counts,
                         inv_rows, inv_wofs, words, inv_len, h, hk, sq, sk,
                         scale, softcap);
  p.dk = dk;
  p.dv = dv;
  p.dk_b = strides[12];
  p.dk_h = strides[13];
  p.dk_s = strides[14];
  p.dv_b = strides[15];
  p.dv_h = strides[16];
  p.dv_s = strides[17];
  return dispatch<true>(p, softcap > 0.f, p.nkb, hk, batch, d, is_fp16,
                        stream);
}
