// Flash-attention backward tile steps, shared by csrc/flash_bwd.cu (dense
// and varlen modes) and csrc/flash_sparse_bwd.cu (the vertical-slash sparse
// mode): dQ, dK and dV from Q, K, V, dO and the forward's log-sum-exp, in
// two kernels.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_bwd.py:233
// (_bwd_dkv_kernel, launched at :930 by flash_attention_bwd :669),
// flash_bwd.py:449 (_bwd_dq_kernel, launched at :1075),
// flash_attn_tpu/kernels/flash_varlen.py:883 (_varlen_dkv_kernel, launched
// at :1739 by flash_attention_varlen_bwd :1508) and flash_varlen.py:1005
// (_varlen_dq_kernel, launched at :1821),
// flash_attn_tpu/kernels/flash_sparse.py:542 (_sparse_dkv_kernel, launched
// at :855 by flash_attention_sparse_bwd :713) and flash_sparse.py:638
// (_sparse_dq_kernel, launched at :915), restricted to the forward's
// features here (csrc/flash_fwd_tile.cuh): scale, bottom-right-aligned
// causal, sliding window, GQA/MQA, softcap, seqused_q/k, ALiBi (sparse),
// head dim 64 or 128, bf16/fp16. The TPU schedule (clamped index maps, _make_inverse_bounds,
// exact worklists, 128-lane LSE padding, the (b, h, sk, d) and (h, total_k,
// d) per-query-head dK/dV temporaries and their reshape-sums) is not carried
// over. A varlen sequence is what a batch row is to a dense call: the same
// row/key/diagonal rule as the forward, with per-sequence offsets and
// lengths; rows past a sequence's used rows and keys past its used keys are
// not written (the varlen wrapper zero-fills dq, dk and dv beforehand).
// A sparse call is a dense one whose visible pairs are further cut to the
// attended set of each query row's 64-row block (csrc/flash_fwd_tile.cuh):
// the dQ kernel walks the forward's tile lists and membership words; the
// dK/dV kernel walks, for its 64-key tile, an inverse list of (query head
// in the group, 64-row block, membership word) built by the planner
// (kernels/flash_sparse.py), so each query head's own pattern reaches the
// group's sum.
//
// Function. Both kernels recompute P from Q, K and the LSE, as
// _recompute_p_and_ds (flash_bwd.py:107-230) does: with s = q . k,
//   t  = tanh(s * scale / softcap)            (softcap only)
//   P  = exp(s * scale - lse)   or  exp(t * softcap - lse), 0 where masked
//        (with ALiBi, minus slope * |j - diag| inside the exponent)
//   dP = dO . v,  delta = sum_j P dP  (per query row)
//   dS = P * (dP - delta) * scale   [* (1 - t^2) with softcap]
//   dV = sum P^T dO,  dK = sum dS^T Q,  dQ = sum dS K
// dK and dV sum over the query heads of each kv head's group. A row that
// sees no column (lse = -inf) contributes nothing: P is 0, never NaN.
//
// delta. The JAX package takes delta = rowsum(dO * O) (flash_bwd.py:726,
// flash_varlen.py:1586, flash_sparse.py:769), equal in exact arithmetic. With O rounded to bf16 it no longer matches
// the P and dP the kernels recompute, so the rows of dS stop summing to 0,
// and a k-projection gradient (sum_j dK_j x_j^T) turns that error times the
// tokens' common component into an error several times that of a plain
// bf16 model (measured on GPT-2-medium, chip_smoke.py train_grad). So the
// dQ kernel computes delta = sum_j P dP exactly in fp32, in a first pass
// over its key tiles, writes it for the dK/dV kernel, and uses it in a
// second pass: dS rows then sum to 0 before their bf16 rounding, as in a
// plain bf16 model.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the backward
// as a function needs 2.5x the forward's 4 * d flops per visible (query
// head, row, column) triple (S, dP, dV, dK, dQ); the dK/dV kernel does 4
// of those products, the dQ kernel 5 (S and dP twice, then dQ), so the pair
// recomputes S and dP three times in all. Each kernel's bound counts what
// its outputs need: dK/dV 8 * d flops per visible triple (S, dP, dV, dK),
// dQ 6 * d (S, dP, dQ; delta rides on P and dP), at 989 TFLOP/s, against
// q, k, v, dO, lse (and delta) read and its outputs written once at
// 3.35 TB/s; the larger of the two. At training shapes (s = 2048, d = 64),
// dense or packed, both are bound by operations.
//
// Design (simple first). Deterministic: no atomics anywhere; every output
// element is summed by one thread in a fixed order. A varlen grid is sized
// by the longest sequence; blocks past a sequence's end return at once, and
// a grid too short for a sequence loops over its remaining tiles.
//  * dK/dV, KV-stationary: one block of 4 warps per (64 key rows, kv head,
//    batch row or sequence); each warp owns 16 key rows. The block keeps
//    its K and V tile in shared memory and walks the group's query heads and, for each,
//    the query tiles that see its keys, with Q, dO, lse and delta tiles
//    double-buffered by cp.async. It computes S^T = K Q^T and dP^T = V dO^T
//    on mma.sync, P^T and dS^T in registers, and accumulates dV += P^T dO
//    and dK += dS^T Q in fp32 registers, written once at the end. Summing
//    the group inside the block replaces the TPU's per-query-head temporary.
//  * dQ, Q-stationary: one block of 4 warps per (64 query rows, query head,
//    batch row or sequence). Q and dO stay in registers as A fragments;
//    the block walks the visible key tiles twice (K and V double-buffered throughout): the
//    first pass sums delta = P . dP per row, the second accumulates
//    dQ += dS K in fp32 registers. It runs before the dK/dV kernel, which
//    reads its delta.
// Query tiles (dK/dV) and key tiles (dQ) are 32 wide at head dim 128 to
// keep the accumulators in registers; a sparse 64-wide listed tile is then
// walked as two 32-wide halves, each with its half of the membership word.

#pragma once

#include "mma_utils.cuh"

namespace {

using namespace fa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = kWarps * 16;  // key rows (dK/dV) or query rows (dQ)

enum Mode { kDense = 0, kVarlen = 1, kSparse = 2 };

template <int D>
struct Tiles {
  static constexpr int kInner = D == 64 ? 64 : 32;  // walked tile width
};

struct BwdParams {
  // Dense (b, h, s, d) tensors, or varlen (total, h, d) / (h, total, d).
  const void* q;     // (b, h, sq, d)
  const void* k;     // (b, hk, sk, d)
  const void* v;     // (b, hk, sk, d)
  const void* dout;  // (b, h, sq, d)
  // lse and delta: dense (b, h, sq), varlen (h, total_q); contiguous.
  const float* lse;    // natural log
  const float* delta;  // the dK/dV kernel's input
  float* delta_out;    // the dQ kernel's output
  void* dq;  // (b, h, sq, d)
  void* dk;  // (b, hk, sk, d)
  void* dv;  // (b, hk, sk, d)
  // Element strides (batch, head, seq); varlen: batch unused.
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, do_b, do_h, do_s;
  long long dq_b, dq_h, dq_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  long long lse_h;  // lse/delta stride per head: dense sq, varlen total_q
  int h, group, sq, sk;  // sq, sk: dense only
  // Varlen: sequence starts (nseq + 1) and optional used lengths (nseq).
  const int* cu_q;
  const int* cu_k;
  const int* used_q;
  const int* used_k;
  int left, right;  // normalised window; negative = unbounded
  float scale;
  // Score in base 2 as in the forward: x * score_mul, or
  // tanh(x * score_mul) * cap_log2 with a softcap.
  float score_mul, cap_log2;
  bool has_softcap;
  // Sparse: the forward's lists (dQ), list_len entries per (b, head, 64-row
  // block) at row (b * h + head) * nqb + block, counts[row] of them used;
  // and the inverse lists (dK/dV), inv_len entries per (b, kv head, 64-key
  // tile) at row (b * hk + kv head) * nkb + tile: inv_idx = head in group
  // * nqb + 64-row block, with its membership word. used_q / used_k are the
  // optional seqlens_q / seqlens_k.
  const int* counts;
  const int* tiles;
  const unsigned long long* words;
  const int* inv_counts;
  const int* inv_idx;
  const unsigned long long* inv_words;
  long long list_len, inv_len;
  int nqb, nkb;
  // ALiBi (sparse): slope of (b, head) at alibi[b * alibi_b + head].
  const float* alibi;
  int alibi_b;
};

// One batch row or sequence: element offsets of its first row (head 0) in
// each tensor, its row and key counts and its diagonal offset, as in
// csrc/flash_fwd.cu.
struct Seq {
  long long q, k, v, dout, dq, dk, dv, lse;
  int rows, keys, off;
};

template <int kMode>
__device__ __forceinline__ Seq seq_of(const BwdParams& p, int b) {
  Seq s;
  if constexpr (kMode == kDense) {
    // Written out apart from the sparse rows below: reading the optional
    // lengths here too took the d = 64 dK/dV kernel from 168 to 175
    // registers, 2 blocks per SM instead of 3, and 15% slower (PERF.md).
    s.q = b * p.q_b;
    s.k = b * p.k_b;
    s.v = b * p.v_b;
    s.dout = b * p.do_b;
    s.dq = b * p.dq_b;
    s.dk = b * p.dk_b;
    s.dv = b * p.dv_b;
    s.lse = static_cast<long long>(b) * p.h * p.sq;
    s.rows = p.sq;
    s.keys = p.sk;
    s.off = p.sk - p.sq;
  } else if constexpr (kMode == kSparse) {
    s.q = b * p.q_b;
    s.k = b * p.k_b;
    s.v = b * p.v_b;
    s.dout = b * p.do_b;
    s.dq = b * p.dq_b;
    s.dk = b * p.dk_b;
    s.dv = b * p.dv_b;
    s.lse = static_cast<long long>(b) * p.h * p.sq;
    const int uq = p.used_q ? p.used_q[b] : p.sq;
    const int uk = p.used_k ? p.used_k[b] : p.sk;
    s.rows = max(min(uq, p.sq), 0);
    s.keys = max(min(uk, p.sk), 0);
    s.off = uk - uq;
  } else {
    const long long q0 = p.cu_q[b];
    const long long k0 = p.cu_k[b];
    const int len_q = p.cu_q[b + 1] - p.cu_q[b];
    const int len_k = p.cu_k[b + 1] - p.cu_k[b];
    const int uq = p.used_q ? p.used_q[b] : len_q;
    const int uk = p.used_k ? p.used_k[b] : len_k;
    s.q = q0 * p.q_s;
    s.dout = q0 * p.do_s;
    s.dq = q0 * p.dq_s;
    s.k = k0 * p.k_s;
    s.v = k0 * p.v_s;
    s.dk = k0 * p.dk_s;
    s.dv = k0 * p.dv_s;
    s.lse = q0;
    s.rows = max(min(uq, len_q), 0);
    s.keys = max(min(uk, len_k), 0);
    s.off = uk - uq;
  }
  return s;
}

// P of one score s given its row's lse (base 2), and the factor d(score)
// / d(s) that dS carries (scale, times 1 - t^2 under a softcap). The
// softcap and ALiBi are template parameters, as in the forward; `bias` is
// the ALiBi term in base 2 (read only with kAlibi).
template <bool kSoftcap, bool kAlibi>
__device__ __forceinline__ float prob_of(const BwdParams& p, float s,
                                         float lse2, bool ok, float& dmul,
                                         float bias) {
  float x;
  if (kSoftcap) {
    const float t = tanhf(s * p.score_mul);
    x = t * p.cap_log2;
    dmul = (1.f - t * t) * p.scale;
  } else {
    x = s * p.score_mul;
    dmul = p.scale;
  }
  if (kAlibi) x -= bias;
  return ok ? exp2f(x - lse2) : 0.f;
}

// P and dS of one score s given its row's lse (base 2) and delta.
template <bool kSoftcap, bool kAlibi>
__device__ __forceinline__ void p_and_ds(const BwdParams& p, float s, float dp,
                                         float lse2, float delta, bool ok,
                                         float bias, float& prob, float& ds) {
  float dmul;
  prob = prob_of<kSoftcap, kAlibi>(p, s, lse2, ok, dmul, bias);
  ds = prob * (dp - delta) * dmul;
}

template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* base, long long row_stride,
                                          int first, int rows, int limit, int tid) {
  // rows x D elements from rows first.. of a strided tensor into a padded
  // smem tile; rows at or past `limit` are zero-filled.
  constexpr int kChunks = D / 8;
  for (int c = tid; c < rows * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int part = c % kChunks;
    const int r = first + row;
    const long long src = static_cast<long long>(max(min(r, limit - 1), 0));
    cp_async_16(dst + row * (D + 8) + part * 8, base + src * row_stride + part * 8,
                r < limit ? 16 : 0);
  }
}

template <typename T, int D, bool kSoftcap, int kMode, bool kAlibi>
__device__ __forceinline__ void dkv_tile(const BwdParams& p, const Seq& sq_,
                                         int n_block, int g, int b,
                                         unsigned char* smem_raw) {
  constexpr int kBQ = Tiles<D>::kInner;
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

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rows = sq_.rows;
  const int keys = sq_.keys;
  const int off = sq_.off;
  const int col0 = n_block * kTileRows;
  const int col_last = min(col0 + kTileRows, keys) - 1;

  // The walk: iteration `iter` reads the query tile at row_base of query
  // head `head`: for each query head of the group, the query tiles that see
  // any key of this tile; in the sparse mode, the halves (kSub per 64-row
  // block) of the blocks on this tile's inverse list.
  constexpr int kSub = kTileRows / kBQ;
  int qt_lo = 0, n_qt = 1, n_iter;
  long long lbase = 0;
  if constexpr (kMode == kSparse) {
    const long long lrow =
        (static_cast<long long>(b) * (p.h / p.group) + g) * p.nkb + n_block;
    lbase = lrow * p.inv_len;
    n_iter = p.inv_counts[lrow] * kSub;
  } else {
    // Query rows that see any key of this tile.
    const int q_lo = p.right >= 0 ? max(col0 - off - p.right, 0) : 0;
    const int q_hi =
        p.left >= 0 ? min(col_last - off + p.left, rows - 1) : rows - 1;
    qt_lo = q_lo / kBQ;
    n_qt = q_hi >= q_lo ? q_hi / kBQ - qt_lo + 1 : 0;
    n_iter = n_qt * p.group;
  }
  auto head_and_rows = [&](int iter, int& head, int& row_base) {
    if constexpr (kMode == kSparse) {
      const int e = __ldg(p.inv_idx + lbase + iter / kSub);
      head = g * p.group + e / p.nqb;
      row_base = (e % p.nqb) * kTileRows + (iter % kSub) * kBQ;
    } else {
      head = g * p.group + iter / n_qt;
      row_base = (qt_lo + iter % n_qt) * kBQ;
    }
  };

  int kv_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kv_row[i] = col0 + warp * 16 + gid + 8 * i;

  auto load_q = [&](int iter, int stage) {
    int head, row_base;
    head_and_rows(iter, head, row_base);
    load_rows<T, D>(sQ + stage * kBQ * kStride,
                    static_cast<const T*>(p.q) + sq_.q + head * p.q_h,
                    p.q_s, row_base, kBQ, rows, tid);
    load_rows<T, D>(sdO + stage * kBQ * kStride,
                    static_cast<const T*>(p.dout) + sq_.dout + head * p.do_h,
                    p.do_s, row_base, kBQ, rows, tid);
    if (tid < kBQ) {
      const int r = row_base + tid;
      const long long li = sq_.lse + head * p.lse_h + r;
      sL[stage * kBQ + tid] = r < rows ? p.lse[li] * kLog2e : -INFINITY;
      sD[stage * kBQ + tid] = r < rows ? p.delta[li] : 0.f;
    }
  };

  if (n_iter > 0) {
    load_rows<T, D>(sK, static_cast<const T*>(p.k) + sq_.k + g * p.k_h,
                    p.k_s, col0, kTileRows, keys, tid);
    load_rows<T, D>(sV, static_cast<const T*>(p.v) + sq_.v + g * p.v_h,
                    p.v_s, col0, kTileRows, keys, tid);
    load_q(0, 0);
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
    if (it + 1 < n_iter) load_q(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    int head, row_base;
    head_and_rows(it, head, row_base);
    const T* q_t = sQ + stage * kBQ * kStride;
    const T* do_t = sdO + stage * kBQ * kStride;
    const float* lse2 = sL + stage * kBQ;
    const float* dlt = sD + stage * kBQ;
    bool full = row_base + kBQ <= rows && col0 + kTileRows <= keys &&
                in_window(col0, row_base + kBQ - 1 + off, p.left, -1) &&
                in_window(col0 + kTileRows - 1, row_base + off, -1, p.right);
    unsigned long long word = 0;  // sparse: bit j - col0 for key row j
    if constexpr (kMode == kSparse) {
      word = __ldg(p.inv_words + lbase + it / kSub);
      full = full && word == ~0ull;
    }
    float slope2 = 0.f;
    if constexpr (kAlibi) slope2 = p.alibi[b * p.alibi_b + head] * kLog2e;

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
        const int r = row_base + qi;
        const int j = kv_row[e >> 1];
        bool ok;
        if constexpr (kMode == kSparse) {
          ok = (full || (((word >> (j - col0)) & 1ull) && r < rows &&
                         j < keys && in_window(j, r + off, p.left, p.right))) &&
               lse2[qi] > -INFINITY;
        } else {
          ok = (full || (r < rows && j < keys &&
                         in_window(j, r + off, p.left, p.right))) &&
               lse2[qi] > -INFINITY;
        }
        const float bias =
            kAlibi ? slope2 * fabsf(static_cast<float>(j - r - off)) : 0.f;
        p_and_ds<kSoftcap, kAlibi>(p, st[nt][e], dpt[nt][e], lse2[qi],
                                   dlt[qi], ok, bias, st[nt][e], dpt[nt][e]);
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
    const int j = kv_row[i];
    if (j >= keys) continue;
    T* dkr = static_cast<T*>(p.dk) + sq_.dk + g * p.dk_h +
             static_cast<long long>(j) * p.dk_s;
    T* dvr = static_cast<T*>(p.dv) + sq_.dv + g * p.dv_h +
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

template <typename T, int D, bool kSoftcap, int kMode, bool kAlibi>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Seq s = seq_of<kMode>(p, blockIdx.z);
  const int n_n = (s.keys + kTileRows - 1) / kTileRows;
  for (int nb = blockIdx.x; nb < n_n; nb += gridDim.x) {
    dkv_tile<T, D, kSoftcap, kMode, kAlibi>(p, s, nb, blockIdx.y, blockIdx.z,
                                            smem_raw);
  }
}

template <typename T, int D, bool kSoftcap, int kMode, bool kAlibi>
__device__ __forceinline__ void dq_tile(const BwdParams& p, const Seq& sq_,
                                        int m_block, int head, int b,
                                        unsigned char* smem_raw) {
  constexpr int kBN = Tiles<D>::kInner;
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kNTiles = kBN / 8;
  constexpr int kDTiles = D / 8;
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][kBN][kStride]
  T* sV = sK + 2 * kBN * kStride;          // [2][kBN][kStride]

  const int g = head / p.group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rows = sq_.rows;
  const int keys = sq_.keys;
  const int off = sq_.off;
  const int row0 = m_block * kTileRows;
  const int row_last = min(row0 + kTileRows, rows) - 1;

  // The walk: n_tiles key tiles of kBN columns; step x reads tile
  // tile_lo + x (the tiles visible to any row of this block), or in the
  // sparse mode the (x % kSub)-th half of the (x / kSub)-th listed tile.
  constexpr int kSub = 64 / kBN;
  int tile_lo = 0, n_tiles;
  long long lbase = 0;
  if constexpr (kMode == kSparse) {
    const long long lrow =
        (static_cast<long long>(b) * p.h + head) * p.nqb + m_block;
    lbase = lrow * p.list_len;
    n_tiles = p.counts[lrow] * kSub;
  } else {
    const int col_lo = p.left >= 0 ? max(row0 + off - p.left, 0) : 0;
    const int col_hi =
        p.right >= 0 ? min(row_last + off + p.right, keys - 1) : keys - 1;
    tile_lo = col_lo / kBN;
    n_tiles = col_hi >= col_lo ? col_hi / kBN - tile_lo + 1 : 0;
  }
  auto tile_at = [&](int x) {
    if constexpr (kMode == kSparse) {
      return __ldg(p.tiles + lbase + x / kSub) * kSub + x % kSub;
    } else {
      return tile_lo + x;
    }
  };
  float slope2 = 0.f;  // ALiBi slope, base 2
  if constexpr (kAlibi) slope2 = p.alibi[b * p.alibi_b + head] * kLog2e;

  int diag[2];
  bool row_ok[2];
  float lse2[2];
  float dlt[2] = {0.f, 0.f};   // delta, summed in the first pass
  float dsum[2] = {0.f, 0.f};  // this thread's partial sums of P * dP
  long long li[2];
  const T* qrow[2];
  const T* dorow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + gid + 8 * i;
    row_ok[i] = r < rows;
    diag[i] = r + off;
    qrow[i] = static_cast<const T*>(p.q) + sq_.q + head * p.q_h +
              static_cast<long long>(r) * p.q_s;
    dorow[i] = static_cast<const T*>(p.dout) + sq_.dout + head * p.do_h +
               static_cast<long long>(r) * p.do_s;
    li[i] = sq_.lse + head * p.lse_h + r;
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

  const T* kbase = static_cast<const T*>(p.k) + sq_.k + g * p.k_h;
  const T* vbase = static_cast<const T*>(p.v) + sq_.v + g * p.v_h;
  auto load_tile = [&](int tile, int stage) {
    load_rows<T, D>(sK + stage * kBN * kStride, kbase, p.k_s, tile * kBN, kBN,
                    keys, tid);
    load_rows<T, D>(sV + stage * kBN * kStride, vbase, p.v_s, tile * kBN, kBN,
                    keys, tid);
  };

  // Two passes over the visible key tiles: iterations [0, n_tiles) sum
  // delta, [n_tiles, 2 n_tiles) accumulate dQ; the copies run on across
  // the boundary.
  const int n_iter = 2 * n_tiles;
  if (n_iter > 0) load_tile(tile_at(0), 0);
  cp_async_commit();

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iter) load_tile(tile_at((it + 1) % n_tiles), stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    if (it == n_tiles) {
#pragma unroll
      for (int i = 0; i < 2; ++i) dlt[i] = quad_sum(dsum[i]);
    }

    const T* k_t = sK + stage * kBN * kStride;
    const T* v_t = sV + stage * kBN * kStride;
    const int col0 = tile_at(it % n_tiles) * kBN;
    bool full = row0 + kTileRows <= rows && col0 + kBN <= keys &&
                in_window(col0, row0 + kTileRows - 1 + off, p.left, -1) &&
                in_window(col0 + kBN - 1, row0 + off, -1, p.right);
    // Sparse: this half's membership bits, bit c for column col0 + c.
    unsigned long long word = 0;
    if constexpr (kMode == kSparse) {
      constexpr unsigned long long kAll =
          ~0ull >> (64 - kBN);
      const int x = it % n_tiles;
      word = (__ldg(p.words + lbase + x / kSub) >> ((x % kSub) * kBN)) & kAll;
      full = full && word == kAll;
    }

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
    auto visible = [&](int nt, int e) {
      const int i = e >> 1;
      const int c = nt * 8 + tig * 2 + (e & 1);
      const int col = col0 + c;
      if constexpr (kMode == kSparse) {
        return (full || (((word >> c) & 1ull) && row_ok[i] && col < keys &&
                         in_window(col, diag[i], p.left, p.right))) &&
               lse2[i] > -INFINITY;
      } else {
        return (full || (row_ok[i] && col < keys &&
                         in_window(col, diag[i], p.left, p.right))) &&
               lse2[i] > -INFINITY;
      }
    };
    auto bias = [&](int nt, int e) {
      const int col = col0 + nt * 8 + tig * 2 + (e & 1);
      return kAlibi ? slope2 * fabsf(static_cast<float>(col - diag[e >> 1]))
                    : 0.f;
    };

    // The two passes are separate branches around whole tiles, so neither
    // pays for the other's arithmetic.
    if (it < n_tiles) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dmul;
          dsum[e >> 1] += prob_of<kSoftcap, kAlibi>(p, s[nt][e], lse2[e >> 1],
                                                    visible(nt, e), dmul,
                                                    bias(nt, e)) * dp[nt][e];
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float prob;
          p_and_ds<kSoftcap, kAlibi>(p, s[nt][e], dp[nt][e], lse2[e >> 1],
                                     dlt[e >> 1], visible(nt, e), bias(nt, e),
                                     prob, s[nt][e]);
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
    if (row_ok[i] && tig == 0) p.delta_out[li[i]] = dlt[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const int r = row0 + warp * 16 + gid + 8 * i;
    T* dqr = static_cast<T*>(p.dq) + sq_.dq + head * p.dq_h +
             static_cast<long long>(r) * p.dq_s;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      *reinterpret_cast<uint32_t*>(dqr + nt * 8 + tig * 2) =
          Mma<T>::pack(dq[nt][2 * i], dq[nt][2 * i + 1]);
    }
  }
}

template <typename T, int D, bool kSoftcap, int kMode, bool kAlibi>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Seq s = seq_of<kMode>(p, blockIdx.z);
  const int n_m = (s.rows + kTileRows - 1) / kTileRows;
  // Dense: one pass, m_block = gridDim.x - 1 - blockIdx.x.
  for (int mb = blockIdx.x; mb < n_m; mb += gridDim.x) {
    dq_tile<T, D, kSoftcap, kMode, kAlibi>(p, s, n_m - 1 - mb, blockIdx.y,
                                           blockIdx.z, smem_raw);
  }
}

template <typename T, int D, bool kSoftcap, int kMode, bool kAlibi>
int launch_dkv_kernel(const BwdParams& p, int n_blocks, int hk, int batch,
                      cudaStream_t stream) {
  constexpr int kBQ = Tiles<D>::kInner;
  const size_t smem = (2 * kTileRows + 4 * kBQ) * (D + 8) * sizeof(T) +
                      4 * kBQ * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D, kSoftcap, kMode, kAlibi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_blocks, hk, batch);
  flash_bwd_dkv_kernel<T, D, kSoftcap, kMode, kAlibi>
      <<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kSoftcap, int kMode, bool kAlibi>
int launch_dq_kernel(const BwdParams& p, int n_blocks, int hk, int batch,
                     cudaStream_t stream) {
  (void)hk;
  constexpr int kBN = Tiles<D>::kInner;
  const size_t smem = 4 * kBN * (D + 8) * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D, kSoftcap, kMode, kAlibi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_blocks, p.h, batch);
  flash_bwd_dq_kernel<T, D, kSoftcap, kMode, kAlibi>
      <<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDkv, int kMode, bool kAlibi, typename T, int D>
int launch_one(const BwdParams& p, int n_blocks, int hk, int batch,
               cudaStream_t s) {
  if constexpr (kDkv) {
    return p.has_softcap
               ? launch_dkv_kernel<T, D, true, kMode, kAlibi>(p, n_blocks, hk, batch, s)
               : launch_dkv_kernel<T, D, false, kMode, kAlibi>(p, n_blocks, hk, batch, s);
  } else {
    return p.has_softcap
               ? launch_dq_kernel<T, D, true, kMode, kAlibi>(p, n_blocks, hk, batch, s)
               : launch_dq_kernel<T, D, false, kMode, kAlibi>(p, n_blocks, hk, batch, s);
  }
}

// The softcap, and in the sparse mode ALiBi, are template parameters, as in
// the forward. kDkv picks the kernel; n_blocks is the grid's first
// dimension (key tiles for dK/dV, query tiles for dQ).
template <bool kDkv, int kMode, typename T, int D>
int launch(const BwdParams& p, int n_blocks, int hk, int batch,
           cudaStream_t s) {
  if constexpr (kMode == kSparse) {
    if (p.alibi) return launch_one<kDkv, kMode, true, T, D>(p, n_blocks, hk, batch, s);
  }
  return launch_one<kDkv, kMode, false, T, D>(p, n_blocks, hk, batch, s);
}

template <bool kDkv, int kMode>
int dispatch(const BwdParams& p, int n_blocks, int hk, int batch, int d,
             int is_fp16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    if (d == 64) return launch<kDkv, kMode, __half, 64>(p, n_blocks, hk, batch, s);
    if (d == 128) return launch<kDkv, kMode, __half, 128>(p, n_blocks, hk, batch, s);
  } else {
    if (d == 64)
      return launch<kDkv, kMode, __nv_bfloat16, 64>(p, n_blocks, hk, batch, s);
    if (d == 128)
      return launch<kDkv, kMode, __nv_bfloat16, 128>(p, n_blocks, hk, batch, s);
  }
  return -1;
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const long long* s, int h, int hk, float scale,
                      int window_left, int window_right, float softcap) {
  BwdParams p = {};
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
  p.left = window_left;
  p.right = window_right;
  p.scale = scale;
  p.has_softcap = softcap > 0.f;
  p.score_mul = p.has_softcap ? scale / softcap : scale * kLog2e;
  p.cap_log2 = softcap * kLog2e;
  return p;
}

void set_dkv(BwdParams& p, void* dk, void* dv, const long long* s) {
  p.dk = dk;
  p.dv = dv;
  p.dk_b = s[12];
  p.dk_h = s[13];
  p.dk_s = s[14];
  p.dv_b = s[15];
  p.dv_h = s[16];
  p.dv_s = s[17];
}

void set_dq(BwdParams& p, float* delta, void* dq, const long long* s) {
  p.delta_out = delta;
  p.dq = dq;
  p.dq_b = s[12];
  p.dq_h = s[13];
  p.dq_s = s[14];
}

void set_varlen(BwdParams& p, const int* cu_q, const int* cu_k,
                const int* used_q, const int* used_k, int total_q) {
  p.cu_q = cu_q;
  p.cu_k = cu_k;
  p.used_q = used_q;
  p.used_k = used_k;
  p.lse_h = total_q;
}

}  // namespace
