// MLA's absorbed-qv backward: the qv instances of TPU kernels 2 and 3 at
// MLA's widths (a 64-wide rope key beside a 512-wide latent that is both
// the second score operand and V).
//
// Replaces the qv paths of
//   flash_attn_tpu/kernels/flash_bwd.py:233 (_bwd_dkv_kernel, its qv term
//     at :251-253, :368, :381-386): dV += dS^T Qv beside P^T dO, and
//     dK += dS^T Q;
//   flash_attn_tpu/kernels/flash_bwd.py:449 (_bwd_dq_kernel, its qv term
//     at :467-498, :592, :605-615): dQv += dS C beside dQ += dS K.
// Launched by csrc/mla_bwd.cu, with (kHasQv) or without qv; the kernels
// that serve every other backward are untouched.
//
// Function. With C the latent (the V operand) and K the rope key,
//     S = Q K^T + Qv C^T      (kHasQv; without it S = Q K^T)
//     P = exp(scale * S - lse),  dP = dO C^T,
//     dS = P (dP - delta) scale,  delta = sum_j P dP per query row,
//     dQ = dS K,  dQv = dS C,  dK = dS^T Q,  dV = P^T dO + dS^T Qv,
// in fp32 from the forward's lse (natural log; a row with lse -inf has P
// 0). dK and dV sum the query heads of their kv head. Query row t sits at
// sk - sq + t (bottom-right aligned) when causal; keys past sk and rows
// past sq take no part.
//
// Query rows are packed as in csrc/mla_attn.cuh: packed row R of kv head
// g is token R / group of query head g * group + R % group, so that a tile
// of rows shares every key.
//
// Design. Two kernels, no atomics, each output element written once by one
// block, so that the backward is deterministic:
//  * dQ (Q-stationary): one block per (32 packed rows, kv head, batch
//    row), the last rows first. Q's row [q | qv] and dO stay in shared
//    memory; keys come in stages of 32 ([K | C] rows, double-buffered by
//    16-byte cp.async). A first pass over the visible keys sums delta =
//    sum_j P dP per row (written out for the dK/dV kernel), a second pass
//    forms dS and accumulates dQ and dQv in registers.
//  * dK/dV (KV-stationary): one block per (32 keys, kv head, batch row),
//    the first keys (most rows under causal) first. [K | C] of its keys
//    stays in shared memory; query rows come in stages of 32 packed rows
//    (Q | Qv, dO, lse and delta, double-buffered), every query head of the
//    group and every visible row, and dK and dV accumulate in registers.
// Per stage both recompute S and dP on mma.sync.m16n8k16 from ldmatrix
// fragments (each of 16 warps one 16 x 16 tile of S or dP over half the
// depth, the halves summed from shared memory), then P and dS by all
// threads (two elements each), then the products: each warp owns 32 of the
// 512 latent columns of dQv or dV for every row and one 16 x 8 tile of dQ
// or dK, reading dS (and P) and its own columns of the operands by
// ldmatrix, transposed where the product needs it.
//
// Sizes: 512 threads, at most 128 registers a thread; shared memory 166 KB
// (dQ) and 203 KB (dK/dV) with qv.

#pragma once

#include "mla_attn.cuh"

namespace fa {
namespace mla {
namespace bwd {

constexpr int kRows = 32;            // packed query rows per tile
constexpr int kKeys = 32;            // keys per tile
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kDoStride = kDV + 8;   // dO rows, padded as kKvStride
constexpr int kSStride = kKeys + 4;  // fp32 S / dP partials
constexpr int kPStride = kKeys + 8;  // P and dS in q's type
constexpr int kColsPerWarp = kDV / kWarps;  // 32 latent columns

struct BwdParams {
  const void* q;     // (b, h, sq, 64) through (batch, head, row) strides
  long long q_sb, q_sh, q_st;
  const void* qv;    // (b, h, sq, 512) (kHasQv)
  long long qv_sb, qv_sh, qv_st;
  const void* k;     // (b, hk, sk, 64)
  long long k_sb, k_sh, k_st;
  const void* v;     // (b, hk, sk, 512): the latent
  long long v_sb, v_sh, v_st;
  const void* dout;  // (b, h, sq, 512)
  long long do_sb, do_sh, do_st;
  const float* lse;  // (b, h, sq), the forward's
  float* delta;      // (b, h, sq): the dQ kernel writes it, dK/dV reads it
  void* g0;          // dq (b, h, sq, 64) | dk (b, hk, sk, 64)
  long long g0_sb, g0_sh, g0_st;
  void* g1;          // dqv (b, h, sq, 512) | dv (b, hk, sk, 512)
  long long g1_sb, g1_sh, g1_st;
  int batch, h, hk, group, sq, sk;
  float scale;       // softmax scale
  float score_mul;   // scale * log2(e)
  bool causal;
};

template <bool kHasQv>
struct Shape {
  static constexpr int kQD = kHasQv ? kKD : kD;  // the score's depth
  static constexpr int kQStride = kQD + 8;
  static constexpr int q_bytes = kRows * kQStride * 2;
  static constexpr int do_bytes = kRows * kDoStride * 2;
  static constexpr int stat_bytes = 2 * kRows * 4;  // lse * log2(e), delta
  static constexpr int kv_bytes = kKeys * kKvStride * 2;
  static constexpr int s_bytes = 4 * kRows * kSStride * 4;  // (S, dP) x halves
  static constexpr int p_bytes = kRows * kPStride * 2;
  static constexpr int stage_bytes = q_bytes + do_bytes + stat_bytes;
  // dQ: Q, dO and lse stay; two key stages; S / dP partials; dS.
  static constexpr int dq_bytes = stage_bytes + 2 * kv_bytes + s_bytes + p_bytes;
  // dK/dV: the keys stay; two row stages; S / dP partials; P and dS.
  static constexpr int dkv_bytes = kv_bytes + 2 * stage_bytes + s_bytes + 2 * p_bytes;
  static_assert(q_bytes % 16 == 0 && do_bytes % 16 == 0 &&
                    kv_bytes % 16 == 0 && s_bytes % 16 == 0 &&
                    p_bytes % 16 == 0 && stat_bytes % 16 == 0,
                "16-byte aligned sections");
  static_assert(dq_bytes <= 227 * 1024 && dkv_bytes <= 227 * 1024,
                "shared memory of one block");
};

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// Packed rows [row0, row0 + kRows) of kv head g: [q | qv] into sQ and dO
// into sDO by cp.async (rows past the call zero-filled).
template <typename T, bool kHasQv>
__device__ __forceinline__ void load_rows(const BwdParams& p, T* sQ, T* sDO,
                                          int b, int g, int row0,
                                          int rows_total, int tid) {
  constexpr int kQChunks = Shape<kHasQv>::kQD / 8;
  constexpr int kChunks = kQChunks + kDV / 8;
  constexpr int kQStride = Shape<kHasQv>::kQStride;
  const T* q = static_cast<const T*>(p.q);
  const T* qv = static_cast<const T*>(p.qv);
  const T* dout = static_cast<const T*>(p.dout);
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, part = i % kChunks;
    const int R = row0 + r;
    const bool ok = R < rows_total;
    const int t = ok ? R / p.group : 0;
    const int head = g * p.group + (ok ? R % p.group : 0);
    const T* src;
    T* dst;
    if (part < kD / 8) {
      src = q + b * p.q_sb + head * p.q_sh + t * p.q_st + part * 8;
      dst = sQ + r * kQStride + part * 8;
    } else if (part < kQChunks) {
      src = qv + b * p.qv_sb + head * p.qv_sh + t * p.qv_st + (part - kD / 8) * 8;
      dst = sQ + r * kQStride + part * 8;
    } else {
      src = dout + b * p.do_sb + head * p.do_sh + t * p.do_st +
            (part - kQChunks) * 8;
      dst = sDO + r * kDoStride + (part - kQChunks) * 8;
    }
    cp_async_16(dst, ok ? src : q, ok ? 16 : 0);
  }
}

// Each row's lse * log2(e) (+inf where the row saw no key or lies past the
// call, so that P = 0 there) and, if `delta` is given, its delta.
__device__ __forceinline__ void load_stats(const BwdParams& p, float* sLse2,
                                           float* sDelta, int b, int g,
                                           int row0, int rows_total, int tid) {
  if (tid >= kRows) return;
  const int R = row0 + tid;
  float l2 = INFINITY, d = 0.f;
  if (R < rows_total) {
    const int t = R / p.group, head = g * p.group + R % p.group;
    const long long i = (static_cast<long long>(b) * p.h + head) * p.sq + t;
    const float lse = p.lse[i];
    l2 = lse == -INFINITY ? INFINITY : lse * kLog2e;
    if (sDelta) d = p.delta[i];
  }
  sLse2[tid] = l2;
  if (sDelta) sDelta[tid] = d;
}

// Keys [key0, key0 + kKeys) of kv head g: each key's [K | C] row into sKV
// (keys past sk zero-filled).
template <typename T>
__device__ __forceinline__ void load_keys(const BwdParams& p, T* sKV, int b,
                                          int g, int key0, int tid) {
  constexpr int kChunks = kKD / 8;  // 72
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);
  for (int i = tid; i < kKeys * kChunks; i += kThreads) {
    const int key = i / kChunks, part = i % kChunks;
    const int c = key0 + key;
    const bool ok = c < p.sk;
    const T* src = part < kD / 8
        ? kp + b * p.k_sb + g * p.k_sh + c * p.k_st + part * 8
        : vp + b * p.v_sb + g * p.v_sh + c * p.v_st + (part - kD / 8) * 8;
    cp_async_16(sKV + key * kKvStride + part * 8, ok ? src : kp, ok ? 16 : 0);
  }
}

// S = [Q | Qv] [K | C]^T and dP = dO C^T of a (kRows x kKeys) tile, fp32
// partials into sS: warp w computes product w >> 3 (S, dP) over half
// (w >> 2) & 1 of its depth for the 16 x 16 output tile (rows 16 ((w >> 1)
// & 1), keys 16 (w & 1)); section 2 * product + half of sS holds it.
template <typename T, bool kHasQv>
__device__ __forceinline__ void score_tiles(const T* sQ, const T* sDO,
                                            const T* sKV, float* sS, int warp,
                                            int lane) {
  using SH = Shape<kHasQv>;
  const int prod = warp >> 3, half = (warp >> 2) & 1;
  const int rt = (warp >> 1) & 1, nt = warp & 1;
  const T* a_rows = prod == 0 ? sQ : sDO;
  const int a_stride = prod == 0 ? SH::kQStride : kDoStride;
  const int steps = (prod == 0 ? SH::kQD : kDV) / 32;
  const int d0 = half * steps * 16;
  const T* a_ptr = a_rows + (rt * 16 + (lane & 15)) * a_stride + d0 +
                   (lane >> 4) * 8;
  const T* b_ptr = sKV + (nt * 16 + (lane >> 4) * 8 + (lane & 7)) * kKvStride +
                   (prod == 0 ? 0 : kD) + d0 + ((lane >> 3) & 1) * 8;
  float acc[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < steps; ++kk) {
    uint32_t a[4], bb[4];
    ldsm_x4(a, a_ptr + kk * 16);
    ldsm_x4(bb, b_ptr + kk * 16);
    Mma<T>::run(acc[0], a, bb[0], bb[1]);
    Mma<T>::run(acc[1], a, bb[2], bb[3]);
  }
  const int gid = (lane >> 2), tig = lane & 3;
  float* dst = sS + ((prod * 2 + half) * kRows + rt * 16) * kSStride + nt * 16 +
               2 * tig;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    *reinterpret_cast<float2*>(dst + gid * kSStride + n * 8) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(dst + (gid + 8) * kSStride + n * 8) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// Thread tid's two elements of the tile: row tid >> 4, keys 2 (tid & 15)
// and the next. Returns S and dP summed over the depth halves.
__device__ __forceinline__ void tile_pair(const float* sS, int tid, float* s,
                                          float* dp) {
  const int r = tid >> 4, j = 2 * (tid & 15);
  const float2 s0 = *reinterpret_cast<const float2*>(sS + r * kSStride + j);
  const float2 s1 =
      *reinterpret_cast<const float2*>(sS + (kRows + r) * kSStride + j);
  const float2 d0 =
      *reinterpret_cast<const float2*>(sS + (2 * kRows + r) * kSStride + j);
  const float2 d1 =
      *reinterpret_cast<const float2*>(sS + (3 * kRows + r) * kSStride + j);
  s[0] = s0.x + s1.x;
  s[1] = s0.y + s1.y;
  dp[0] = d0.x + d1.x;
  dp[1] = d0.y + d1.y;
}

template <typename T, bool kHasQv>
__global__ void __launch_bounds__(kThreads, 1)
    mla_bwd_dq_kernel(const BwdParams p) {
  using SH = Shape<kHasQv>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sDO = reinterpret_cast<T*>(smem_raw + SH::q_bytes);
  float* sLse2 = reinterpret_cast<float*>(smem_raw + SH::q_bytes + SH::do_bytes);
  T* sKV = reinterpret_cast<T*>(smem_raw + SH::stage_bytes);
  float* sS = reinterpret_cast<float*>(smem_raw + SH::stage_bytes +
                                       2 * SH::kv_bytes);
  T* sDS = reinterpret_cast<T*>(smem_raw + SH::stage_bytes + 2 * SH::kv_bytes +
                                SH::s_bytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rows_total = p.sq * p.group;
  const int n_row_tiles = (rows_total + kRows - 1) / kRows;
  const int row0 = (n_row_tiles - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int g = blockIdx.y % p.hk, b = blockIdx.y / p.hk;
  const int off = p.sk - p.sq;
  // The block's keys: [0, hi), hi past its last row's diagonal when causal.
  const int t_last = (min(row0 + kRows, rows_total) - 1) / p.group;
  const int hi = max(p.causal ? min(p.sk, t_last + off + 1) : p.sk, 0);
  const int n_tiles = (hi + kKeys - 1) / kKeys;

  load_rows<T, kHasQv>(p, sQ, sDO, b, g, row0, rows_total, tid);
  load_stats(p, sLse2, nullptr, b, g, row0, rows_total, tid);
  if (n_tiles > 0) load_keys(p, sKV, b, g, 0, tid);
  cp_async_commit();

  // This thread's two elements of each tile: row er, keys ej and ej + 1.
  const int er = tid >> 4, ej = 2 * (tid & 15);
  const int eR = row0 + er;
  const bool e_row = eR < rows_total;
  const int e_pos = eR / p.group + off;
  float delta_acc = 0.f, delta_row = 0.f;

  // delta of row er, summed over the 16 threads of the row (a half warp),
  // written out once.
  auto finish_delta = [&]() {
    float d = delta_acc;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if ((tid & 15) == 0 && e_row) {
      const int head = g * p.group + eR % p.group;
      p.delta[(static_cast<long long>(b) * p.h + head) * p.sq + eR / p.group] = d;
    }
    return d;
  };

  // dQv: this warp's 32 latent columns of every row; dQ: its 16 x 8 tile
  // (rows 16 (warp >> 3), columns 8 (warp & 7)).
  float acc_v[2][kColsPerWarp / 8][4];
  float acc_k[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int n = 0; n < kColsPerWarp / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_v[rt][n][e] = 0.f;

  const int total = 2 * n_tiles;  // pass 1 (delta), then pass 2 (dS)
  for (int it = 0; it < total; ++it) {
    const bool second = it >= n_tiles;
    const int key0 = (second ? it - n_tiles : it) * kKeys;
    cp_async_wait_0();
    __syncthreads();  // stage it landed; the last stage's readers are done
    if (it + 1 < total) {
      const int next = it + 1 >= n_tiles ? it + 1 - n_tiles : it + 1;
      load_keys(p, sKV + ((it + 1) & 1) * kKeys * kKvStride, b, g,
                next * kKeys, tid);
    }
    cp_async_commit();
    if (it == n_tiles) delta_row = finish_delta();
    const T* kv = sKV + (it & 1) * kKeys * kKvStride;
    score_tiles<T, kHasQv>(sQ, sDO, kv, sS, warp, lane);
    __syncthreads();
    {
      float s[2], dp[2], pr[2];
      tile_pair(sS, tid, s, dp);
      const float l2 = sLse2[er];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = key0 + ej + e;
        const bool vis = e_row && c < p.sk && (!p.causal || c <= e_pos);
        pr[e] = vis ? exp2f(s[e] * p.score_mul - l2) : 0.f;
      }
      if (!second) {
        delta_acc += pr[0] * dp[0] + pr[1] * dp[1];
      } else {
        *reinterpret_cast<uint32_t*>(sDS + er * kPStride + ej) = Mma<T>::pack(
            pr[0] * (dp[0] - delta_row) * p.scale,
            pr[1] * (dp[1] - delta_row) * p.scale);
      }
    }
    if (!second) continue;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
        ldsm_x4(a[rt], sDS + (rt * 16 + (lane & 15)) * kPStride + kk * 16 +
                           (lane >> 4) * 8);
      if (kHasQv) {
#pragma unroll
        for (int np = 0; np < kColsPerWarp / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, kv + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                 kKvStride +
                            kD + warp * kColsPerWarp + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int rt = 0; rt < 2; ++rt) {
            Mma<T>::run(acc_v[rt][2 * np], a[rt], bb[0], bb[1]);
            Mma<T>::run(acc_v[rt][2 * np + 1], a[rt], bb[2], bb[3]);
          }
        }
      }
      uint32_t bk[2];
      ldsm_x2_t(bk, kv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             kKvStride + (warp & 7) * 8);
      if (warp >> 3)
        Mma<T>::run(acc_k, a[1], bk[0], bk[1]);
      else
        Mma<T>::run(acc_k, a[0], bk[0], bk[1]);
    }
  }
  if (n_tiles == 0) finish_delta();

  T* dq = static_cast<T*>(p.g0);
  T* dqv = static_cast<T*>(p.g1);
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int R = row0 + rt * 16 + gid + half * 8;
      if (R >= rows_total) continue;
      const int t = R / p.group, head = g * p.group + R % p.group;
      if (kHasQv) {
        T* dst = dqv + b * p.g1_sb + head * p.g1_sh + t * p.g1_st +
                 warp * kColsPerWarp + 2 * tig;
#pragma unroll
        for (int n = 0; n < kColsPerWarp / 8; ++n)
          *reinterpret_cast<uint32_t*>(dst + n * 8) = Mma<T>::pack(
              acc_v[rt][n][2 * half], acc_v[rt][n][2 * half + 1]);
      }
      if (rt == (warp >> 3)) {
        T* dst = dq + b * p.g0_sb + head * p.g0_sh + t * p.g0_st +
                 (warp & 7) * 8 + 2 * tig;
        *reinterpret_cast<uint32_t*>(dst) =
            Mma<T>::pack(acc_k[2 * half], acc_k[2 * half + 1]);
      }
    }
  }
}

template <typename T, bool kHasQv>
__global__ void __launch_bounds__(kThreads, 1)
    mla_bwd_dkv_kernel(const BwdParams p) {
  using SH = Shape<kHasQv>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sKV = reinterpret_cast<T*>(smem_raw);
  unsigned char* stages = smem_raw + SH::kv_bytes;
  float* sS = reinterpret_cast<float*>(stages + 2 * SH::stage_bytes);
  T* sP = reinterpret_cast<T*>(stages + 2 * SH::stage_bytes + SH::s_bytes);
  T* sDS = sP + kRows * kPStride;
  auto stage_q = [&](int s) { return reinterpret_cast<T*>(stages + s * SH::stage_bytes); };
  auto stage_do = [&](int s) {
    return reinterpret_cast<T*>(stages + s * SH::stage_bytes + SH::q_bytes);
  };
  auto stage_stats = [&](int s) {
    return reinterpret_cast<float*>(stages + s * SH::stage_bytes + SH::q_bytes +
                                    SH::do_bytes);
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int key0 = blockIdx.x * kKeys;
  const int g = blockIdx.y % p.hk, b = blockIdx.y / p.hk;
  const int rows_total = p.sq * p.group;
  const int off = p.sk - p.sq;
  // The first packed row that sees one of the block's keys: token
  // key0 - off when causal.
  const int r_lo = p.causal ? min(max(key0 - off, 0), p.sq) * p.group : 0;
  const int st0 = r_lo / kRows;
  const int n_st = r_lo < rows_total ? (rows_total + kRows - 1) / kRows - st0 : 0;

  auto load_stage = [&](int st, int s) {
    const int row0 = (st0 + st) * kRows;
    load_rows<T, kHasQv>(p, stage_q(s), stage_do(s), b, g, row0, rows_total, tid);
    load_stats(p, stage_stats(s), stage_stats(s) + kRows, b, g, row0,
               rows_total, tid);
  };
  load_keys(p, sKV, b, g, key0, tid);
  if (n_st > 0) load_stage(0, 0);
  cp_async_commit();

  const int er = tid >> 4, ej = 2 * (tid & 15);

  // dV: this warp's 32 latent columns of every key; dK: its 16 x 8 tile
  // (keys 16 (warp >> 3), columns 8 (warp & 7)).
  float acc_v[2][kColsPerWarp / 8][4];
  float acc_k[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int n = 0; n < kColsPerWarp / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_v[rt][n][e] = 0.f;

  for (int it = 0; it < n_st; ++it) {
    cp_async_wait_0();
    __syncthreads();  // stage it landed; the last stage's readers are done
    if (it + 1 < n_st) load_stage(it + 1, (it + 1) & 1);
    cp_async_commit();
    const T* sQ = stage_q(it & 1);
    const T* sDO = stage_do(it & 1);
    const float* stats = stage_stats(it & 1);
    score_tiles<T, kHasQv>(sQ, sDO, sKV, sS, warp, lane);
    __syncthreads();
    {
      float s[2], dp[2], pr[2];
      tile_pair(sS, tid, s, dp);
      const int R = (st0 + it) * kRows + er;
      const int pos = R / p.group + off;
      const float l2 = stats[er], dl = stats[kRows + er];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = key0 + ej + e;
        const bool vis = R < rows_total && c < p.sk && (!p.causal || c <= pos);
        pr[e] = vis ? exp2f(s[e] * p.score_mul - l2) : 0.f;
      }
      *reinterpret_cast<uint32_t*>(sP + er * kPStride + ej) =
          Mma<T>::pack(pr[0], pr[1]);
      *reinterpret_cast<uint32_t*>(sDS + er * kPStride + ej) = Mma<T>::pack(
          pr[0] * (dp[0] - dl) * p.scale, pr[1] * (dp[1] - dl) * p.scale);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      // P^T and dS^T (keys x rows) from the (rows x keys) tiles.
      uint32_t ap[2][4], ad[2][4];
      const int arow = kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        const int acol = rt * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(ap[rt], sP + arow * kPStride + acol);
        ldsm_x4_t(ad[rt], sDS + arow * kPStride + acol);
      }
      const int brow = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int np = 0; np < kColsPerWarp / 16; ++np) {
        const int bcol = warp * kColsPerWarp + np * 16 + (lane >> 4) * 8;
        uint32_t bo[4];
        ldsm_x4_t(bo, sDO + brow * kDoStride + bcol);
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) {
          Mma<T>::run(acc_v[rt][2 * np], ap[rt], bo[0], bo[1]);
          Mma<T>::run(acc_v[rt][2 * np + 1], ap[rt], bo[2], bo[3]);
        }
        if (kHasQv) {
          uint32_t bq[4];
          ldsm_x4_t(bq, sQ + brow * SH::kQStride + kD + bcol);
#pragma unroll
          for (int rt = 0; rt < 2; ++rt) {
            Mma<T>::run(acc_v[rt][2 * np], ad[rt], bq[0], bq[1]);
            Mma<T>::run(acc_v[rt][2 * np + 1], ad[rt], bq[2], bq[3]);
          }
        }
      }
      uint32_t bk[2];
      ldsm_x2_t(bk, sQ + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             SH::kQStride + (warp & 7) * 8);
      if (warp >> 3)
        Mma<T>::run(acc_k, ad[1], bk[0], bk[1]);
      else
        Mma<T>::run(acc_k, ad[0], bk[0], bk[1]);
    }
  }
  cp_async_wait_0();

  T* dk = static_cast<T*>(p.g0);
  T* dv = static_cast<T*>(p.g1);
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + rt * 16 + gid + half * 8;
      if (key >= p.sk) continue;
      T* dst = dv + b * p.g1_sb + g * p.g1_sh + key * p.g1_st +
               warp * kColsPerWarp + 2 * tig;
#pragma unroll
      for (int n = 0; n < kColsPerWarp / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) = Mma<T>::pack(
            acc_v[rt][n][2 * half], acc_v[rt][n][2 * half + 1]);
      if (rt == (warp >> 3)) {
        T* kdst = dk + b * p.g0_sb + g * p.g0_sh + key * p.g0_st +
                  (warp & 7) * 8 + 2 * tig;
        *reinterpret_cast<uint32_t*>(kdst) =
            Mma<T>::pack(acc_k[2 * half], acc_k[2 * half + 1]);
      }
    }
  }
}

// Launches the dQ kernel (which writes delta) or the dK/dV kernel (which
// reads it) on `stream`. Returns 0 or a cudaError_t.
template <typename T, bool kHasQv>
int launch_bwd(const BwdParams& p, bool dq, cudaStream_t stream) {
  using SH = Shape<kHasQv>;
  const int rows = p.sq * p.group;
  const int tiles = dq ? (rows + kRows - 1) / kRows : (p.sk + kKeys - 1) / kKeys;
  if (p.batch == 0 || p.hk == 0 || tiles == 0) return 0;
  auto* kernel = dq ? mla_bwd_dq_kernel<T, kHasQv> : mla_bwd_dkv_kernel<T, kHasQv>;
  const int bytes = dq ? SH::dq_bytes : SH::dkv_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, p.batch * p.hk), kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd
}  // namespace mla
}  // namespace fa
