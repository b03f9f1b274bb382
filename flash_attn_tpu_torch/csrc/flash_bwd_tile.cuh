// Flash-attention backward tile step of csrc/flash_bwd.cu's varlen dK/dV
// entry point (kernel 7): dK and dV from Q, K, V, dO, the forward's
// log-sum-exp and the dQ kernel's delta over packed variable-length
// sequences. The varlen dQ (kernel 8) runs on the Hopper kernel of
// csrc/flash_varlen_bwd_sm90.cuh, the dense backward on
// csrc/flash_bwd_sm90.cuh, the sparse one on csrc/flash_sparse_bwd_sm90.cuh;
// kernel 7 is this header's last user.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_varlen.py:883
// (_varlen_dkv_kernel, launched at :1739 by flash_attention_varlen_bwd
// :1508), restricted to the forward's features here (csrc/flash_fwd_tile.cuh):
// scale, bottom-right-aligned causal, sliding window, GQA/MQA, softcap,
// seqused_q/k, head dim 64 or 128, bf16/fp16. The TPU schedule (clamped
// index maps, _make_inverse_bounds, exact worklists, 128-lane LSE padding,
// the (h, total_k, d) per-query-head dK/dV temporaries and their
// reshape-sums) is not carried over. A varlen sequence is what a batch row
// is to a dense call: the same row/key/diagonal rule as the forward, with
// per-sequence offsets and lengths; rows past a sequence's used rows and
// keys past its used keys are not written (the varlen wrapper zero-fills
// dk and dv beforehand).
//
// Function. The backward recomputes P from Q, K and the LSE, as
// _recompute_p_and_ds (flash_bwd.py:107-230) does: with s = q . k,
//   t  = tanh(s * scale / softcap)            (softcap only)
//   P  = exp(s * scale - lse)   or  exp(t * softcap - lse), 0 where masked
//   dP = dO . v,  delta = sum_j P dP  (per query row)
//   dS = P * (dP - delta) * scale   [* (1 - t^2) with softcap]
//   dV = sum P^T dO,  dK = sum dS^T Q,  dQ = sum dS K
// dK and dV sum over the query heads of each kv head's group. A row that
// sees no column (lse = -inf) contributes nothing: P is 0, never NaN.
//
// delta. The JAX package takes delta = rowsum(dO * O) (flash_bwd.py:726,
// flash_varlen.py:1586), equal in exact arithmetic. With O rounded to bf16 it no longer matches
// the P and dP the kernels recompute, so the rows of dS stop summing to 0,
// and a k-projection gradient (sum_j dK_j x_j^T) turns that error times the
// tokens' common component into an error several times that of a plain
// bf16 model (measured on GPT-2-medium, chip_smoke.py train_grad). So the
// dQ kernel computes delta = sum_j P dP exactly in fp32, in a first pass
// over its key tiles, writes it for the dK/dV kernel, and uses it in a
// second pass: dS rows then sum to 0 before their bf16 rounding, as in a
// plain bf16 model (csrc/flash_varlen_bwd_sm90.cuh).
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
// element is summed by one thread in a fixed order. The grid is sized by
// the longest sequence; blocks past a sequence's end return at once, and a
// grid too short for a sequence loops over its remaining tiles.
//  * dK/dV, KV-stationary: one block of 4 warps per (64 key rows, kv head,
//    sequence); each warp owns 16 key rows. The block keeps
//    its K and V tile in shared memory and walks the group's query heads and, for each,
//    the query tiles that see its keys, with Q, dO, lse and delta tiles
//    double-buffered by cp.async. It computes S^T = K Q^T and dP^T = V dO^T
//    on mma.sync, P^T and dS^T in registers, and accumulates dV += P^T dO
//    and dK += dS^T Q in fp32 registers, written once at the end. Summing
//    the group inside the block replaces the TPU's per-query-head temporary.
// Query tiles are 32 wide at head dim 128 to keep the accumulators in
// registers.

#pragma once

#include "mma_utils.cuh"

namespace {

using namespace fa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = kWarps * 16;  // key rows

template <int D>
struct Tiles {
  static constexpr int kInner = D == 64 ? 64 : 32;  // walked tile width
};

struct BwdParams {
  // Packed (total, h, d) / (h, total, d) tensors.
  const void* q;     // q rows
  const void* k;     // k rows
  const void* v;     // v rows
  const void* dout;  // as q
  // lse and delta: (h, total_q); contiguous.
  const float* lse;    // natural log
  const float* delta;  // from the dQ kernel
  void* dk;  // as k
  void* dv;  // as v
  // Element strides (batch, head, token); batch unused.
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, do_b, do_h, do_s;
  long long dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  long long lse_h;  // lse/delta stride per head: total_q
  int h, group;
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
};

// One sequence: element offsets of its first row (head 0) in each tensor,
// its row and key counts and its diagonal offset, as in csrc/flash_fwd.cu.
struct Seq {
  long long q, k, v, dout, dk, dv, lse;
  int rows, keys, off;
};

__device__ __forceinline__ Seq seq_of(const BwdParams& p, int b) {
  Seq s;
  const long long q0 = p.cu_q[b];
  const long long k0 = p.cu_k[b];
  const int len_q = p.cu_q[b + 1] - p.cu_q[b];
  const int len_k = p.cu_k[b + 1] - p.cu_k[b];
  const int uq = p.used_q ? p.used_q[b] : len_q;
  const int uk = p.used_k ? p.used_k[b] : len_k;
  s.q = q0 * p.q_s;
  s.dout = q0 * p.do_s;
  s.k = k0 * p.k_s;
  s.v = k0 * p.v_s;
  s.dk = k0 * p.dk_s;
  s.dv = k0 * p.dv_s;
  s.lse = q0;
  s.rows = max(min(uq, len_q), 0);
  s.keys = max(min(uk, len_k), 0);
  s.off = uk - uq;
  return s;
}

// P of one score s given its row's lse (base 2), and the factor d(score)
// / d(s) that dS carries (scale, times 1 - t^2 under a softcap). The
// softcap is a template parameter, as in the forward.
template <bool kSoftcap>
__device__ __forceinline__ float prob_of(const BwdParams& p, float s,
                                         float lse2, bool ok, float& dmul) {
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

// P and dS of one score s given its row's lse (base 2) and delta.
template <bool kSoftcap>
__device__ __forceinline__ void p_and_ds(const BwdParams& p, float s, float dp,
                                         float lse2, float delta, bool ok,
                                         float& prob, float& ds) {
  float dmul;
  prob = prob_of<kSoftcap>(p, s, lse2, ok, dmul);
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

template <typename T, int D, bool kSoftcap>
__device__ __forceinline__ void dkv_tile(const BwdParams& p, const Seq& sq_,
                                         int n_block, int g,
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
  // any key of this tile.
  const int q_lo = p.right >= 0 ? max(col0 - off - p.right, 0) : 0;
  const int q_hi =
      p.left >= 0 ? min(col_last - off + p.left, rows - 1) : rows - 1;
  const int qt_lo = q_lo / kBQ;
  const int n_qt = q_hi >= q_lo ? q_hi / kBQ - qt_lo + 1 : 0;
  const int n_iter = n_qt * p.group;
  auto head_and_rows = [&](int iter, int& head, int& row_base) {
    head = g * p.group + iter / n_qt;
    row_base = (qt_lo + iter % n_qt) * kBQ;
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
    const bool full =
        row_base + kBQ <= rows && col0 + kTileRows <= keys &&
        in_window(col0, row_base + kBQ - 1 + off, p.left, -1) &&
        in_window(col0 + kTileRows - 1, row_base + off, -1, p.right);

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
        const bool ok = (full || (r < rows && j < keys &&
                                  in_window(j, r + off, p.left, p.right))) &&
                        lse2[qi] > -INFINITY;
        p_and_ds<kSoftcap>(p, st[nt][e], dpt[nt][e], lse2[qi], dlt[qi], ok,
                           st[nt][e], dpt[nt][e]);
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

template <typename T, int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Seq s = seq_of(p, blockIdx.z);
  const int n_n = (s.keys + kTileRows - 1) / kTileRows;
  for (int nb = blockIdx.x; nb < n_n; nb += gridDim.x) {
    dkv_tile<T, D, kSoftcap>(p, s, nb, blockIdx.y, smem_raw);
  }
}

template <typename T, int D, bool kSoftcap>
int launch_dkv_kernel(const BwdParams& p, int n_blocks, int hk, int batch,
                      cudaStream_t stream) {
  constexpr int kBQ = Tiles<D>::kInner;
  const size_t smem = (2 * kTileRows + 4 * kBQ) * (D + 8) * sizeof(T) +
                      4 * kBQ * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D, kSoftcap>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_blocks, hk, batch);
  flash_bwd_dkv_kernel<T, D, kSoftcap>
      <<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The softcap is a template parameter, as in the forward; n_blocks is the
// grid's first dimension (key tiles).
template <typename T, int D>
int launch(const BwdParams& p, int n_blocks, int hk, int batch,
           cudaStream_t s) {
  return p.has_softcap
             ? launch_dkv_kernel<T, D, true>(p, n_blocks, hk, batch, s)
             : launch_dkv_kernel<T, D, false>(p, n_blocks, hk, batch, s);
}

int dispatch(const BwdParams& p, int n_blocks, int hk, int batch, int d,
             int is_fp16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    if (d == 64) return launch<__half, 64>(p, n_blocks, hk, batch, s);
    if (d == 128) return launch<__half, 128>(p, n_blocks, hk, batch, s);
  } else {
    if (d == 64) return launch<__nv_bfloat16, 64>(p, n_blocks, hk, batch, s);
    if (d == 128) return launch<__nv_bfloat16, 128>(p, n_blocks, hk, batch, s);
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

void set_varlen(BwdParams& p, const int* cu_q, const int* cu_k,
                const int* used_q, const int* used_k, int total_q) {
  p.cu_q = cu_q;
  p.cu_k = cu_k;
  p.used_q = used_q;
  p.used_k = used_k;
  p.lse_h = total_q;
}

}  // namespace
