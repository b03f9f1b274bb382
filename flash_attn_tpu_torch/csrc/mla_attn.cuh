// MLA's absorbed-qv attention: the qv paths of TPU kernels 4 and 5 and
// kernel 1's qv forward, at MLA's widths (a 64-wide rope key beside a
// 512-wide latent that is both the second score operand and V).
//
// Replaces the qv paths of
//   flash_attn_tpu/kernels/flash_decode_multipage.py:65 (_mp_decode_kernel,
//     its qv term at :262), the engine's paged decode and prefill chunks;
//   flash_attn_tpu/kernels/flash_decode.py:56 (_decode_kernel, its qv term
//     at :187), decode over contiguous caches (generate);
//   flash_attn_tpu/kernels/flash_fwd.py:95 (_fwd_kernel, its qv term at
//     :291), the cache-free dense forward.
// Launched by csrc/mla_decode.cu (kernels 4 and 5) and csrc/flash_fwd_qv.cu
// (kernel 1), each with its own instances; the kernels that serve every
// other call are untouched.
//
// Function. Query row r of kv head g is query token t = r / group of query
// head g * group + r % group (PackGQA: the group shares every key). Its
// position is pos = seqlen - sq + t (bottom-right aligned). Key c is
// visible iff c < seqlen and, when causal, c <= pos. With C the latent
// (the V operand) and K the rope key:
//     S = Q K^T + Qv C^T      (kHasQv; without it S = Q K^T)
//     O = softmax(scale * S) C
// in fp32 (base-2 online softmax), out = O / l in q's type, lse = m + ln l
// in fp32; a row that sees no key gives out 0 and lse -inf.
//
// Addressing. Keys are read through (page, head, slot) strides of a K view
// and a V view: a fused rope|latent page pool is two views of one tensor
// (K at [0, 64), V at [128, 640)), split pools are two tensors, and a
// contiguous cache or a dense k/v is one "page" per batch row (kPaged
// false: the page is the batch row and the slot is the key). Pages outside
// the pool, and keys past the block's chunk, are zero-filled, not read; a
// length past the cache's max_pages * page keys sees only those keys, as
// the plain versions do.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense). A decode step
// reads each visible key's 64 + 512 elements once per batch row (1152
// bytes in bf16) and is bound by bytes. Per (query head, visible key) the
// score costs 2 (64 + 512) flops and P C 2 * 512; a prefill chunk of 256
// tokens x 16 heads (4096 rows) over a few thousand keys is bound by those
// flops.
//
// Design. One block per (64 packed rows and 16 warps, or 16 rows and 8
// warps for decode; a split; kv head and batch row). Q's row [q | qv] (576 elements) sits in
// shared memory for the block's life. Keys come in stages of 32, double
// buffered, each key's row [K | C] (576 elements, 1152 bytes) copied once
// by 16-byte cp.async and used for both products: that single read of the
// latent is what MLA exists for. Per stage:
//  * S on mma.sync.m16n8k16 from ldmatrix fragments: each warp takes a
//    (16-row tile, key group, slice of the 576-deep reduction) job and
//    writes its fp32 partial to shared memory (no atomics);
//  * the online softmax by all the block's threads, a few keys each: partials
//    summed, scaled, masked; P (q's type) and each row's rescale factor to
//    shared memory, m and l kept in registers;
//  * O += P C, the 512-wide accumulator split by columns: each warp owns
//    64 of them (32 at 64 rows) for every row, 32 fp32 registers a
//    thread, reading P and its own columns of C by ldmatrix (C transposed
//    in the load), so each element of C is read from shared memory once.
// Decode (sq * group <= 16 rows) runs split-KV: each split walks its chunk
// of the visible range in the 64-key tiles of kernel 4's schedule
// (kernels/flash_decode_multipage.py split_ranges), writes an fp32 partial
// normalised by its own sum and its LSE, and a combine kernel merges them
// in split order; the host picks the split count from shapes alone, so a
// captured CUDA graph stays valid for any lengths.

#pragma once

#include <type_traits>

#include "mma_utils.cuh"

namespace fa {
namespace mla {

constexpr int kD = 64;             // q / rope-key width
constexpr int kDV = 512;           // qv / latent width
constexpr int kKD = kD + kDV;      // a key row [K | C]
constexpr int kKvStride = kKD + 8; // padded: conflict-free ldmatrix rows
constexpr int kTileN = 32;         // keys per stage
constexpr int kPStride = kTileN + 8;
constexpr int kSStride = kTileN + 4;
constexpr int kCombineWarps = 8;
constexpr int kSplitTile = 64;     // kernel 4's split schedule tile

struct Params {
  const void* q;        // (b, ., h, d) through q_s*; rows of 64
  long long q_sb, q_sh, q_st;
  const void* qv;       // likewise, rows of 512 (kHasQv)
  long long qv_sb, qv_sh, qv_st;
  const void* k;        // K view: (page, head, slot) strides
  const void* v;        // V (latent) view
  long long k_sp, k_sh, k_ss, v_sp, v_sh, v_ss;
  const int* table;     // (b, max_pages) (kPaged)
  int page, max_pages, npages;
  const int* seqlens;   // (b,) total lengths, or null: seqlen_k for all
  int seqlen_k;
  void* out;            // (b, sq, h, 512) through o_s*
  long long o_sb, o_sh, o_st;
  float* lse;           // (b, h, sq)
  float* o_part;        // (splits, b, sq, h, 512) fp32 when num_splits > 1
  float* lse_part;      // (splits, b, h, sq)
  int num_splits;
  int batch, sq, h, hk, group;
  float score_mul;      // scale * log2(e)
  bool causal;
};

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The shape of one instance: 8 warps for 16 rows, 16 for 64 (so that each
// thread holds 32 fp32 of O, in at most 128 registers); its shared memory:
// Q rows, two key stages, the S partials, P, and each row's rescale factor
// and 1 / l.
template <int kRowTiles, bool kHasQv>
struct Smem {
  static constexpr int M = 16 * kRowTiles;
  static constexpr int kWarps = kRowTiles == 1 ? 8 : 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kColsPerWarp = kDV / kWarps;  // 64 or 32
  static constexpr int kQD = kHasQv ? kKD : kD;  // the score's depth
  static constexpr int kQStride = kQD + 8;
  // S jobs: (row tile, key group, slice of the depth), one per warp.
  static constexpr int kKeyGroups = 2;
  static constexpr int kKSplit = kWarps / (kRowTiles * kKeyGroups);
  static constexpr int kNK = kTileN / kKeyGroups;  // keys of a job
  static constexpr int kKSteps = kQD / 16 / kKSplit;
  static constexpr int q_bytes = M * kQStride * 2;
  static constexpr int kv_bytes = 2 * kTileN * kKvStride * 2;
  static constexpr int s_bytes = kKSplit * M * kSStride * 4;
  static constexpr int p_bytes = M * kPStride * 2;
  static constexpr int bytes = q_bytes + kv_bytes + s_bytes + p_bytes + 2 * M * 4;
  static_assert(kKSteps * 16 * kKSplit == kQD, "depth slices");
  static_assert(q_bytes % 16 == 0 && s_bytes % 16 == 0 && p_bytes % 16 == 0,
                "16-byte aligned sections");
};

template <typename T, int kRowTiles, bool kHasQv, bool kPaged>
__global__ void __launch_bounds__(Smem<kRowTiles, kHasQv>::kThreads,
                                  kRowTiles == 1 ? 2 : 1)
    mla_attn_kernel(const Params p) {
  using SM = Smem<kRowTiles, kHasQv>;
  constexpr int kThreads = SM::kThreads;
  constexpr int kColsPerWarp = SM::kColsPerWarp;
  constexpr int M = SM::M;
  constexpr int kQD = SM::kQD;
  constexpr int kQStride = SM::kQStride;
  constexpr int kTPR = kThreads / M;       // softmax threads per row
  constexpr int kKPT = kTileN / kTPR;      // softmax keys per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sKV = reinterpret_cast<T*>(smem_raw + SM::q_bytes);
  float* sS = reinterpret_cast<float*>(smem_raw + SM::q_bytes + SM::kv_bytes);
  T* sP = reinterpret_cast<T*>(smem_raw + SM::q_bytes + SM::kv_bytes +
                               SM::s_bytes);
  float* sAlpha = reinterpret_cast<float*>(
      smem_raw + SM::q_bytes + SM::kv_bytes + SM::s_bytes + SM::p_bytes);
  float* sInv = sAlpha + M;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int split = blockIdx.y;
  const int g = blockIdx.z % p.hk;
  const int b = blockIdx.z / p.hk;
  const int rows_total = p.sq * p.group;
  const int row0 = blockIdx.x * M;
  const int seqlen = p.seqlens ? p.seqlens[b] : p.seqlen_k;

  // The block's key chunk: its rows' visible range [0, hi), never past the
  // keys the cache holds (max_pages * page), split s taking the 64-key
  // tiles [s n / S, (s + 1) n / S) of the n.
  const int row_last = min(row0 + M, rows_total) - 1;
  const int pos_last = seqlen - p.sq + row_last / p.group;
  int hi = p.causal ? min(seqlen, pos_last + 1) : seqlen;
  hi = min(max(hi, 0), p.max_pages * p.page);
  int lo = 0;
  if (p.num_splits > 1) {
    const int n = (hi + kSplitTile - 1) / kSplitTile;
    lo = (split * n / p.num_splits) * kSplitTile;
    hi = min(hi, ((split + 1) * n / p.num_splits) * kSplitTile);
  }
  const int n_tiles = hi > lo ? (hi - lo + kTileN - 1) / kTileN : 0;

  // Q rows [q | qv] into shared memory (rows past the call zero-filled).
  {
    constexpr int kChunks = kQD / 8;
    const T* q = static_cast<const T*>(p.q);
    const T* qv = static_cast<const T*>(p.qv);
    for (int i = tid; i < M * kChunks; i += kThreads) {
      const int r = i / kChunks, part = i % kChunks;
      const int R = row0 + r;
      const bool ok = R < rows_total;
      const int t = ok ? R / p.group : 0;
      const int head = g * p.group + (ok ? R % p.group : 0);
      const T* src = part < kD / 8
          ? q + b * p.q_sb + head * p.q_sh + t * p.q_st + part * 8
          : qv + b * p.qv_sb + head * p.qv_sh + t * p.qv_st + (part - kD / 8) * 8;
      cp_async_16(sQ + r * kQStride + part * 8, ok ? src : q, ok ? 16 : 0);
    }
  }

  // One stage of keys [base, base + 32): each key's [K | C] row.
  auto load_tile = [&](int tile, int stage) {
    constexpr int kChunks = kKD / 8;  // 72
    const int base = lo + tile * kTileN;
    const T* kp = static_cast<const T*>(p.k);
    const T* vp = static_cast<const T*>(p.v);
    T* dst = sKV + stage * kTileN * kKvStride;
    for (int i = tid; i < kTileN * kChunks; i += kThreads) {
      const int key = i / kChunks, part = i % kChunks;
      const int c = base + key;
      bool ok = c < hi;
      long long pg = b, slot = c;
      if (kPaged) {
        const int pi = c / p.page;
        const int id = ok && pi < p.max_pages ? p.table[b * p.max_pages + pi] : -1;
        ok = ok && id >= 0 && id < p.npages;
        pg = id;
        slot = c % p.page;
      }
      const T* src = part < kD / 8
          ? kp + pg * p.k_sp + g * p.k_sh + slot * p.k_ss + part * 8
          : vp + pg * p.v_sp + g * p.v_sh + slot * p.v_ss + (part - kD / 8) * 8;
      cp_async_16(dst + key * kKvStride + part * 8, ok ? src : kp, ok ? 16 : 0);
    }
  };

  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  // Softmax state of row sm_row, held alike by its kTPR threads.
  const int sm_row = tid / kTPR;
  const int sm_sub = tid % kTPR;
  const int sm_R = row0 + sm_row;
  const int sm_pos = seqlen - p.sq + sm_R / p.group;
  float m_run = -INFINITY, l_run = 0.f;

  // O: this warp's kColsPerWarp columns of every row.
  float acc[kRowTiles][kColsPerWarp / 8][4];
#pragma unroll
  for (int rt = 0; rt < kRowTiles; ++rt)
#pragma unroll
    for (int n = 0; n < kColsPerWarp / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][n][e] = 0.f;

  // This warp's S job.
  const int job_rt = warp % kRowTiles;
  const int job_kg = (warp / kRowTiles) % SM::kKeyGroups;
  const int job_ks = warp / (kRowTiles * SM::kKeyGroups);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_0();
    __syncthreads();  // stage it landed; the last stage's readers are done
    if (it + 1 < n_tiles) load_tile(it + 1, (it + 1) & 1);
    cp_async_commit();
    const T* kv = sKV + (it & 1) * kTileN * kKvStride;

    // S partial of this warp's job.
    {
      float s[SM::kNK / 8][4];
#pragma unroll
      for (int n = 0; n < SM::kNK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const int key0 = job_kg * SM::kNK;
#pragma unroll 3
      for (int kk = 0; kk < SM::kKSteps; ++kk) {
        const int dim0 = (job_ks * SM::kKSteps + kk) * 16;
        uint32_t a[4];
        ldsm_x4(a, sQ + (job_rt * 16 + (lane & 15)) * kQStride + dim0 +
                       (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < SM::kNK / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, kv + (key0 + np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                               kKvStride + dim0 + ((lane >> 3) & 1) * 8);
          Mma<T>::run(s[2 * np], a, bb[0], bb[1]);
          Mma<T>::run(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      float* dst = sS + (job_ks * M + job_rt * 16) * kSStride + key0 + 2 * tig;
#pragma unroll
      for (int n = 0; n < SM::kNK / 8; ++n) {
        *reinterpret_cast<float2*>(dst + gid * kSStride + n * 8) =
            make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(dst + (gid + 8) * kSStride + n * 8) =
            make_float2(s[n][2], s[n][3]);
      }
    }
    __syncthreads();

    // Online softmax over this stage, kKPT keys per thread.
    {
      const int base = lo + it * kTileN;
      float x[kKPT];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const int key = sm_sub * kKPT + j;
        float acc_s = 0.f;
#pragma unroll
        for (int ks = 0; ks < SM::kKSplit; ++ks)
          acc_s += sS[(ks * M + sm_row) * kSStride + key];
        const int c = base + key;
        const bool vis = sm_R < rows_total && c < hi && (!p.causal || c <= sm_pos);
        x[j] = vis ? acc_s * p.score_mul : -INFINITY;
        mx = fmaxf(mx, x[j]);
      }
#pragma unroll
      for (int o = 1; o < kTPR; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run - m_use);
      float sum = 0.f;
      T* prow = sP + sm_row * kPStride + sm_sub * kKPT;
#pragma unroll
      for (int j = 0; j < kKPT; j += 2) {
        const float p0 = exp2f(x[j] - m_use);
        const float p1 = exp2f(x[j + 1] - m_use);
        sum += p0 + p1;
        *reinterpret_cast<uint32_t*>(prow + j) = Mma<T>::pack(p0, p1);
      }
#pragma unroll
      for (int o = 1; o < kTPR; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (sm_sub == 0) sAlpha[sm_row] = alpha;
    }
    __syncthreads();

    // O = alpha O + P C over this warp's kColsPerWarp columns.
#pragma unroll
    for (int rt = 0; rt < kRowTiles; ++rt) {
      const float a0 = sAlpha[rt * 16 + gid];
      const float a1 = sAlpha[rt * 16 + gid + 8];
#pragma unroll
      for (int n = 0; n < kColsPerWarp / 8; ++n) {
        acc[rt][n][0] *= a0;
        acc[rt][n][1] *= a0;
        acc[rt][n][2] *= a1;
        acc[rt][n][3] *= a1;
      }
    }
    const int col0 = kD + warp * kColsPerWarp;
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk) {
      uint32_t bb[kColsPerWarp / 16][4];
#pragma unroll
      for (int np = 0; np < kColsPerWarp / 16; ++np)
        ldsm_x4_t(bb[np], kv + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   kKvStride + col0 + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int rt = 0; rt < kRowTiles; ++rt) {
        uint32_t a[4];
        ldsm_x4(a, sP + (rt * 16 + (lane & 15)) * kPStride + kk * 16 +
                       (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < kColsPerWarp / 16; ++np) {
          Mma<T>::run(acc[rt][2 * np], a, bb[np][0], bb[np][1]);
          Mma<T>::run(acc[rt][2 * np + 1], a, bb[np][2], bb[np][3]);
        }
      }
    }
  }
  cp_async_wait_0();

  // Each row's 1 / l and its LSE (of the split's chunk with splits).
  const bool split_out = p.num_splits > 1;
  if (sm_sub == 0) {
    sInv[sm_row] = l_run > 0.f ? 1.f / l_run : 0.f;
    if (sm_R < rows_total) {
      const int t = sm_R / p.group;
      const int head = g * p.group + sm_R % p.group;
      const float lse = l_run > 0.f ? (m_run + __log2f(l_run)) * kLn2 : -INFINITY;
      const long long li = (static_cast<long long>(b) * p.h + head) * p.sq + t;
      if (split_out) {
        p.lse_part[static_cast<long long>(split) * p.batch * p.h * p.sq + li] = lse;
      } else {
        p.lse[li] = lse;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int rt = 0; rt < kRowTiles; ++rt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rt * 16 + gid + half * 8;
      const int R = row0 + r;
      if (R >= rows_total) continue;
      const float inv = sInv[r];
      const int t = R / p.group;
      const int head = g * p.group + R % p.group;
      const int col = warp * kColsPerWarp + 2 * tig;
      if (split_out) {
        float* dst = p.o_part +
            ((((static_cast<long long>(split) * p.batch + b) * p.sq + t) * p.h +
              head) * kDV) + col;
#pragma unroll
        for (int n = 0; n < kColsPerWarp / 8; ++n)
          *reinterpret_cast<float2*>(dst + n * 8) =
              make_float2(acc[rt][n][2 * half] * inv, acc[rt][n][2 * half + 1] * inv);
      } else {
        T* dst = static_cast<T*>(p.out) + b * p.o_sb + head * p.o_sh +
                 t * p.o_st + col;
#pragma unroll
        for (int n = 0; n < kColsPerWarp / 8; ++n)
          *reinterpret_cast<uint32_t*>(dst + n * 8) = Mma<T>::pack(
              acc[rt][n][2 * half] * inv, acc[rt][n][2 * half + 1] * inv);
      }
    }
  }
}

// Merges the splits' partials in split order (as combine_partials does):
// one warp per output row (b, t, head), 16 columns a lane.
template <typename T>
__global__ void __launch_bounds__(32 * kCombineWarps)
    mla_combine_kernel(const Params p) {
  constexpr int kPer = kDV / 32;
  const int rows = p.batch * p.sq * p.h;
  const int row = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int head = row % p.h;
  const int bt = row / p.h;  // b * sq + t
  const int b = bt / p.sq, t = bt % p.sq;
  const long long lrow = (static_cast<long long>(b) * p.h + head) * p.sq + t;
  const long long lstride = static_cast<long long>(p.batch) * p.h * p.sq;
  float mx = -INFINITY;
  for (int s = 0; s < p.num_splits; ++s)
    mx = fmaxf(mx, p.lse_part[s * lstride + lrow]);
  float acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc[c] = 0.f;
  float den = 0.f;
  if (mx > -INFINITY) {
    for (int s = 0; s < p.num_splits; ++s) {
      const float ls = p.lse_part[s * lstride + lrow];
      const float w = ls > -INFINITY ? expf(ls - mx) : 0.f;
      den += w;
      const float* src = p.o_part +
          (static_cast<long long>(s) * rows + row) * kDV + lane * kPer;
#pragma unroll
      for (int c = 0; c < kPer; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(src + c);
        acc[c] += w * x.x;
        acc[c + 1] += w * x.y;
        acc[c + 2] += w * x.z;
        acc[c + 3] += w * x.w;
      }
    }
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  T* dst = static_cast<T*>(p.out) + b * p.o_sb + head * p.o_sh + t * p.o_st +
           lane * kPer;
#pragma unroll
  for (int c = 0; c < kPer; c += 2)
    *reinterpret_cast<uint32_t*>(dst + c) =
        Mma<T>::pack(acc[c] * inv, acc[c + 1] * inv);
  if (lane == 0) p.lse[lrow] = den > 0.f ? mx + logf(den) : -INFINITY;
}

// Launches the attention kernel (and, with more than one split, the
// combine) on `stream`: 16-row tiles for calls of at most 16 packed rows,
// else 64-row tiles, which take one split. Returns 0, a cudaError_t, or -3
// for splits the call cannot take.
template <typename T, bool kHasQv, bool kPaged>
int launch(const Params& p, cudaStream_t stream) {
  const int rows = p.sq * p.group;
  if (p.num_splits < 1 || (p.num_splits > 1 && (!p.o_part || !p.lse_part)))
    return -3;
  if (p.batch == 0 || rows == 0) return 0;
  auto run = [&](auto tiles) -> int {
    constexpr int kRowTiles = decltype(tiles)::value;
    using SM = Smem<kRowTiles, kHasQv>;
    auto* kernel = mla_attn_kernel<T, kRowTiles, kHasQv, kPaged>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SM::bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((rows + SM::M - 1) / SM::M, p.num_splits, p.batch * p.hk);
    kernel<<<grid, SM::kThreads, SM::bytes, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess || p.num_splits == 1) return static_cast<int>(err);
    const int out_rows = p.batch * p.sq * p.h;
    mla_combine_kernel<T><<<(out_rows + kCombineWarps - 1) / kCombineWarps,
                            32 * kCombineWarps, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  };
  if (rows <= 16) return run(std::integral_constant<int, 1>());
  if (p.num_splits != 1) return -3;
  return run(std::integral_constant<int, 4>());
}

}  // namespace mla
}  // namespace fa
