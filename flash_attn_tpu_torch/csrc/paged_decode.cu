// Paged causal attention of new query tokens against a paged KV pool:
// decode steps (sq = 1) and chunked-prefill steps (sq = prefill_chunk).
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_decode_multipage.py:65
// (_mp_decode_kernel, launched at :542 by flash_attention_decode_multipage).
// It computes the same function; the TPU schedule (super-block DMA ring,
// SMEM slot parity, byte-count semaphore waits, lane-replicated m/l
// scratch, row budgets) is not carried over.
//
// Function. Query row r of kv head g is query token t = r / group of query
// head g * group + r % group ("PackGQA": the group's heads share every K/V
// tile). Its absolute position is pos = seqlen - sq + t. Column c is
// visible iff c < seqlen, c <= pos and, with a window, c >= pos - window.
// Scores are s * scale, or tanh(s * scale / softcap) * softcap. Online
// softmax in fp32 (base 2); out = acc / l in q's type, lse = m + ln(l) in
// fp32, and a row with no visible column gives out 0 and lse -inf. Token c
// lives in page block_table[b, c / page_size], slot c % page_size.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): a decode step
// must read every visible K and V row once, hk * (d + dv) * 2 bytes per
// token, so it is bound by bytes. A prefill chunk does 4 * d flops for each
// visible (query head, query token, column) triple, at most
// 4 * sq * ctx * h * d, and is bound by the larger of its bytes at
// 3.35 TB/s and those flops at 989 TFLOP/s.
//
// Design. One block of 4 warps per (64 packed rows, kv head, batch row);
// each warp owns 16 rows. Q stays in registers as mma.sync A fragments.
// The block walks the visible KV range of its rows (from the window's first
// visible column, not from 0) in tiles of 64 tokens: K and V rows are
// gathered page by page through the block table straight into shared
// memory with 16-byte cp.async copies, double-buffered so the next tile
// loads while this one computes. S = Q K^T and O += P V run on
// mma.sync.m16n8k16 (bf16/fp16 in, fp32 accumulate), P is re-packed from
// the S accumulators without touching shared memory. Columns past the
// sequence, and pages outside the pool, are zero-filled rather than read.
// The pools are read through their (page, head, slot) strides, so vLLM's
// (num_blocks, page, hk, d) "phd" pools, viewed head-major as (num_blocks,
// hk, page, d), are taken without a copy, as are the two halves of a fused
// K|V pool.
//
// Known gap: a decode step (sq = 1) gives only b * hk blocks (64 at b = 8,
// hk = 8) for 132 SMs, and only one warp of each has rows to compute, so
// decode runs well under the bandwidth bound. Splitting the KV range over
// more blocks (split-KV with a combine pass) is the fix, for a later change.

#include "mma_utils.cuh"

namespace {

using namespace fa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = kWarps * 16;
constexpr int kTileN = 64;  // kv tokens per shared-memory tile

struct Params {
  const void* q;      // (b, sq, h, d)
  const void* k;      // K row of (page, head, slot) at page*k_page + head*k_head + slot*k_slot
  const void* v;      // V row likewise with the v_ strides
  void* out;          // (b, sq, h, d)
  float* lse;         // (b, h, sq)
  const int* seqlens; // (b,) total lengths, new tokens included
  const int* table;   // (b, max_pages)
  int sq, h, hk, group, page, max_pages, npages;
  long long k_page, k_head, v_page, v_head;  // element strides
  int k_slot32, v_slot32;  // slot strides: (page - 1) * them fits in 32 bits
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2
  // with a softcap (score_mul = scale / softcap, cap_log2 = softcap*log2 e).
  float score_mul, cap_log2;
  bool has_softcap;
  int window_left;
};

// Copies the K and V rows of kv tile `tile` of batch row b into smem
// stage `stage`: each thread one 16-byte column chunk of kPasses rows. The
// tile's block-table reads are all issued before its copies, one division
// per row gives both page and slot, and the offset within a page is 32-bit
// (the wrapper checks it fits). Rows past the sequence, and pages outside
// the pool, are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_kv_tile(const Params& p, const T* kbase,
                                             const T* vbase, T* sK, T* sV,
                                             int b, int seqlen, int tile,
                                             int stage, int tid) {
  constexpr int kStride = D + 8;
  constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
  constexpr int kRowsPerPass = kThreads / kChunksPerRow;
  constexpr int kPasses = kTileN / kRowsPerPass;
  const int part = tid % kChunksPerRow;
  const int tok0 = tid / kChunksPerRow;
  const int base = tile * kTileN;
  int page_id[kPasses];
  int slot[kPasses];
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int col = base + tok0 + i * kRowsPerPass;
    const int pidx = col / p.page;
    slot[i] = col - pidx * p.page;
    page_id[i] = col < seqlen && pidx < p.max_pages
                     ? __ldg(p.table + static_cast<long long>(b) * p.max_pages +
                             pidx)
                     : -1;
  }
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int tok = tok0 + i * kRowsPerPass;
    const bool ok = page_id[i] >= 0 && page_id[i] < p.npages;
    const long long pg = ok ? page_id[i] : 0;
    T* dk = sK + (stage * kTileN + tok) * kStride + part * 8;
    T* dv = sV + (stage * kTileN + tok) * kStride + part * 8;
    cp_async_16(dk, kbase + pg * p.k_page + slot[i] * p.k_slot32 + part * 8,
                ok ? 16 : 0);
    cp_async_16(dv, vbase + pg * p.v_page + slot[i] * p.v_slot32 + part * 8,
                ok ? 16 : 0);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const Params p) {
  constexpr int kStride = D + 8;  // padded smem row: conflict-free fragments
  constexpr int kKSteps = D / 16;
  constexpr int kNTiles = kTileN / 8;
  constexpr int kOTiles = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][kTileN][kStride]
  T* sV = sK + 2 * kTileN * kStride;       // [2][kTileN][kStride]

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rows_total = p.sq * p.group;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int seqlen = p.seqlens[b];

  // Visible KV range of this block's rows.
  const int row_last = min(row0 + kRowsPerBlock, rows_total) - 1;
  const int pos_first = seqlen - p.sq + row0 / p.group;
  const int pos_last = seqlen - p.sq + row_last / p.group;
  const int kv_lo = p.window_left >= 0 ? max(pos_first - p.window_left, 0) : 0;
  const int kv_hi = min(seqlen, pos_last + 1);
  const int tile_lo = kv_lo / kTileN;
  const int n_tiles =
      kv_hi > kv_lo ? (kv_hi - tile_lo * kTileN + kTileN - 1) / kTileN : 0;

  // This thread's two rows: gid and gid + 8 of the warp's 16.
  const int wrow0 = row0 + warp * 16;
  const bool warp_active = wrow0 < rows_total;
  int pos[2];
  const T* qrow[2];
  long long orow[2];
  int lse_idx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow0 + gid + 8 * i;
    if (r < rows_total) {
      const int t = r / p.group;
      const int head = g * p.group + r % p.group;
      pos[i] = seqlen - p.sq + t;
      orow[i] = ((static_cast<long long>(b) * p.sq + t) * p.h + head) * D;
      qrow[i] = static_cast<const T*>(p.q) + orow[i];
      lse_idx[i] = (b * p.h + head) * p.sq + t;
    } else {
      pos[i] = -1;  // sees no column; never stored
      orow[i] = -1;
      qrow[i] = nullptr;
      lse_idx[i] = -1;
    }
  }

  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T* src = qrow[j & 1];
      const int col = ks * 16 + tig * 2 + (j >> 1) * 8;
      qf[ks][j] = src ? *reinterpret_cast<const uint32_t*>(src + col) : 0u;
    }
  }

  float o[kOTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt) {
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  const T* kbase = static_cast<const T*>(p.k) + g * p.k_head;
  const T* vbase = static_cast<const T*>(p.v) + g * p.v_head;

  auto load_tile = [&](int tile, int stage) {
    load_kv_tile<T, D>(p, kbase, vbase, sK, sV, b, seqlen, tile, stage, tid);
  };

  if (n_tiles > 0) load_tile(tile_lo, 0);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_tile(tile_lo + it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    if (warp_active) {
      const T* ks_ptr = sK + stage * kTileN * kStride;
      const T* vs_ptr = sV + stage * kTileN * kStride;
      const int col0 = (tile_lo + it) * kTileN;

      float s[kNTiles][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const T* krow = ks_ptr + (nt * 8 + gid) * kStride + tig * 2;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + ks * 16);
          const uint32_t b1 =
              *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 8);
          Mma<T>::run(s[nt], qf[ks], b0, b1);
        }
      }

      // Scale (base 2), softcap, mask; visibility kept as bits.
      uint32_t vis = 0;
      float tmax[2] = {kMask, kMask};
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int col = col0 + nt * 8 + tig * 2 + (e & 1);
          float x = s[nt][e];
          x = p.has_softcap ? tanhf(x * p.score_mul) * p.cap_log2
                            : x * p.score_mul;
          const bool ok = col < seqlen && col <= pos[i] &&
                          (p.window_left < 0 || col >= pos[i] - p.window_left);
          if (ok) {
            vis |= 1u << (nt * 4 + e);
            tmax[i] = fmaxf(tmax[i], x);
          }
          s[nt][e] = x;
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(tmax[i]));
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float pe =
              (vis >> (nt * 4 + e)) & 1u ? exp2f(s[nt][e] - m[i]) : 0.f;
          l[i] += pe;
          s[nt][e] = pe;
        }
      }
#pragma unroll
      for (int nt = 0; nt < kOTiles; ++nt) {
        o[nt][0] *= alpha[0];
        o[nt][1] *= alpha[0];
        o[nt][2] *= alpha[1];
        o[nt][3] *= alpha[1];
      }

      // O += P V: P's A fragments come straight from the S accumulators.
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk) {
        uint32_t a[4];
        a[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
        a[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
        a[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const T* vrow = vs_ptr + (kk * 16 + tig * 2) * kStride + gid;
#pragma unroll
        for (int nt = 0; nt < kOTiles; ++nt) {
          const T* vc = vrow + nt * 8;
          const uint32_t b0 = pack_u16(vc, vc + kStride);
          const uint32_t b1 = pack_u16(vc + 8 * kStride, vc + 9 * kStride);
          Mma<T>::run(o[nt], a, b0, b1);
        }
      }
    }
    __syncthreads();
  }

  if (!warp_active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    if (orow[i] < 0) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    T* out = static_cast<T*>(p.out) + orow[i];
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt) {
      *reinterpret_cast<uint32_t*>(out + nt * 8 + tig * 2) =
          Mma<T>::pack(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
    }
    if (tig == 0) {
      p.lse[lse_idx[i]] =
          lsum > 0.f ? (m[i] + log2f(lsum)) * kLn2 : -INFINITY;
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = 2 * 2 * kTileN * (D + 8) * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq * p.group + kRowsPerBlock - 1) / kRowsPerBlock, p.hk,
                  batch);
  paged_decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pool_strides: 6 element strides, (page, head, slot) of the K pool, then
// of the V pool; (page - 1) * slot stride + 8 * d must fit in an int.
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported head
// dim / dtype. Launches on `stream`; does not synchronise.
extern "C" int paged_decode_fwd(const void* q, const void* k, const void* v,
                                void* out, float* lse, const int* seqlens,
                                const int* table, int batch, int sq, int h,
                                int hk, int d, int page, int max_pages,
                                int npages, const long long* pool_strides,
                                float scale, int window_left, float softcap,
                                int is_fp16, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.seqlens = seqlens;
  p.table = table;
  p.sq = sq;
  p.h = h;
  p.hk = hk;
  p.group = h / hk;
  p.page = page;
  p.max_pages = max_pages;
  p.npages = npages;
  p.k_page = pool_strides[0];
  p.k_head = pool_strides[1];
  p.k_slot32 = static_cast<int>(pool_strides[2]);
  p.v_page = pool_strides[3];
  p.v_head = pool_strides[4];
  p.v_slot32 = static_cast<int>(pool_strides[5]);
  p.has_softcap = softcap > 0.f;
  p.score_mul = p.has_softcap ? scale / softcap : scale * kLog2e;
  p.cap_log2 = softcap * kLog2e;
  p.window_left = window_left;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    if (d == 64) return launch<__half, 64>(p, batch, s);
    if (d == 128) return launch<__half, 128>(p, batch, s);
  } else {
    if (d == 64) return launch<__nv_bfloat16, 64>(p, batch, s);
    if (d == 128) return launch<__nv_bfloat16, 128>(p, batch, s);
  }
  return -1;
}
