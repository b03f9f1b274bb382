// The KV walk shared by the decode kernels (paged_decode.cu, decode.cu).
//
// A block of 4 warps holds 64 packed query rows of one kv head and batch
// row; each warp owns 16 of them, Q in registers as mma.sync A fragments.
// The block walks its KV tiles of 64 tokens, double-buffered in shared
// memory through 16-byte cp.async copies straight from the cache, and each
// kernel runs its own tile step (S = Q K^T, online softmax, O += P V) on
// every tile. The cache is a pool read through its (page, head, slot)
// strides: a paged cache through its block table, a contiguous one as a
// pool whose page is the whole row.

#pragma once

#include "mma_utils.cuh"

namespace fa {
namespace decode {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = kWarps * 16;
constexpr int kTileN = 64;  // kv tokens per shared-memory tile

// K row of (page, head, slot) at page*k_page + head*k_head + slot*k_slot32,
// V likewise with the v_ strides.
struct KvPool {
  const int* table;  // (b, max_pages), or null for a contiguous cache
  int page, max_pages, npages;
  long long k_page, k_head, v_page, v_head;  // element strides
  int k_slot32, v_slot32;  // slot strides: (page - 1) * them fits in 32 bits
};

// pool_strides: 6 element strides, (page, head, slot) of K, then of V.
inline KvPool make_pool(const int* table, int page, int max_pages, int npages,
                        const long long* pool_strides) {
  KvPool pool;
  pool.table = table;
  pool.page = page;
  pool.max_pages = max_pages;
  pool.npages = npages;
  pool.k_page = pool_strides[0];
  pool.k_head = pool_strides[1];
  pool.k_slot32 = static_cast<int>(pool_strides[2]);
  pool.v_page = pool_strides[3];
  pool.v_head = pool_strides[4];
  pool.v_slot32 = static_cast<int>(pool_strides[5]);
  return pool;
}

template <int D>
constexpr size_t smem_bytes(size_t elem) {
  return 2 * 2 * kTileN * (D + 8) * elem;  // K and V, two stages each
}

// Copies the K and V rows of kv tile `tile` into smem stage `stage`: each
// thread one 16-byte column chunk of kPasses rows. page_of(pidx) gives the
// page id of the pidx-th page of the sequence (a block-table read, or the
// cache row of a contiguous cache); the tile's page ids are all read before
// its copies, one division per row gives both page and slot. Rows at or
// past seqlen, and pages outside the pool, are zero-filled rather than
// read.
template <typename T, int D, typename PageOf>
__device__ __forceinline__ void load_kv_tile(const KvPool& pool,
                                             const T* kbase, const T* vbase,
                                             T* sK, T* sV, PageOf page_of,
                                             int seqlen, int tile, int stage,
                                             int tid) {
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
    const int pidx = col / pool.page;
    slot[i] = col - pidx * pool.page;
    page_id[i] = col < seqlen && pidx < pool.max_pages ? page_of(pidx) : -1;
  }
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int tok = tok0 + i * kRowsPerPass;
    const bool ok = page_id[i] >= 0 && page_id[i] < pool.npages;
    const long long pg = ok ? page_id[i] : 0;
    T* dk = sK + (stage * kTileN + tok) * kStride + part * 8;
    T* dv = sV + (stage * kTileN + tok) * kStride + part * 8;
    cp_async_16(dk,
                kbase + pg * pool.k_page + slot[i] * pool.k_slot32 + part * 8,
                ok ? 16 : 0);
    cp_async_16(dv,
                vbase + pg * pool.v_page + slot[i] * pool.v_slot32 + part * 8,
                ok ? 16 : 0);
  }
}

// The A fragments of a warp's 16 Q rows: this thread's rows gid and gid + 8
// start at element qrow[0] and qrow[1] of q, or hold zeros where -1.
template <typename T, int D>
__device__ __forceinline__ void load_q(const void* q, const long long (&qrow)[2],
                                       uint32_t (&qf)[D / 16][4], int tig) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long src = qrow[j & 1];
      const int col = ks * 16 + tig * 2 + (j >> 1) * 8;
      qf[ks][j] = src >= 0 ? ld_u32(static_cast<const T*>(q) + src + col) : 0u;
    }
  }
}

// The block's walk over n_tiles kv tiles of kv head g, tile_at(it) the
// index of the it-th, pages through page_of (as load_kv_tile): tile it + 1
// loads while compute(ks_ptr, vs_ptr, col0) runs tile it (on active warps
// only). Every thread of the block must call it.
template <typename T, int D, typename PageOf, typename TileAt,
          typename Compute>
__device__ __forceinline__ void walk_kv(const KvPool& pool, int g,
                                        PageOf page_of, int seqlen,
                                        const void* k, const void* v, T* sK,
                                        T* sV, int n_tiles, TileAt tile_at,
                                        bool warp_active, Compute compute,
                                        int tid) {
  constexpr int kStride = D + 8;
  const T* kbase = static_cast<const T*>(k) + g * pool.k_head;
  const T* vbase = static_cast<const T*>(v) + g * pool.v_head;
  auto load_tile = [&](int tile, int stage) {
    load_kv_tile<T, D>(pool, kbase, vbase, sK, sV, page_of, seqlen, tile,
                       stage, tid);
  };

  if (n_tiles > 0) load_tile(tile_at(0), 0);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_tile(tile_at(it + 1), stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    if (warp_active) {
      compute(sK + stage * kTileN * kStride, sV + stage * kTileN * kStride,
              tile_at(it) * kTileN);
    }
    __syncthreads();
  }
}

// Writes this thread's share of row i of O (o[.][2i..2i+1] times inv) to
// out in T.
template <typename T, int D>
__device__ __forceinline__ void store_row(T* out, const float (&o)[D / 8][4],
                                          int i, float inv, int tig) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(out + nt * 8 + tig * 2) =
        Mma<T>::pack(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
  }
}

}  // namespace decode
}  // namespace fa
