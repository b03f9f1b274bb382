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
//
// The cache's element type KV is q's 16-bit type T, or one byte: int8 or
// fp8 e4m3 (a quantized cache, x = x_q * descale per kv head). 1-byte tiles
// are copied to shared memory as they are, at half the bytes, and upcast
// to T exactly (every int8 and every e4m3 value is a bf16 and an fp16
// value). The split-KV kernels upcast each mma.sync B fragment just before
// its product (ldmatrix cannot widen: u16 and byte loads in place of u32
// and u16 ones); the walk of the rows kernels (walk_kv) upcasts each tile
// once into a T tile for all four warps, which read it as a 16-bit tile.

#pragma once

#include <cuda_fp8.h>

#include <type_traits>

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

// Elements of a shared-memory tile row: D and a 16-byte pad (conflict-free
// fragment reads, 16-byte aligned rows for cp.async).
template <int D>
__host__ __device__ constexpr int row_stride(size_t elem) {
  return D + 16 / static_cast<int>(elem);
}

// walk_kv's shared memory: K and V, two stages each, and for a 1-byte
// cache one K and one V tile upcast to 16 bits.
template <int D>
__host__ __device__ constexpr size_t smem_bytes(size_t elem) {
  return 2 * 2 * kTileN * row_stride<D>(elem) * elem +
         (elem == 1 ? 2 * kTileN * row_stride<D>(2) * 2 : 0);
}

// Cache kinds: the element type (q's own, int8, e4m3), and the C entries'
// code for each.
enum KvKind { kKvSame = 0, kKvInt8 = 1, kKvE4m3 = 2 };

template <typename T, int kKind>
struct KvType {
  using type = T;
};
template <typename T>
struct KvType<T, kKvInt8> {
  using type = int8_t;
};
template <typename T>
struct KvType<T, kKvE4m3> {
  using type = __nv_fp8_e4m3;
};

// Two 1-byte cache values (the low byte first) as two T values packed in a
// u32, the low half first: exact.
template <typename T, typename KV>
__device__ __forceinline__ uint32_t upcast2(uint32_t two) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    // x + 128 (the sign bit flipped) as the low mantissa byte of
    // 2^23 = 0x4B000000: the float 2^23 + 128 + x, less 2^23 + 128, is x,
    // exactly. One LOP3, two PRMT and two FADD in place of two I2F, which
    // run at a quarter of their rate.
    const uint32_t u = two ^ 0x8080u;
    const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) -
                     8388736.f;
    const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) -
                     8388736.f;
    return Mma<T>::pack(lo, hi);
  } else {
    // cvt.rn.f16x2.e4m3x2; then f16 -> f32 -> bf16, exact, for bf16.
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
    if constexpr (std::is_same<T, __half>::value) {
      return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
    } else {
      const float2 f = __half22float2(__half2(h));
      return Mma<T>::pack(f.x, f.y);
    }
  }
}

// mma.sync B fragments read from a tile of KV elements, as T.
template <typename T, typename KV>
struct Frag {
  // S = Q K^T: elements c and c + 1 of one K row.
  static __device__ __forceinline__ uint32_t k2(const KV* p) {
    if constexpr (sizeof(KV) == 2) {
      return ld_u32(p);
    } else {
      return upcast2<T, KV>(*reinterpret_cast<const uint16_t*>(p));
    }
  }
  // O += P V: one column of two neighbouring V rows.
  static __device__ __forceinline__ uint32_t v2(const KV* lo, const KV* hi) {
    if constexpr (sizeof(KV) == 2) {
      return pack_u16(lo, hi);
    } else {
      return upcast2<T, KV>(
          static_cast<uint32_t>(*reinterpret_cast<const uint8_t*>(lo)) |
          (static_cast<uint32_t>(*reinterpret_cast<const uint8_t*>(hi)) << 8));
    }
  }
};

// A quantized cache's dequant scales for batch row b and kv head g: K's
// folds into the score multiplier, V's into the output scale (of each
// split's partial, never again in a combine). (hk,) scales pass
// bstride 0, (b, hk) ones bstride hk.
struct Descales {
  const float* k;
  const float* v;
  int bstride;
  __device__ __forceinline__ float k_of(int b, int g) const {
    return k[b * bstride + g];
  }
  __device__ __forceinline__ float v_of(int b, int g) const {
    return v[b * bstride + g];
  }
};

// The score multiplier and the output scale of batch row b and kv head g.
// A scaled instance (kScaled: a 1-byte cache, or one given descales) folds
// K's descale into the multiplier and V's into the output scale; the others
// read neither and take the kernel's multiplier as it is.
template <bool kScaled>
struct Fold {
  float kmul = 0.f, vmul = 0.f;
  __device__ __forceinline__ Fold(const Descales& ds, float score_mul, int b,
                                  int g) {
    if constexpr (kScaled) {
      kmul = score_mul * ds.k_of(b, g);
      vmul = ds.v_of(b, g);
    }
  }
  __device__ __forceinline__ float mul(float score_mul) const {
    if constexpr (kScaled) {
      return kmul;
    } else {
      return score_mul;
    }
  }
  __device__ __forceinline__ void scale(float& inv) const {
    if constexpr (kScaled) inv *= vmul;
  }
};

// Copies the K and V rows of kv tile `tile` into smem stage `stage`: each
// thread one 16-byte column chunk of kPasses rows. page_of(pidx) gives the
// page id of the pidx-th page of the sequence (a block-table read, or the
// cache row of a contiguous cache); the tile's page ids are all read before
// its copies, one division per row gives both page and slot. Rows at or
// past seqlen, and pages outside the pool, are zero-filled rather than
// read.
template <typename T, int D, typename KV, typename PageOf>
__device__ __forceinline__ void load_kv_tile(const KvPool& pool,
                                             const KV* kbase, const KV* vbase,
                                             KV* sK, KV* sV, PageOf page_of,
                                             int seqlen, int tile, int stage,
                                             int tid) {
  constexpr int kChunk = 16 / sizeof(KV);  // elements of a 16-byte chunk
  constexpr int kStride = D + kChunk;
  constexpr int kChunksPerRow = D / kChunk;
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
    KV* dk = sK + (stage * kTileN + tok) * kStride + part * kChunk;
    KV* dv = sV + (stage * kTileN + tok) * kStride + part * kChunk;
    cp_async_16(
        dk, kbase + pg * pool.k_page + slot[i] * pool.k_slot32 + part * kChunk,
        ok ? 16 : 0);
    cp_async_16(
        dv, vbase + pg * pool.v_page + slot[i] * pool.v_slot32 + part * kChunk,
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

// A 1-byte tile of kTileN rows (stride row_stride<D>(1)) upcast to T
// (stride row_stride<D>(2)) by the whole block, 16 values per step.
template <typename T, int D, typename KV>
__device__ __forceinline__ void upcast_tile(const KV* src, T* dst, int tid) {
  constexpr int kParts = D / 16;
  for (int c = tid; c < kTileN * kParts; c += kThreads) {
    const int row = c / kParts;
    const int part = c - row * kParts;
    const uint4 in = *reinterpret_cast<const uint4*>(
        src + row * row_stride<D>(1) + part * 16);
    const uint32_t w[4] = {in.x, in.y, in.z, in.w};
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[2 * j] = upcast2<T, KV>(w[j] & 0xffffu);
      o[2 * j + 1] = upcast2<T, KV>(w[j] >> 16);
    }
    uint4* out = reinterpret_cast<uint4*>(dst + row * row_stride<D>(2) +
                                          part * 16);
    out[0] = make_uint4(o[0], o[1], o[2], o[3]);
    out[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// The block's walk over n_tiles kv tiles of kv head g, tile_at(it) the
// index of the it-th, pages through page_of (as load_kv_tile): tile it + 1
// loads while compute(ks_ptr, vs_ptr, col0) runs tile it (on active warps
// only). Every thread of the block must call it. compute's tiles are KV
// tiles, or for a 1-byte cache T tiles upcast from them (smem_bytes).
template <typename T, int D, typename KV, typename PageOf, typename TileAt,
          typename Compute>
__device__ __forceinline__ void walk_kv(const KvPool& pool, int g,
                                        PageOf page_of, int seqlen,
                                        const void* k, const void* v, KV* sK,
                                        KV* sV, int n_tiles, TileAt tile_at,
                                        bool warp_active, Compute compute,
                                        int tid) {
  constexpr int kStride = row_stride<D>(sizeof(KV));
  const KV* kbase = static_cast<const KV*>(k) + g * pool.k_head;
  const KV* vbase = static_cast<const KV*>(v) + g * pool.v_head;
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
    if constexpr (sizeof(KV) == 1) {
      T* tK = reinterpret_cast<T*>(sV + 2 * kTileN * kStride);
      T* tV = tK + kTileN * row_stride<D>(2);
      upcast_tile<T, D>(sK + stage * kTileN * kStride, tK, tid);
      upcast_tile<T, D>(sV + stage * kTileN * kStride, tV, tid);
      __syncthreads();
      if (warp_active) compute(tK, tV, tile_at(it) * kTileN);
    } else {
      if (warp_active) {
        compute(sK + stage * kTileN * kStride, sV + stage * kTileN * kStride,
                tile_at(it) * kTileN);
      }
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
