// Block-sparse attention backward: kernel 11 (dQ and delta, Q-stationary,
// over the forward's lists; its function, bound and design are in
// csrc/block_sparse_bwd_sm90.cuh) and kernel 10 (dK/dV, KV-stationary, over
// the inverse lists), from Q, K, V, dO and the forward's log-sum-exp.
//
// Kernel 10 replaces the TPU kernel
// flash_attn_tpu/kernels/block_sparsity.py:807 (_bs_dkv_kernel, launched at
// :1094 by flash_attention_blocksparse_bwd :996), restricted to the
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
// (query head, row, column) triple, dK/dV 8 * d flops (S, dP, dV, dK)
// against its inputs read and outputs written once; the larger of the two.
//
// Design of kernel 10 (simple first), the dense backward's tile step
// written out on its own. Deterministic: no atomics; every output element
// is summed by one thread in a fixed order. One block of 4 warps per (64
// key rows, kv head, batch row); K and V stay in shared memory; the block
// walks, for each query head of the group in turn, that head's inverse list
// of 64-row blocks, with Q, dO, lse, delta and the rows' words
// double-buffered; dK and dV accumulate in fp32 registers and are written
// once. At head dim 128 the walked tiles are 32 wide (two halves of a
// 64-wide sub-tile, each with its half of the words) to keep the
// accumulators in registers.

#include "block_sparse.cuh"
#include "block_sparse_bwd_sm90.cuh"

namespace {

using namespace fa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = bs::kSub;  // key rows

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
  const float* delta;  // (b, h, sq), from the dQ kernel
  void* dk;          // (b, hk, sk, d)
  void* dv;          // (b, hk, sk, d)
  // Element strides (batch, head, seq).
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, do_b, do_h, do_s;
  long long dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  int h, group, sq, sk, nqb, nkb;
  float scale;
  // Score in base 2 as in the forward.
  float score_mul, cap_log2;
  // The inverse lists, per (b, query head, 64-key block) at row (b * h +
  // head) * nkb + block, list_len entries a row, counts[row] used.
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

template <typename T, int D, bool kSoftcap>
int launch(const Params& p, int n_blocks, int heads, int batch,
           cudaStream_t stream) {
  constexpr int kInner = Tiles<D>::kInner;
  const size_t smem = (2 * kTileRows + 4 * kInner) * (D + 8) * sizeof(T) +
                      4 * kInner * sizeof(float) +
                      2 * kInner * sizeof(unsigned long long);
  const auto kernel = block_sparse_dkv_kernel<T, D, kSoftcap>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_blocks, heads, batch), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The softcap is a template parameter, as in the forward; n_blocks and
// heads are the grid's first two dimensions.
int dispatch(const Params& p, bool softcap, int n_blocks, int heads,
             int batch, int d, int is_fp16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    if (d == 64)
      return softcap ? launch<__half, 64, true>(p, n_blocks, heads, batch, s)
                     : launch<__half, 64, false>(p, n_blocks, heads, batch, s);
    if (d == 128)
      return softcap ? launch<__half, 128, true>(p, n_blocks, heads, batch, s)
                     : launch<__half, 128, false>(p, n_blocks, heads, batch, s);
  } else {
    if (d == 64)
      return softcap
                 ? launch<__nv_bfloat16, 64, true>(p, n_blocks, heads, batch, s)
                 : launch<__nv_bfloat16, 64, false>(p, n_blocks, heads, batch, s);
    if (d == 128)
      return softcap
                 ? launch<__nv_bfloat16, 128, true>(p, n_blocks, heads, batch, s)
                 : launch<__nv_bfloat16, 128, false>(p, n_blocks, heads, batch, s);
  }
  return -1;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
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
// strides (batch, head, seq) of q, k, v, dout, dq; those of q, k, v and
// dout and the base pointers must be multiples of 16 bytes (TMA), those of
// dq multiples of 2 elements. lse (b, h, sq) fp32. counts (b, h, cdiv(sq,
// 64)); tiles and wofs hold list_len entries per count (the forward's
// lists); words the mode-2 groups of 64 words, on a 16-byte aligned base.
// Writes dq and delta (b, h, sq) fp32 = sum_j P dP, every row. Returns 0,
// a cudaError_t from the launch, -1 for an unsupported head dim, or -2 if
// cuTensorMapEncodeTiled refuses a tensor map. Launches on `stream`; does
// not synchronise.
extern "C" int block_sparse_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, const long long* strides,
    const int* counts, const int* tiles, const int* wofs,
    const unsigned long long* words, long long list_len, int batch, int h,
    int hk, int sq, int sk, int d, float scale, float softcap, int is_fp16,
    void* stream) {
  namespace f = fa::bsbwd90;
  using fa::sm90::make_map;
  if (d != 64 && d != 128) return -1;
  CUtensorMap maps[4];
  if (make_map(maps + 0, q, is_fp16, d, sq, h, batch, strides[2], strides[1],
               strides[0], f::kBlockRows) ||
      make_map(maps + 1, dout, is_fp16, d, sq, h, batch, strides[11],
               strides[10], strides[9], f::kBlockRows) ||
      make_map(maps + 2, k, is_fp16, d, sk, hk, batch, strides[5], strides[4],
               strides[3], f::kTile) ||
      make_map(maps + 3, v, is_fp16, d, sk, hk, batch, strides[8], strides[7],
               strides[6], f::kTile)) {
    return -2;
  }
  f::Params p = {};
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dq_b = strides[12];
  p.dq_h = strides[13];
  p.dq_s = strides[14];
  p.h = h;
  p.group = h / hk;
  p.sq = sq;
  p.sk = sk;
  p.nqb = (sq + f::kTile - 1) / f::kTile;
  p.scale = scale;
  const bool cap = softcap > 0.f;
  p.score_mul = cap ? scale / softcap : scale * fa::kLog2e;
  p.cap_log2 = softcap * fa::kLog2e;
  p.counts = counts;
  p.tiles = tiles;
  p.wofs = wofs;
  p.words = words;
  p.list_len = list_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return d == 64 ? f::launch_softcap<__half, 64>(maps, p, cap, batch, s)
                   : f::launch_softcap<__half, 128>(maps, p, cap, batch, s);
  }
  return d == 64 ? f::launch_softcap<__nv_bfloat16, 64>(maps, p, cap, batch, s)
                 : f::launch_softcap<__nv_bfloat16, 128>(maps, p, cap, batch,
                                                         s);
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
  return dispatch(p, softcap > 0.f, p.nkb, hk, batch, d, is_fp16, stream);
}
