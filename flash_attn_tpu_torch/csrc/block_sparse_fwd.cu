// Block-sparse attention forward (kernel 9): out = softmax(scale * Q K^T
// restricted to a plan's kept elements) V, and the fp32 log-sum-exp of
// every query row.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/block_sparsity.py:455
// (_bs_fwd_kernel, launched at :718 by flash_attention_blocksparse_fwd
// :627), restricted to mask_mod plans: scale, softcap, GQA/MQA, head dim 64
// or 128, bf16/fp16. The TPU schedule (a flat host worklist of plan tiles
// with chain flags, 128-lane padding, lane-replicated m/l scratch, the mod
// evaluated inside the kernel) is not carried over: a CUDA kernel cannot
// call the Python mod, so the mod's result arrives as per-row words
// (csrc/block_sparse.cuh).
//
// Function. Query row i of head hq sees key column j of kv head hq / (h /
// hk) iff (i, j) is kept: its 64 x 64 sub-tile is on the row block's list
// and its mode keeps it (csrc/block_sparse.cuh). Scores are s * scale, or
// tanh(s * scale / softcap) * softcap. Online softmax in fp32 (base 2).
// out = acc / l in q's type; lse = m + ln(l), natural log; a row that sees
// nothing gives out 0, lse -inf. Every row below seqlen_q is written.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * d flops
// per kept (query head, row, column) triple against q, k, v and out moved
// once; the kernel computes whole 64 x 64 sub-tiles, of which the kept
// elements count.
//
// Design (simple first; no wgmma/TMA yet), that of the dense forward's
// tile step (csrc/flash_fwd_tile.cuh) written out on its own, so the dense
// kernels' code is untouched: one block of 4 warps per (64 query rows,
// query head, batch row), each warp owning 16 rows with Q in registers as
// mma.sync A fragments; the block walks its listed key tiles with K and V
// double-buffered by 16-byte cp.async. Each thread reads the words of its
// two rows for a tile while the tile's copies land, and masks an element
// by one bit test. S = Q K^T and O += P V run on mma.sync.m16n8k16 with
// fp32 accumulation.

#include "block_sparse.cuh"

namespace {

using namespace fa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = bs::kSub;  // query rows per block, key columns per tile

struct Params {
  const void* q;  // (b, h, sq, d)
  const void* k;  // (b, hk, sk, d)
  const void* v;
  void* out;   // as q
  float* lse;  // (b, h, sq), contiguous
  // Element strides (batch, head, seq).
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  int h, group, sq, sk, nqb;
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2.
  float score_mul, cap_log2;
  // Lists of list_len entries per (b, head, 64-row block), at row
  // (b * h + head) * nqb + block; counts[row] of them used.
  const int* counts;
  const int* tiles;
  const int* wofs;
  const unsigned long long* words;
  long long list_len;
};

template <typename T, int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads) block_sparse_fwd_kernel(
    const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kStride = D + 8;  // padded smem row: conflict-free fragments
  constexpr int kKSteps = D / 16;
  constexpr int kNTiles = kTile / 8;
  constexpr int kOTiles = D / 8;
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][kTile][kStride]
  T* sV = sK + 2 * kTile * kStride;        // [2][kTile][kStride]

  const int m_block = blockIdx.x;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int g = head / p.group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int row0 = m_block * kTile;

  const long long lrow =
      (static_cast<long long>(b) * p.h + head) * p.nqb + m_block;
  const long long lbase = lrow * p.list_len;
  const int n_tiles = p.counts[lrow];

  // This thread's two rows: gid and gid + 8 of the warp's 16.
  int r_local[2], row[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r_local[i] = warp * 16 + gid + 8 * i;
    row[i] = row0 + r_local[i];
    row_ok[i] = row[i] < p.sq;
  }

  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j & 1;
      const int col = ks * 16 + tig * 2 + (j >> 1) * 8;
      qf[ks][j] = row_ok[i]
                      ? ld_u32(static_cast<const T*>(p.q) + b * p.q_b +
                               head * p.q_h +
                               static_cast<long long>(row[i]) * p.q_s + col)
                      : 0u;
    }
  }

  float o[kOTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt) {
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  const T* kbase = static_cast<const T*>(p.k) + b * p.k_b + g * p.k_h;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_b + g * p.v_h;
  auto tile_of = [&](int x) { return __ldg(p.tiles + lbase + x) >> 2; };
  // One 16-byte chunk per thread and pass; key rows past sk zero-filled.
  constexpr int kChunksPerRow = D / 8;
  auto load_tile = [&](int tile, int stage) {
    for (int c = tid; c < kTile * kChunksPerRow; c += kThreads) {
      const int tok = c / kChunksPerRow;
      const int ofs = (c % kChunksPerRow) * 8;
      const int col = tile * kTile + tok;
      const long long src = max(min(col, p.sk - 1), 0);
      const int bytes = col < p.sk ? 16 : 0;
      cp_async_16(sK + (stage * kTile + tok) * kStride + ofs,
                  kbase + src * p.k_s + ofs, bytes);
      cp_async_16(sV + (stage * kTile + tok) * kStride + ofs,
                  vbase + src * p.v_s + ofs, bytes);
    }
  };

  if (n_tiles > 0) load_tile(tile_of(0), 0);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_tile(tile_of(it + 1), stage ^ 1);
    cp_async_commit();
    const int ent = __ldg(p.tiles + lbase + it);
    const int col0 = (ent >> 2) * kTile;
    unsigned long long w[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      w[i] = bs::row_word(ent & 3, __ldg(p.wofs + lbase + it), row[i],
                          r_local[i], col0, p.sq, p.sk, p.words);
    }
    cp_async_wait_1();
    __syncthreads();

    const T* ks_ptr = sK + stage * kTile * kStride;
    const T* vs_ptr = sV + stage * kTile * kStride;
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const T* krow = ks_ptr + (nt * 8 + gid) * kStride + tig * 2;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        Mma<T>::run(s[nt], qf[ks], ld_u32(krow + ks * 16),
                    ld_u32(krow + ks * 16 + 8));
      }
    }

    // Scale (base 2), softcap and the kept bits.
    float tmax[2] = {kMask, kMask};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = nt * 8 + tig * 2 + (e & 1);
        float x = s[nt][e];
        x = kSoftcap ? tanhf(x * p.score_mul) * p.cap_log2 : x * p.score_mul;
        if ((w[i] >> c) & 1ull) {
          tmax[i] = fmaxf(tmax[i], x);
        } else {
          x = -INFINITY;
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
        // exp2f(-inf - m) is 0 for a masked element (m stays finite).
        const float pe = exp2f(s[nt][e] - m[e >> 1]);
        l[e >> 1] += pe;
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
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      a[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const T* vrow = vs_ptr + (kk * 16 + tig * 2) * kStride + gid;
#pragma unroll
      for (int nt = 0; nt < kOTiles; ++nt) {
        const T* vc = vrow + nt * 8;
        Mma<T>::run(o[nt], a, pack_u16(vc, vc + kStride),
                    pack_u16(vc + 8 * kStride, vc + 9 * kStride));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    if (!row_ok[i]) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    T* out = static_cast<T*>(p.out) + b * p.o_b + head * p.o_h +
             static_cast<long long>(row[i]) * p.o_s;
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt) {
      *reinterpret_cast<uint32_t*>(out + nt * 8 + tig * 2) =
          Mma<T>::pack(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
    }
    if (tig == 0) {
      p.lse[(static_cast<long long>(b) * p.h + head) * p.sq + row[i]] =
          lsum > 0.f ? (m[i] + log2f(lsum)) * kLn2 : -INFINITY;
    }
  }
}

template <typename T, int D, bool kSoftcap>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = 2 * 2 * kTile * (D + 8) * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      block_sparse_fwd_kernel<T, D, kSoftcap>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.nqb, p.h, batch);
  block_sparse_fwd_kernel<T, D, kSoftcap><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The softcap is a template parameter, so a kernel without one carries no
// tanh in its score loop.
template <typename T, int D>
int launch_softcap(const Params& p, bool softcap, int batch, cudaStream_t s) {
  return softcap ? launch<T, D, true>(p, batch, s)
                 : launch<T, D, false>(p, batch, s);
}

}  // namespace

// q (b, h, sq, d), k and v (b, hk, sk, d), out as q: strides, 12 element
// strides (batch, head, seq) of q, k, v and out. lse (b, h, sq) fp32.
// counts (b, h, cdiv(sq, 64)); tiles and wofs hold list_len entries per
// count; words the mode-2 groups of 64 words. Every row of out and lse is
// written. Returns 0, a cudaError_t from the launch, or -1 for an
// unsupported head dim. Launches on `stream`; does not synchronise.
extern "C" int block_sparse_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const long long* strides, const int* counts, const int* tiles,
    const int* wofs, const unsigned long long* words, long long list_len,
    int batch, int h, int hk, int sq, int sk, int d, float scale,
    float softcap, int is_fp16, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.q_b = strides[0];
  p.q_h = strides[1];
  p.q_s = strides[2];
  p.k_b = strides[3];
  p.k_h = strides[4];
  p.k_s = strides[5];
  p.v_b = strides[6];
  p.v_h = strides[7];
  p.v_s = strides[8];
  p.o_b = strides[9];
  p.o_h = strides[10];
  p.o_s = strides[11];
  p.h = h;
  p.group = h / hk;
  p.sq = sq;
  p.sk = sk;
  p.nqb = (sq + kTile - 1) / kTile;
  const bool has_softcap = softcap > 0.f;
  p.score_mul = has_softcap ? scale / softcap : scale * kLog2e;
  p.cap_log2 = softcap * kLog2e;
  p.counts = counts;
  p.tiles = tiles;
  p.wofs = wofs;
  p.words = words;
  p.list_len = list_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    if (d == 64) return launch_softcap<__half, 64>(p, has_softcap, batch, s);
    if (d == 128) return launch_softcap<__half, 128>(p, has_softcap, batch, s);
  } else {
    if (d == 64) return launch_softcap<__nv_bfloat16, 64>(p, has_softcap, batch, s);
    if (d == 128) return launch_softcap<__nv_bfloat16, 128>(p, has_softcap, batch, s);
  }
  return -1;
}
