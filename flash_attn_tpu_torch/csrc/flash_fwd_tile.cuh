// Flash-attention forward tile step of the paged route of kernel 6
// (csrc/flash_fwd.cu) for pools whose page size is not a multiple of 8,
// which the Hopper kernel's TMA page boxes do not take: out = softmax(scale
// * Q K^T [masked]) V and the fp32 log-sum-exp of every query row. Kernel 6
// on packed K/V and on other pools has its own Hopper kernel
// (csrc/flash_varlen_fwd_sm90.cuh).
//
// Replaces, on that paged route, the TPU kernel
// flash_attn_tpu/kernels/flash_varlen.py:542 (_varlen_fwd_kernel, launched
// at :1485 by flash_attention_varlen_fwd :1160), restricted to the features
// the serving path uses: scale, bottom-right-aligned causal, sliding window
// (left, right), GQA/MQA, softcap, seqused_q/k, head dim 64 or 128,
// bf16/fp16 inputs. The TPU schedule (clamped index maps, exact tile
// worklist with page ids in its flags, 128-lane LSE padding,
// lane-replicated m/l scratch, DMA semaphores) is not carried over.
//
// Function. Within sequence b, whose rows start at cu_q[b] and whose keys
// lie in the pages of table row b, query row i of head hq sees key column j
// of kv head hq / (h / hk) iff i < rows, j < keys and, with
// diag = i + used_k - used_q, j >= diag - left (left >= 0) and
// j <= diag + right (right >= 0); used_q = seqused_q[b] (else the
// sequence's length), rows = min(used_q, length); keys = used_k. Scores
// are s * scale, or tanh(s * scale / softcap) * softcap. Online softmax in
// fp32 (base 2). out = acc / l in q's type; lse = m + ln(l) in fp32,
// natural log; a row that sees no column gives out 0, lse -inf. Rows past
// `rows` are not written (the wrapper zero-fills out and sets lse to -inf
// beforehand where such rows exist).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * d flops
// for every visible (query head, row, column) triple against q, k, v and
// out moved once, at these shapes bound by operations.
//
// Design (the sm80 step: no wgmma/TMA). One block of 4 warps per
// (64 query rows, query head, sequence); each warp owns 16 rows, and blocks
// of the last rows (the longest causal rows) launch first. The grid is
// sized by the longest sequence; a block past its sequence's rows returns
// at once, and a grid too short for a sequence loops over its remaining row
// tiles, so the answer never depends on the max_seqlen it was given. Q stays
// in registers as mma.sync A fragments. The block walks only the key tiles
// (64 columns each) that the causal/window range makes visible to its rows;
// each 64-key tile is gathered page by page through the page table by
// 16-byte cp.async, double-buffered, so the next tile loads while this one
// computes, with pages outside the pool zero-filled; each key row's offsets
// are computed from the page table into shared memory one tile ahead, so
// the copy loop reads the row offset from shared memory. S = Q K^T and O +=
// P V run on mma.sync.m16n8k16 with fp32 accumulation; P is re-packed to 16
// bits from the S accumulators in registers. Tiles wholly inside every
// row's visible range skip the per-element mask. Inputs are read through
// their strides, so thd and hsd packed queries and "phd" pools viewed
// head-major are taken without a copy.

#pragma once

#include "mma_utils.cuh"

namespace {

using namespace fa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileM = kWarps * 16;  // query rows per block
constexpr int kTileN = 64;           // key columns per shared-memory tile

struct FwdParams {
  const void* q;  // (total_q, h, d) or (h, total_q, d)
  const void* k;  // a pool
  const void* v;
  void* out;      // as q
  float* lse;     // (h, total_q) contiguous
  // Element strides (batch, head, seq): q's and out's batch unused, K/V's
  // (page, head, slot) of the pool.
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  long long lse_h;  // lse stride per head: total_q
  int h, group;
  // Unused: keeps the fields below at the offsets they had beside the
  // removed sparse mode's fields. ptxas allocates the d-64 instances by
  // them: 134 and 133 registers here, 128 and 136 without the pad.
  int pad[2];
  int left, right;  // normalised window; negative = unbounded
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2
  // with a softcap (score_mul = scale / softcap, cap_log2 = softcap*log2 e).
  float score_mul, cap_log2;
  bool has_softcap;
  // Sequence starts (nseq + 1), optional used lengths (nseq).
  const int* cu_q;
  const int* used_q;
  const int* used_k;  // required
  // Page table (nseq, max_pages) with row stride table_row.
  const int* table;
  long long table_row;
  int page, max_pages, npages;
  int page_shift;  // log2(page) for a power-of-two page, else -1
};

// One sequence of the call: element offsets of its first row (head 0) in
// q, out and lse, its row and key counts and its diagonal offset.
struct Seq {
  long long q, o, lse;
  int rows, keys, off;
};

__device__ __forceinline__ Seq seq_of(const FwdParams& p, int b) {
  Seq s;
  const int q0 = p.cu_q[b];
  const int len_q = p.cu_q[b + 1] - q0;
  const int uq = p.used_q ? p.used_q[b] : len_q;
  const int uk = p.used_k[b];
  const int keys = min(uk, p.max_pages * p.page);
  s.q = q0 * p.q_s;
  s.o = q0 * p.o_s;
  s.lse = q0;
  s.rows = max(min(uq, len_q), 0);
  s.keys = max(keys, 0);
  s.off = uk - uq;
  return s;
}

template <typename T, int D, bool kSoftcap>
__device__ __forceinline__ void fwd_tile(const FwdParams& p, const Seq& sq_,
                                         int m_block, int head, int b,
                                         unsigned char* smem_raw) {
  constexpr int kStride = D + 8;  // padded smem row: conflict-free fragments
  constexpr int kKSteps = D / 16;
  constexpr int kNTiles = kTileN / 8;
  constexpr int kOTiles = D / 8;
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][kTileN][kStride]
  T* sV = sK + 2 * kTileN * kStride;       // [2][kTileN][kStride]

  const int rows = sq_.rows;
  const int keys = sq_.keys;
  const int off = sq_.off;
  const int g = head / p.group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int row0 = m_block * kTileM;
  const int row_last = min(row0 + kTileM, rows) - 1;

  // The walk: n_tiles steps; step x reads key tile tile_lo + x (the tiles
  // visible to any row of this block).
  const int col_lo = p.left >= 0 ? max(row0 + off - p.left, 0) : 0;
  const int col_hi =
      p.right >= 0 ? min(row_last + off + p.right, keys - 1) : keys - 1;
  const int tile_lo = col_lo / kTileN;
  const int n_tiles = col_hi >= col_lo ? col_hi / kTileN - tile_lo + 1 : 0;

  // This thread's two rows: gid and gid + 8 of the warp's 16.
  int diag[2];
  bool row_ok[2];
  const T* qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + gid + 8 * i;
    row_ok[i] = r < rows;
    diag[i] = r + off;
    qrow[i] = static_cast<const T*>(p.q) + sq_.q + head * p.q_h +
              static_cast<long long>(r) * p.q_s;
  }

  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = ks * 16 + tig * 2 + (j >> 1) * 8;
      qf[ks][j] = row_ok[j & 1] ? ld_u32(qrow[j & 1] + col) : 0u;
    }
  }

  float o[kOTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt) {
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  const T* kbase = static_cast<const T*>(p.k) + g * p.k_h;
  const T* vbase = static_cast<const T*>(p.v) + g * p.v_h;

  // The K and V element offsets of each key row of a tile, from the page
  // table, computed by one thread per key one tile ahead of the
  // tile's copies, so the copies neither wait on the table nor redo the
  // page arithmetic per chunk. Kept in shared memory after the K/V stages,
  // [2 slots][K, V][kTileN]; tile tile_lo + j uses slot j & 1; -1 marks a
  // row to zero-fill (past the keys, or a page outside the pool).
  long long* sOfs = reinterpret_cast<long long*>(sV + 2 * kTileN * kStride);
  auto fetch_offsets = [&](int tile, int slot) {
    if (tid < kTileN) {
      const int col = tile * kTileN + tid;
      const int pidx = p.page_shift >= 0 ? col >> p.page_shift : col / p.page;
      const int id = col < keys ? __ldg(p.table + b * p.table_row + pidx) : -1;
      const long long in_page =
          p.page_shift >= 0 ? col & (p.page - 1) : col % p.page;
      const bool ok = id >= 0 && id < p.npages;
      long long* dst = sOfs + slot * 2 * kTileN + tid;
      dst[0] = ok ? id * p.k_b + in_page * p.k_s : -1;
      dst[kTileN] = ok ? id * p.v_b + in_page * p.v_s : -1;
    }
  };
  // Copies the 16-byte chunk `ofs` of key row `tok` of the tile in offset
  // slot `slot` into smem stage `stage`; rows past the keys, and pages
  // outside the pool, are zero-filled.
  auto copy_chunk = [&](int stage, int slot, int tok, int ofs) {
    long long kofs = sOfs[slot * 2 * kTileN + tok];
    long long vofs = sOfs[slot * 2 * kTileN + kTileN + tok];
    const int bytes = kofs >= 0 ? 16 : 0;
    kofs = max(kofs, 0ll);
    vofs = max(vofs, 0ll);
    cp_async_16(sK + (stage * kTileN + tok) * kStride + ofs, kbase + kofs + ofs,
                bytes);
    cp_async_16(sV + (stage * kTileN + tok) * kStride + ofs, vbase + vofs + ofs,
                bytes);
  };
  // Each thread copies one 16-byte column chunk of every (kThreads / (D /
  // 8))-th key row. Unrolled at d = 64; at d = 128 a plain loop, since the
  // unrolled one holds more addresses live beside the 128-wide
  // accumulators and ran the forward slower.
  constexpr int kChunksPerRow = D / 8;
  auto load_tile = [&](int stage, int slot) {
    if constexpr (D == 128) {
      for (int c = tid; c < kTileN * kChunksPerRow; c += kThreads) {
        copy_chunk(stage, slot, c / kChunksPerRow, (c % kChunksPerRow) * 8);
      }
    } else {
      constexpr int kRowsPerPass = kThreads / kChunksPerRow;
#pragma unroll
      for (int i = 0; i < kTileN / kRowsPerPass; ++i) {
        copy_chunk(stage, slot, tid / kChunksPerRow + i * kRowsPerPass,
                   (tid % kChunksPerRow) * 8);
      }
    }
  };

  if (n_tiles > 0) {
    fetch_offsets(tile_lo, 0);
    __syncthreads();
    load_tile(0, 0);
    if (n_tiles > 1) fetch_offsets(tile_lo + 1, 1);
    __syncthreads();
  }
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(stage ^ 1, (it + 1) & 1);
      // Slot it & 1 last served tile it, whose copies every thread issued
      // before the previous iteration's barrier.
      if (it + 2 < n_tiles) fetch_offsets(tile_lo + it + 2, it & 1);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const T* ks_ptr = sK + stage * kTileN * kStride;
    const T* vs_ptr = sV + stage * kTileN * kStride;
    const int col0 = (tile_lo + it) * kTileN;
    // Every column of the tile visible to every row of the block?
    const bool full = row0 + kTileM <= rows && col0 + kTileN <= keys &&
                      in_window(col0, row0 + kTileM - 1 + off, p.left, -1) &&
                      in_window(col0 + kTileN - 1, row0 + off, -1, p.right);

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

    // Scale (base 2), softcap, mask; visibility kept as bits.
    uint32_t vis = 0;
    float tmax[2] = {kMask, kMask};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = nt * 8 + tig * 2 + (e & 1);
        const int col = col0 + c;
        float x = s[nt][e];
        x = kSoftcap ? tanhf(x * p.score_mul) * p.cap_log2 : x * p.score_mul;
        const bool ok = full || (row_ok[i] && col < keys &&
                                 in_window(col, diag[i], p.left, p.right));
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
    const int r = row0 + warp * 16 + gid + 8 * i;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    T* out = static_cast<T*>(p.out) + sq_.o + head * p.o_h +
             static_cast<long long>(r) * p.o_s;
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt) {
      *reinterpret_cast<uint32_t*>(out + nt * 8 + tig * 2) =
          Mma<T>::pack(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
    }
    if (tig == 0) {
      p.lse[sq_.lse + head * p.lse_h + r] =
          lsum > 0.f ? (m[i] + log2f(lsum)) * kLn2 : -INFINITY;
    }
  }
}

// The second bound, the blocks per SM asked of ptxas, is 0: its own choice.
template <typename T, int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 0)
    flash_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const Seq s = seq_of(p, b);
  const int n_m = (s.rows + kTileM - 1) / kTileM;
  for (int mb = blockIdx.x; mb < n_m; mb += gridDim.x) {
    fwd_tile<T, D, kSoftcap>(p, s, n_m - 1 - mb, head, b, smem_raw);
  }
}

template <typename T, int D, bool kSoftcap>
int launch_kernel(const FwdParams& p, int m_blocks, int batch,
                  cudaStream_t stream) {
  const size_t smem = 2 * 2 * kTileN * (D + 8) * sizeof(T) +
                      4 * kTileN * sizeof(long long);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kSoftcap>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m_blocks, p.h, batch);
  flash_fwd_kernel<T, D, kSoftcap><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The softcap is a template parameter, so a kernel without one carries no
// tanh in its score loop.
template <typename T, int D>
int launch(const FwdParams& p, int m_blocks, int batch, cudaStream_t stream) {
  return p.has_softcap
             ? launch_kernel<T, D, true>(p, m_blocks, batch, stream)
             : launch_kernel<T, D, false>(p, m_blocks, batch, stream);
}

int dispatch(const FwdParams& p, int m_blocks, int batch, int d, int is_fp16,
             cudaStream_t s) {
  if (is_fp16) {
    if (d == 64) return launch<__half, 64>(p, m_blocks, batch, s);
    if (d == 128) return launch<__half, 128>(p, m_blocks, batch, s);
  } else {
    if (d == 64) return launch<__nv_bfloat16, 64>(p, m_blocks, batch, s);
    if (d == 128) return launch<__nv_bfloat16, 128>(p, m_blocks, batch, s);
  }
  return -1;
}

FwdParams make_params(const void* q, const void* k, const void* v, void* out,
                      float* lse, const long long* strides, int h, int hk,
                      float scale, int window_left, int window_right,
                      float softcap) {
  FwdParams p = {};
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
  p.left = window_left;
  p.right = window_right;
  p.has_softcap = softcap > 0.f;
  p.score_mul = p.has_softcap ? scale / softcap : scale * kLog2e;
  p.cap_log2 = softcap * kLog2e;
  return p;
}

}  // namespace
