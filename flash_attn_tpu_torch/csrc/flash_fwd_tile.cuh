// Flash-attention forward tile step, shared by csrc/flash_fwd.cu (dense,
// varlen and paged modes) and csrc/flash_sparse_fwd.cu (the vertical-slash
// sparse modes): out = softmax(scale * Q K^T [masked]) V and the fp32
// log-sum-exp of every query row.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_fwd.py:95
// (_fwd_kernel, launched at :930 by flash_attention_fwd :540),
// flash_attn_tpu/kernels/flash_varlen.py:542 (_varlen_fwd_kernel, launched
// at :1485 by flash_attention_varlen_fwd :1160),
// flash_attn_tpu/kernels/flash_sparse.py:130 (_sparse_fwd_kernel, launched
// at :453 by flash_attention_sparse_fwd :273) and
// flash_attn_tpu/kernels/flash_sparse_gather.py:127 (_gather_kernel,
// launched at :298 by flash_attention_sparse_gather_fwd :220), restricted to
// the features the training, serving and sparse paths use: scale,
// bottom-right-aligned causal, sliding window (left, right), GQA/MQA,
// softcap, seqused_q/k, ALiBi (sparse modes), head dim 64 or 128, bf16/fp16
// inputs. The TPU schedule (clamped index maps, folded causal grid, exact
// tile worklist with page ids in its flags, 128-lane LSE padding,
// lane-replicated m/l scratch, 128-row sparse super-blocks, 512-wide sparse
// KV tiles, int8 bitmap rows, DMA semaphores and the VMEM budget that routes
// to the gather kernel) is not carried over.
//
// Function. Within one sequence (the batch row of a dense or sparse call;
// sequence b of a varlen call, whose rows start at cu_q[b] and keys at
// cu_k[b] or in the pages of table row b), query row i of head hq sees key
// column j of kv head hq / (h / hk) iff i < rows, j < keys and, with
// diag = i + used_k - used_q, j >= diag - left (left >= 0) and
// j <= diag + right (right >= 0); in the sparse modes also iff j is in the
// attended set of i's 64-row block (below). Dense: rows = used_q = sq, keys =
// used_k = sk. Sparse: used_q = seqlens_q[b] (else sq), rows = min(used_q,
// sq); used_k likewise. Varlen: used_q = seqused_q[b] (else the sequence's
// length), rows = min(used_q, length); used_k likewise, keys = min(used_k,
// length) packed or used_k paged. Scores are s * scale, or
// tanh(s * scale / softcap) * softcap, then minus slope * |j - diag| with
// ALiBi. Online softmax in fp32 (base 2). out = acc / l in q's type; lse =
// m + ln(l) in fp32, natural log; a row that sees no column gives out 0,
// lse -inf. Rows past `rows` are not written (the varlen and sparse
// wrappers zero-fill out and set lse to -inf beforehand where such rows
// exist).
//
// Sparse modes. The planner (kernels/flash_sparse.py) turns the
// vertical-slash metadata into, per (batch row, query head, 64-row block):
//  * kSparse (kernel 12): the ascending list of 64-wide key tiles that hold
//    an attended column, with one 64-bit membership word per tile (bit c:
//    column 64 * tile + c is attended);
//  * kGather (kernel 15): the ascending list of the attended columns
//    themselves, deduplicated.
// Both already drop columns that no row of the block sees (past the keys,
// or right of the block's last row under causal masking).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * d flops
// for every visible (query head, row, column) triple against q, k, v and
// out moved once. At training shapes (s = 2048, d = 64) that is ~300 flops
// per byte, at or above the card's ridge (~295), so the kernel is bound by
// operations; at short sequences or d = 128 with a narrow window it can be
// bound by bytes. The sparse modes are bound the same way by the attended
// pairs; kSparse computes whole 64 x 64 tiles of which only the member
// columns count, kGather only 64-column blocks of attended columns.
//
// Design (simple first; no wgmma/TMA yet). One block of 4 warps per
// (64 query rows, query head, sequence); each warp owns 16 rows, and blocks
// of the last rows (the longest causal rows) launch first. A varlen grid is
// sized by the longest sequence; a block past its sequence's rows returns
// at once, and a grid too short for a sequence loops over its remaining row
// tiles, so the answer never depends on the max_seqlen it was given. Q stays
// in registers as mma.sync A fragments. The block walks only the key tiles
// (64 columns each) that the causal/window range makes visible to its rows,
// or its listed tiles (kSparse), or its gathered columns 64 at a time
// (kGather); K and V tiles are copied with 16-byte cp.async, double-buffered,
// so the next tile loads while this one computes. In paged mode each 64-key
// tile is gathered page by page through the page table (four 16-token pages
// at vLLM's block size), with pages outside the pool zero-filled; each key
// row's offsets are computed from the page table into shared memory one
// tile ahead, so the copy loop is the packed one with the row offset read
// from shared memory. kGather fills the same offsets from its column list,
// and keeps the columns themselves (three tiles deep: a tile's columns are
// read by its mask after the next tile's offsets are written) for the mask
// and ALiBi. S = Q K^T and O += P V run on mma.sync.m16n8k16 with fp32
// accumulation; P is re-packed to 16 bits from the S accumulators in
// registers. Tiles wholly inside every row's visible range (and, in kSparse,
// with a full membership word) skip the per-element mask. Inputs are read
// through their strides, so (b, s, h, d) tensors viewed as (b, h, s, d), thd
// and hsd packed tensors, and "phd" pools viewed head-major are taken
// without a copy.

#pragma once

#include "mma_utils.cuh"

namespace {

using namespace fa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileM = kWarps * 16;  // query rows per block
constexpr int kTileN = 64;           // key columns per shared-memory tile

enum Mode { kDense = 0, kVarlen = 1, kPaged = 2, kSparse = 3, kGather = 4 };

struct FwdParams {
  const void* q;  // dense (b, h, sq, d); varlen (total_q, h, d) or (h, total_q, d)
  const void* k;  // dense (b, hk, sk, d); varlen packed as q; paged: a pool
  const void* v;
  void* out;      // as q
  float* lse;     // dense (b, h, sq); varlen (h, total_q); contiguous
  // Element strides (batch, head, seq). Varlen: batch unused. Paged K/V:
  // (page, head, slot) of the pool.
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  long long lse_h;  // lse stride per head: dense sq, varlen total_q
  int h, group, sq, sk;  // sq, sk: dense and sparse only
  int left, right;  // normalised window; negative = unbounded
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2
  // with a softcap (score_mul = scale / softcap, cap_log2 = softcap*log2 e).
  float score_mul, cap_log2;
  bool has_softcap;
  // Varlen: sequence starts (nseq + 1), optional used lengths (nseq).
  // Sparse: used_q / used_k are the optional per-row seqlens_q / seqlens_k.
  const int* cu_q;
  const int* cu_k;  // packed mode only
  const int* used_q;
  const int* used_k;  // required in paged mode
  // Paged: page table (nseq, max_pages) with row stride table_row.
  const int* table;
  long long table_row;
  int page, max_pages, npages;
  int page_shift;  // log2(page) for a power-of-two page, else -1
  // Sparse: lists of `list_len` entries per (b, head, 64-row block), at row
  // (b * h + head) * nqb + block; counts[row] entries are used (kSparse:
  // tiles, kGather: columns).
  const int* counts;
  const int* tiles;                 // kSparse
  const unsigned long long* words;  // kSparse
  const int* cols;                  // kGather
  long long list_len;
  int nqb;
  // ALiBi (sparse modes): slope of (b, head) at alibi[b * alibi_b + head].
  const float* alibi;
  int alibi_b;
};

// One sequence of the call: element offsets of its first row (head 0) in
// each tensor, its row and key counts and its diagonal offset.
struct Seq {
  long long q, k, v, o, lse;
  int rows, keys, off;
};

template <int kMode>
__device__ __forceinline__ Seq seq_of(const FwdParams& p, int b) {
  Seq s;
  if constexpr (kMode == kDense) {
    // As the backward's dense rows (csrc/flash_bwd_tile.cuh): no reads of
    // the optional lengths.
    s.q = b * p.q_b;
    s.k = b * p.k_b;
    s.v = b * p.v_b;
    s.o = b * p.o_b;
    s.lse = static_cast<long long>(b) * p.h * p.sq;
    s.rows = p.sq;
    s.keys = p.sk;
    s.off = p.sk - p.sq;
  } else if constexpr (kMode == kSparse || kMode == kGather) {
    s.q = b * p.q_b;
    s.k = b * p.k_b;
    s.v = b * p.v_b;
    s.o = b * p.o_b;
    s.lse = static_cast<long long>(b) * p.h * p.sq;
    const int uq = p.used_q ? p.used_q[b] : p.sq;
    const int uk = p.used_k ? p.used_k[b] : p.sk;
    s.rows = max(min(uq, p.sq), 0);
    s.keys = max(min(uk, p.sk), 0);
    s.off = uk - uq;
  } else {
    const int q0 = p.cu_q[b];
    const int len_q = p.cu_q[b + 1] - q0;
    const int uq = p.used_q ? p.used_q[b] : len_q;
    int uk, keys;
    if constexpr (kMode == kVarlen) {
      const int k0 = p.cu_k[b];
      const int len_k = p.cu_k[b + 1] - k0;
      uk = p.used_k ? p.used_k[b] : len_k;
      keys = min(uk, len_k);
      s.k = k0 * p.k_s;
      s.v = k0 * p.v_s;
    } else {
      uk = p.used_k[b];
      keys = min(uk, p.max_pages * p.page);
      s.k = s.v = 0;
    }
    s.q = q0 * p.q_s;
    s.o = q0 * p.o_s;
    s.lse = q0;
    s.rows = max(min(uq, len_q), 0);
    s.keys = max(keys, 0);
    s.off = uk - uq;
  }
  return s;
}

template <typename T, int D, bool kSoftcap, int kMode, bool kAlibi>
__device__ __forceinline__ void fwd_tile(const FwdParams& p, const Seq& sq_,
                                         int m_block, int head, int b,
                                         unsigned char* smem_raw) {
  constexpr int kStride = D + 8;  // padded smem row: conflict-free fragments
  constexpr int kKSteps = D / 16;
  constexpr int kNTiles = kTileN / 8;
  constexpr int kOTiles = D / 8;
  // Key-row offsets come from shared memory (page table or column list).
  constexpr bool kOfsInSmem = kMode == kPaged || kMode == kGather;
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
  // visible to any row of this block), the x-th listed tile (kSparse) or
  // gathered columns 64x .. 64x + 63 (kGather).
  int tile_lo = 0, n_tiles, n_cols = 0;
  long long lbase = 0;
  if constexpr (kMode == kSparse || kMode == kGather) {
    const long long lrow =
        (static_cast<long long>(b) * p.h + head) * p.nqb + m_block;
    lbase = lrow * p.list_len;
    n_cols = p.counts[lrow];
    n_tiles = kMode == kSparse ? n_cols : (n_cols + kTileN - 1) / kTileN;
  } else {
    const int col_lo = p.left >= 0 ? max(row0 + off - p.left, 0) : 0;
    const int col_hi =
        p.right >= 0 ? min(row_last + off + p.right, keys - 1) : keys - 1;
    tile_lo = col_lo / kTileN;
    n_tiles = col_hi >= col_lo ? col_hi / kTileN - tile_lo + 1 : 0;
  }
  auto tile_at = [&](int x) {
    if constexpr (kMode == kSparse) {
      return __ldg(p.tiles + lbase + x);
    } else if constexpr (kMode == kGather) {
      return x;
    } else {
      return tile_lo + x;
    }
  };

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
  float slope2 = 0.f;  // ALiBi slope, base 2
  if constexpr (kAlibi) slope2 = p.alibi[b * p.alibi_b + head] * kLog2e;

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

  const T* kbase = static_cast<const T*>(p.k) + sq_.k + g * p.k_h;
  const T* vbase = static_cast<const T*>(p.v) + sq_.v + g * p.v_h;

  // Paged and gather modes: the K and V element offsets of each key row of
  // a tile, from the page table or the column list, computed by one thread
  // per key one tile ahead of the tile's copies, so the copies neither wait
  // on the table nor redo the page arithmetic per chunk. Kept in shared
  // memory after the K/V stages, [2 slots][K, V][kTileN]; tile tile_lo + j
  // uses slot j & 1; -1 marks a row to zero-fill (past the keys, a page
  // outside the pool, or past the gathered columns). kGather also keeps
  // each row's column, [3][kTileN] after the offsets: step x in x % 3.
  long long* sOfs = reinterpret_cast<long long*>(sV + 2 * kTileN * kStride);
  int* sCol = reinterpret_cast<int*>(sOfs + 4 * kTileN);
  auto fetch_offsets = [&](int tile, int slot) {
    if constexpr (kMode == kPaged) {
      if (tid < kTileN) {
        const int col = tile * kTileN + tid;
        const int pidx =
            p.page_shift >= 0 ? col >> p.page_shift : col / p.page;
        const int id = col < keys ? __ldg(p.table + b * p.table_row + pidx) : -1;
        const long long in_page =
            p.page_shift >= 0 ? col & (p.page - 1) : col % p.page;
        const bool ok = id >= 0 && id < p.npages;
        long long* dst = sOfs + slot * 2 * kTileN + tid;
        dst[0] = ok ? id * p.k_b + in_page * p.k_s : -1;
        dst[kTileN] = ok ? id * p.v_b + in_page * p.v_s : -1;
      }
    } else if constexpr (kMode == kGather) {
      if (tid < kTileN) {
        const int pos = tile * kTileN + tid;
        int col = pos < n_cols ? __ldg(p.cols + lbase + pos) : -1;
        if (col >= keys) col = -1;
        long long* dst = sOfs + slot * 2 * kTileN + tid;
        dst[0] = col >= 0 ? col * p.k_s : -1;
        dst[kTileN] = col >= 0 ? col * p.v_s : -1;
        sCol[(tile % 3) * kTileN + tid] = col;
      }
    }
  };
  // Copies the 16-byte chunk `ofs` of key row `tok` of `tile` into smem
  // stage `stage`; rows past the keys, and pages outside the pool, are
  // zero-filled.
  auto copy_chunk = [&](int tile, int stage, int slot, int tok, int ofs) {
    long long kofs, vofs;
    int bytes;
    if constexpr (kOfsInSmem) {
      kofs = sOfs[slot * 2 * kTileN + tok];
      vofs = sOfs[slot * 2 * kTileN + kTileN + tok];
      bytes = kofs >= 0 ? 16 : 0;
      kofs = max(kofs, 0ll);
      vofs = max(vofs, 0ll);
    } else {
      const int col = tile * kTileN + tok;
      const long long src = max(min(col, keys - 1), 0);
      bytes = col < keys ? 16 : 0;
      kofs = src * p.k_s;
      vofs = src * p.v_s;
    }
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
  auto load_tile = [&](int tile, int stage, int slot) {
    if constexpr (D == 128) {
      for (int c = tid; c < kTileN * kChunksPerRow; c += kThreads) {
        copy_chunk(tile, stage, slot, c / kChunksPerRow,
                   (c % kChunksPerRow) * 8);
      }
    } else {
      constexpr int kRowsPerPass = kThreads / kChunksPerRow;
#pragma unroll
      for (int i = 0; i < kTileN / kRowsPerPass; ++i) {
        copy_chunk(tile, stage, slot, tid / kChunksPerRow + i * kRowsPerPass,
                   (tid % kChunksPerRow) * 8);
      }
    }
  };

  if (n_tiles > 0) {
    fetch_offsets(tile_at(0), 0);
    if constexpr (kOfsInSmem) __syncthreads();
    load_tile(tile_at(0), 0, 0);
    if (n_tiles > 1) fetch_offsets(tile_at(1), 1);
    if constexpr (kOfsInSmem) __syncthreads();
  }
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(tile_at(it + 1), stage ^ 1, (it + 1) & 1);
      // Slot it & 1 last served tile it, whose copies every thread issued
      // before the previous iteration's barrier.
      if (it + 2 < n_tiles) fetch_offsets(tile_at(it + 2), it & 1);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const T* ks_ptr = sK + stage * kTileN * kStride;
    const T* vs_ptr = sV + stage * kTileN * kStride;
    const int col0 = tile_at(it) * kTileN;
    const int* cols = sCol + (it % 3) * kTileN;  // kGather only
    // Every column of the tile visible to every row of the block?
    bool full;
    unsigned long long word = 0;
    if constexpr (kMode == kGather) {
      // Ascending columns: the last one bounds them all.
      const int last = cols[kTileN - 1];
      full = (it + 1) * kTileN <= n_cols && row0 + kTileM <= rows &&
             last < keys && in_window(last, row0 + off, -1, p.right);
    } else {
      full = row0 + kTileM <= rows && col0 + kTileN <= keys &&
             in_window(col0, row0 + kTileM - 1 + off, p.left, -1) &&
             in_window(col0 + kTileN - 1, row0 + off, -1, p.right);
      if constexpr (kMode == kSparse) {
        word = __ldg(p.words + lbase + it);
        full = full && word == ~0ull;
      }
    }

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

    // Scale (base 2), softcap, ALiBi, mask; visibility kept as bits.
    uint32_t vis = 0;
    float tmax[2] = {kMask, kMask};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = nt * 8 + tig * 2 + (e & 1);
        const int col = kMode == kGather ? cols[c] : col0 + c;
        float x = s[nt][e];
        x = kSoftcap ? tanhf(x * p.score_mul) * p.cap_log2 : x * p.score_mul;
        if constexpr (kAlibi) {
          x -= slope2 * fabsf(static_cast<float>(col - diag[i]));
        }
        bool ok;
        if constexpr (kMode == kSparse) {
          ok = full || (((word >> c) & 1ull) && row_ok[i] && col < keys &&
                        in_window(col, diag[i], p.left, p.right));
        } else if constexpr (kMode == kGather) {
          ok = full || (col >= 0 && row_ok[i] && col < keys &&
                        in_window(col, diag[i], p.left, p.right));
        } else {
          ok = full || (row_ok[i] && col < keys &&
                        in_window(col, diag[i], p.left, p.right));
        }
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

// The second bound is the blocks per SM asked of ptxas (0: its own choice).
// Since the sparse modes share this step, ptxas gives the d = 64 dense
// forward without softcap 151 registers instead of 128, 3 blocks per SM
// instead of 4, and it ran 3-6% slower than before; rewriting its setup did
// not move the count. Asking for 4 blocks caps it at 128 (12 bytes of
// spill) and restores its time (tools/ab_kernels.py against the parent,
// PERF.md).
template <typename T, int D, bool kSoftcap, int kMode, bool kAlibi>
__global__ void __launch_bounds__(
    kThreads, D == 64 && !kSoftcap && kMode == kDense ? 4 : 0)
    flash_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const Seq s = seq_of<kMode>(p, b);
  const int n_m = (s.rows + kTileM - 1) / kTileM;
  // Dense: one pass, m_block = gridDim.x - 1 - blockIdx.x.
  for (int mb = blockIdx.x; mb < n_m; mb += gridDim.x) {
    fwd_tile<T, D, kSoftcap, kMode, kAlibi>(p, s, n_m - 1 - mb, head, b,
                                            smem_raw);
  }
}

template <typename T, int D, bool kSoftcap, int kMode, bool kAlibi>
int launch_kernel(const FwdParams& p, int m_blocks, int batch,
                  cudaStream_t stream) {
  const size_t smem = 2 * 2 * kTileN * (D + 8) * sizeof(T) +
                      (kMode == kPaged || kMode == kGather
                           ? 4 * kTileN * sizeof(long long) : 0) +
                      (kMode == kGather ? 3 * kTileN * sizeof(int) : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kSoftcap, kMode, kAlibi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m_blocks, p.h, batch);
  flash_fwd_kernel<T, D, kSoftcap, kMode, kAlibi>
      <<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The softcap, and in the sparse modes ALiBi, are template parameters, so a
// kernel without one carries no tanh (or bias) in its score loop.
template <typename T, int D, int kMode>
int launch(const FwdParams& p, int m_blocks, int batch, cudaStream_t stream) {
  if constexpr (kMode == kSparse || kMode == kGather) {
    if (p.alibi) {
      return p.has_softcap
                 ? launch_kernel<T, D, true, kMode, true>(p, m_blocks, batch, stream)
                 : launch_kernel<T, D, false, kMode, true>(p, m_blocks, batch, stream);
    }
  }
  return p.has_softcap
             ? launch_kernel<T, D, true, kMode, false>(p, m_blocks, batch, stream)
             : launch_kernel<T, D, false, kMode, false>(p, m_blocks, batch, stream);
}

template <int kMode>
int dispatch(const FwdParams& p, int m_blocks, int batch, int d, int is_fp16,
             cudaStream_t s) {
  if (is_fp16) {
    if (d == 64) return launch<__half, 64, kMode>(p, m_blocks, batch, s);
    if (d == 128) return launch<__half, 128, kMode>(p, m_blocks, batch, s);
  } else {
    if (d == 64) return launch<__nv_bfloat16, 64, kMode>(p, m_blocks, batch, s);
    if (d == 128) return launch<__nv_bfloat16, 128, kMode>(p, m_blocks, batch, s);
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
