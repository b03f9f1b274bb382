// The flat tile schedule of the packed variable-length Hopper kernels:
// kernel 6 (csrc/flash_varlen_fwd_sm90.cuh, block_m(d) rows a tile) and
// kernel 8 (csrc/flash_varlen_bwd_sm90.cuh, 128 rows a tile).
//
// grid.x = (total_q + nseq (block_m - 1)) / block_m, an upper bound on
// sum_j cdiv(rows_j, block_m) known from the shapes alone (rows_j <=
// length_j). Each block finds its (sequence, row tile) on the device by a
// block-wide scan of the tile counts from cu_q / used_q; a block past the
// last tile exits. No host read, and no block for the empty row tiles that
// a max_seqlen_q x nseq grid launches.

#pragma once

namespace fa {
namespace vsched {

// Rows of sequence j: min(used_q, length), at least 0.
__device__ __forceinline__ int seq_rows(const int* cu_q, const int* used_q,
                                        int j) {
  const int q0 = __ldg(cu_q + j);
  const int len = __ldg(cu_q + j + 1) - q0;
  const int uq = used_q ? __ldg(used_q + j) : len;
  return max(min(uq, len), 0);
}

// The flat schedule lists the row tiles of every sequence in order,
// cdiv(rows_j, kBlockM) for sequence j. Finds tile t's sequence and its
// index there by a block-wide scan of the counts, kThreads sequences at a
// time (warp scans, then the warps' totals in `scan`, kThreads / 32 + 3
// ints). Returns the sequence, or -1 past the last tile, with the tile's
// index in it and the sequence's tile count in found[1], found[2] (found =
// scan + kThreads / 32). Every thread of the block calls it.
template <int kThreads, int kBlockM>
__device__ __forceinline__ int find_tile(const int* cu_q, const int* used_q,
                                         int nseq, int t, int* scan) {
  constexpr int kWarps = kThreads / 32;
  int* found = scan + kWarps;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (nseq <= 0) return -1;
  if (tid == 0) found[0] = -1;
  int before = 0;  // tiles of the sequences before this chunk
  for (int j0 = 0; j0 < nseq; j0 += kThreads) {
    const int j = j0 + tid;
    const int n =
        j < nseq ? (seq_rows(cu_q, used_q, j) + kBlockM - 1) / kBlockM : 0;
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) scan[warp] = incl;
    __syncthreads();
    int first = before + incl - n, chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) first += scan[w];
      chunk += scan[w];
    }
    if (n > 0 && t >= first && t < first + n) {
      found[0] = j;
      found[1] = t - first;
      found[2] = n;
    }
    __syncthreads();
    if (found[0] >= 0) break;
    before += chunk;
  }
  return found[0];
}

// Writes this block's entry of a schedule trace, if one is asked for
// (trace not null): (blockIdx.x, blockIdx.y, sequence, first row), the last
// two -1 past the last tile, at ints 4 (blockIdx.y gridDim.x + blockIdx.x)
// of the trace_len it has. For checks on the card.
__device__ __forceinline__ void trace_block(int* trace, long long trace_len,
                                            int seq, int row0) {
  if (trace == nullptr) return;
  const long long at =
      4ll * (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x);
  if (at + 4 > trace_len) return;
  trace[at] = blockIdx.x;
  trace[at + 1] = blockIdx.y;
  trace[at + 2] = seq;
  trace[at + 3] = row0;
}

// Blocks of the flat schedule for tiles of block_m rows.
inline long long grid_tiles(long long total_q, int nseq, int block_m) {
  return (total_q + static_cast<long long>(nseq) * (block_m - 1)) / block_m;
}

}  // namespace vsched
}  // namespace fa
