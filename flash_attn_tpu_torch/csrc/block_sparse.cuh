// Block-sparse attention (kernels 9-11): the execution lists' entries and
// the per-row membership words, shared by csrc/block_sparse_fwd.cu and
// csrc/block_sparse_bwd.cu. The lists are built by
// kernels/block_sparsity.py (`build_execution_lists`).
//
// An entry is (index << 2) | mode for one 64 x 64 sub-tile of a live plan
// tile: index is the 64-column key tile (forward and dQ lists) or the
// 64-row query block (dK/dV lists). Mode 0: every element is kept (the
// sub-tile lies inside the bounds of a FULL plan tile, or its mod words
// were all ones); mode 1: the bounds only (rows < seqlen_q, columns <
// seqlen_k); mode 2: 64 per-row words at group `wofs` of the words buffer,
// word r of the sub-tile's row r, bit c for its column c, already ANDed
// with the bounds.

#pragma once

#include "mma_utils.cuh"

namespace bs {

constexpr int kSub = 64;  // sub-tile rows and columns

// The low n bits, n in [0, 64].
__device__ __forceinline__ unsigned long long low_bits(int n) {
  return n >= 64 ? ~0ull : n <= 0 ? 0ull : (1ull << n) - 1ull;
}

// The membership word of the sub-tile's row `r_local` (absolute row
// `row`), whose key columns start at `col0`.
__device__ __forceinline__ unsigned long long row_word(
    int mode, int wofs, int row, int r_local, int col0, int sq, int sk,
    const unsigned long long* words) {
  if (mode == 0) return ~0ull;
  if (mode == 1) return row < sq ? low_bits(sk - col0) : 0ull;
  return __ldg(words + static_cast<long long>(wofs) * kSub + r_local);
}

}  // namespace bs
