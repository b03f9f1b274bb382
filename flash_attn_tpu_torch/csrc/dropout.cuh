// The keep predicate of attention dropout, written once for every kernel
// that drops attention probabilities (kernels 1-3 since they took dropout;
// kernels 6-8 and 12-14 are to include it too).
//
// Replaces flash_attn_tpu/kernels/flash_fwd.py:67 (_dropout_keep_mask): a
// counter-based hash keyed on (seed, batch row, query head, absolute row,
// absolute column), not on tile coordinates, so that the forward and both
// backward kernels draw the same mask under any tiling. With every product
// and sum wrapping in uint32,
//   base = seed * 0x27D4EB2F + b * 0x165667B1 + h * 0x9E3779B9
//   x    = row * 0x9E3779B1 ^ col * 0x85EBCA77 ^ base
//   x    = murmur3 fmix32(x)
//   keep iff x < threshold,  threshold = min(int(keep_prob * 2^32), 2^32 - 1)
// computed on the host in double precision, as the JAX wrapper does, so the
// kernels, the plain versions (kernels/common.py dropout_keep_mask) and the
// JAX package keep the same bits. A negative seed enters as its two's
// complement.
//
// Cost: 2 multiplies, 3 shifts and 4 XORs an element past the per-row part,
// integer work beside the softmax's exponentials; nothing is read from
// memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

// The per (seed, batch row, query head) part of the hash.
__host__ __device__ __forceinline__ uint32_t dropout_base(uint32_t seed,
                                                          uint32_t b,
                                                          uint32_t h) {
  return seed * 0x27D4EB2Fu + b * 0x165667B1u + h * 0x9E3779B9u;
}

// The per row part: row * 0x9E3779B1 ^ base.
__host__ __device__ __forceinline__ uint32_t dropout_row(uint32_t base,
                                                         uint32_t row) {
  return row * 0x9E3779B1u ^ base;
}

// Whether element (row, col) is kept, given its row's part.
__host__ __device__ __forceinline__ bool dropout_keep(uint32_t row_part,
                                                      uint32_t col,
                                                      uint32_t threshold) {
  uint32_t x = col * 0x85EBCA77u ^ row_part;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x < threshold;
}

}  // namespace fa
