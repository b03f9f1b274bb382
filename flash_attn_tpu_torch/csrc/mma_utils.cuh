// Warp-level building blocks shared by the port's attention kernels:
// mma.sync.m16n8k16 (bf16/fp16 in, fp32 accumulate), 16-byte cp.async
// copies into shared memory, and quad (4-lane) reductions over the rows of
// an mma accumulator fragment.
//
// Fragment layout of m16n8k16 (lane = 4 * gid + tig):
//   A (16 x 16, row-major): a0 = (gid, 2tig..+1), a1 = (gid + 8, 2tig..+1),
//                           a2 = (gid, 2tig + 8..+9), a3 = (gid + 8, 2tig + 8..+9)
//   B (16 x 8, "col"):      b0 = (k = 2tig..+1, n = gid), b1 = (k = 2tig + 8..+9, n = gid)
//   C (16 x 8):             c0, c1 = (gid, 2tig..+1), c2, c3 = (gid + 8, 2tig..+1)
// so the C fragments of two neighbouring n-tiles, packed to 16 bits, are
// the A fragment of the next product without touching shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr float kMask = -0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // src_bytes = 0 reads nothing and fills the 16 bytes with zeros.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t pack_u16(const void* lo, const void* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Column `col` is visible from the query row whose bottom-right-aligned
// diagonal column is `diag` (= row + seqlen_k - seqlen_q) under the window
// (left, right); a negative bound is unbounded on that side.
__device__ __forceinline__ bool in_window(int col, int diag, int left,
                                          int right) {
  return (left < 0 || col >= diag - left) && (right < 0 || col <= diag + right);
}

}  // namespace fa
