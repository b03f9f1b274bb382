// Vertical-slash sparse attention forward over gathered column lists, for
// Hopper (kernel 15): out = softmax(scale * Q K^T over each 64-row block's
// attended columns [masked]) V and the fp32 log-sum-exp of every query
// row, for q (b, h, sq, d) and k, v (b, hk, sk, d) read through their
// strides.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_sparse_gather.py:127
// (_gather_kernel, launched at :298 by flash_attention_sparse_gather_fwd
// :220). The function is kernel 12's (csrc/flash_fwd_tile.cuh): query row
// i of head hq sees key column j of kv head hq / (h / hk) iff i < rows
// (min(seqlens_q[b], sq)), j < keys (min(seqlens_k[b], sk)), j is on the
// ascending, deduplicated list that kernels/flash_sparse_gather.py
// plan_gather builds for i's 64-row block, and, under causal masking,
// j <= i + used_k - used_q. Scores are s * scale, or tanh(s * scale /
// softcap) * softcap, then minus slope * |j - diag| with ALiBi. Online
// softmax in fp32 (base 2); out = acc / l in q's type, lse = m + ln(l)
// (natural log); a row that sees nothing gives out 0, lse -inf; rows past
// `rows` are not written (the wrapper zero-fills them beforehand).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * d flops
// per visible (query head, row, column) triple against q, k, v and out
// moved once; at the vLLM prefill shape (s 32768, d 128) bound by
// operations.
//
// Design. One block of 256 threads per (64-row block, query head, batch
// row), heads fastest and the last row blocks (the longest causal lists)
// first, two blocks to an SM:
//  * a producer warpgroup gathers. Hopper's TMA has no row gather, so for
//    each step of 64 listed columns, threads 0-63 write the step's column
//    indices (read a step ahead) beside the stage, for the copies, the
//    mask and ALiBi; after a barrier over the warpgroup, each pass copies
//    128 consecutive 16-byte chunks of the listed K and V rows by cp.async
//    (a warp covers whole rows) straight into the 128-byte-swizzled layout
//    that wgmma's descriptors read (chunk c of row r at c ^ (r % 8),
//    csrc/sm90_utils.cuh); a column past the count or the keys is
//    zero-filled (and masked). Q comes the same way, once. cp.async writes
//    through the generic proxy and wgmma reads through the async proxy, so
//    each thread waits for its copies of a stage (one stage behind the
//    ones it has in flight), fences the proxies
//    (fence.proxy.async.shared::cta) and only then arrives on the stage's
//    full barrier (128 arrivals);
//  * one consumer warpgroup walks the block's list alone (adjacent blocks
//    share their vertical columns, not their slash runs, and lists reach
//    ~10^4 entries at 32768 keys, so no merging): per step S = Q K^T on
//    wgmma m64n64k16 (both operands in shared memory), the online softmax
//    on the accumulators with the mask only where the step is not full
//    (the last listed column visible to the block's first row, every row
//    in range), P packed to 16 bits as the register A operand of O += P V
//    (wgmma m64nDk16, V N-major through the transpose flag), then the
//    stage released to the producer through its empty barrier;
//  * a ring of three stages at d 128 (Q 16 KB + 3 x 32 KB: two blocks fill
//    the SM's shared memory, so the tiles start at the dynamic base, which
//    must be 1024-byte aligned), four at d 64.
// The out rows below `rows` and their LSE are stored from registers. No
// atomics: each output element is written once.

#pragma once

#include "mma_utils.cuh"
#include "sm90_utils.cuh"

namespace fa {
namespace gather90 {

using namespace fa::sm90;

constexpr int kRows = 64;  // query rows per block: one consumer warpgroup
constexpr int kCols = 64;  // gathered columns per step
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;

template <int D>
struct Cfg {
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kCols * D * 2;  // one K or V stage
  static constexpr size_t kSmem = kQBytes + 2 * kStages * kTileBytes +
                                  4 * kStages * kCols + 8 * (1 + 2 * kStages);
};

struct Params {
  const void* q;  // (b, h, sq, d)
  const void* k;  // (b, hk, sk, d)
  const void* v;
  void* out;      // as q
  float* lse;     // (b, h, sq) contiguous
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  int h, group, sq, sk, nqb;
  int causal;
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2 with
  // a softcap.
  float score_mul, cap_log2;
  const int* seqlens_q;  // (b) or null
  const int* seqlens_k;
  // Lists of list_len entries per (b, head, 64-row block), at row
  // (b * h + head) * nqb + block; counts[row] of them used.
  const int* counts;
  const int* cols;
  long long list_len;
  // ALiBi: slope of (b, head) at alibi[b * alibi_b + head], or null.
  const float* alibi;
  int alibi_b;
};

// Byte offset of 16-byte chunk c of row r in a tile of R rows stored as
// D / 64 column blocks of R x 128 bytes with the 128-byte swizzle.
__device__ __forceinline__ int swizzled(int r, int c, int R) {
  return (c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename T, int D, bool kSoftcap, bool kAlibi>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    gather_sm90_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int kStages = C::kStages;
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  // The producer's passes over a stage: 128 chunks each, rows in order,
  // so a warp's copies cover whole rows.
  constexpr int kRowsPerPass = 128 / kChunks;
  extern __shared__ __align__(1024) unsigned char smem_g90[];
  // Two blocks an SM leave no room for alignment slack (see the design).
  if (smem_u32(smem_g90) & 1023) __trap();
  unsigned char* sQ = smem_g90;
  unsigned char* sK = sQ + C::kQBytes;
  unsigned char* sV = sK + kStages * C::kTileBytes;
  int* sCol = reinterpret_cast<int*>(sV + kStages * C::kTileBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sCol + kStages * kCols);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int head = blockIdx.x;
  const int mb = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.z;
  const int uq = p.seqlens_q ? __ldg(p.seqlens_q + b) : p.sq;
  const int uk = p.seqlens_k ? __ldg(p.seqlens_k + b) : p.sk;
  const int rows = max(min(uq, p.sq), 0);
  const int keys = max(min(uk, p.sk), 0);
  const int off = uk - uq;
  const int row0 = mb * kRows;
  if (row0 >= rows) return;  // the wrapper has filled these rows
  const int right = p.causal ? 0 : -1;
  const long long lrow = (static_cast<long long>(b) * p.h + head) * p.nqb + mb;
  const long long lbase = lrow * p.list_len;
  const int n_cols = __ldg(p.counts + lrow);
  const int n_steps = (n_cols + kCols - 1) / kCols;
  const int tid = threadIdx.x;

  if (n_steps > 0) {
    if (tid == 0) {
      mbar_init(q_full, 128);
#pragma unroll
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + s, 128);   // every producer thread
        mbar_init(empty + s, 4);    // lane 0 of each consumer warp
      }
      fence_barrier_init();
    }
    __syncthreads();
  }

  if (tid < 128) {
    // Producer. Pass i of a stage copies chunk tid % kChunks of row
    // i * kRowsPerPass + tid / kChunks; thread t < kCols first reads
    // column t of the step (a step ahead) into the stage's column slots,
    // which the warpgroup's barrier then shows every producer thread.
    if (n_steps == 0) return;
    const int c = tid % kChunks;
    const int r0 = tid / kChunks;
    const int g = head / p.group;
    const T* qbase = static_cast<const T*>(p.q) + b * p.q_b + head * p.q_h;
    const T* kbase = static_cast<const T*>(p.k) + b * p.k_b + g * p.k_h;
    const T* vbase = static_cast<const T*>(p.v) + b * p.v_b + g * p.v_h;
    const int* list = p.cols + lbase;
#pragma unroll
    for (int i = 0; i < kRows / kRowsPerPass; ++i) {
      const int r = i * kRowsPerPass + r0;
      const int bytes = row0 + r < p.sq ? 16 : 0;  // rows past sq: zeros
      const T* src = bytes ? qbase + static_cast<long long>(row0 + r) * p.q_s
                           : qbase;
      cp_async_16(sQ + swizzled(r, c, kRows), src + c * 8, bytes);
    }
    cp_async_commit();
    // Column tid of step x: past the count or the keys, -1 (zero-filled).
    auto column = [&](int x) {
      const int pos = x * kCols + tid;
      const int col = tid < kCols && pos < n_cols ? __ldg(list + pos) : -1;
      return col < keys ? col : -1;
    };
    int next = column(0);
    for (int x = 0; x < n_steps; ++x) {
      const int s = x % kStages;
      const int col = next;
      if (x + 1 < n_steps) next = column(x + 1);
      mbar_wait(empty + s, ((x / kStages) & 1) ^ 1);
      int* scol = sCol + s * kCols;
      if (tid < kCols) scol[tid] = col;
      named_barrier(1, 128);
      unsigned char* dk = sK + s * C::kTileBytes;
      unsigned char* dv = sV + s * C::kTileBytes;
#pragma unroll
      for (int i = 0; i < kCols / kRowsPerPass; ++i) {
        const int r = i * kRowsPerPass + r0;
        const int cr = scol[r];
        const int bytes = cr >= 0 ? 16 : 0;
        const long long row = max(cr, 0);
        cp_async_16(dk + swizzled(r, c, kCols), kbase + row * p.k_s + c * 8,
                    bytes);
        cp_async_16(dv + swizzled(r, c, kCols), vbase + row * p.v_s + c * 8,
                    bytes);
      }
      cp_async_commit();
      // The group before this one (Q at step 0, else step x - 1) has
      // landed: hand it to the async proxy, then to the consumers.
      cp_async_wait_1();
      fence_proxy_async();
      mbar_arrive(x == 0 ? q_full : full + (x - 1) % kStages);
    }
    cp_async_wait_all();
    fence_proxy_async();
    mbar_arrive(full + (n_steps - 1) % kStages);
    return;
  }

  // Consumer warpgroup.
  const int t = tid - 128;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  int row[2], diag[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = row0 + warp * 16 + gid + 8 * i;
    row_ok[i] = row[i] < rows;
    diag[i] = row[i] + off;
  }
  float slope2 = 0.f;  // ALiBi slope, base 2
  if constexpr (kAlibi) slope2 = __ldg(p.alibi + b * p.alibi_b + head) * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  if (n_steps > 0) {
    const uint64_t q_desc = make_desc(sQ, 16, 1024);
    const uint64_t k_desc = make_desc(sK, 16, 1024);
    const uint64_t v_desc = make_desc(sV, kCols * 128, 1024);
    float sc[kCols / 2];
    uint32_t pa[kCols / 16][4];
    // Without a softcap or ALiBi the scale folds into the exponent's FFMA
    // (it is positive, so the row max commutes with it).
    constexpr bool kScaled = kSoftcap || kAlibi;
    const float mul = kScaled ? 1.f : p.score_mul;
    mbar_wait(q_full, 0);
    for (int x = 0; x < n_steps; ++x) {
      const int s = x % kStages;
      mbar_wait(full + s, (x / kStages) & 1);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // k16 step kk: column block kk / 4, 32 bytes per step inside it.
        const uint32_t qa = ((kk >> 2) * kRows * 128 + (kk & 3) * 32) >> 4;
        const uint32_t kb =
            (s * C::kTileBytes + (kk >> 2) * kCols * 128 + (kk & 3) * 32) >> 4;
        wgmma_ss<T, kCols>(sc, q_desc + qa, k_desc + kb, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Element x is row (x >> 1) & 1, step column (x >> 2) * 8 + 2 tig +
      // (x & 1): the columns of pair x >> 2 sit side by side in sCol.
      const int* cols = sCol + s * kCols;
      // Ascending columns: the last one bounds the step.
      const int last = cols[kCols - 1];
      const bool full_step = (x + 1) * kCols <= n_cols && row0 + kRows <= rows &&
                             last >= 0 && in_window(last, row0 + off, -1, right);
      if constexpr (kSoftcap) {
#pragma unroll
        for (int e = 0; e < kCols / 2; ++e) {
          sc[e] = tanhf(sc[e] * p.score_mul) * p.cap_log2;
        }
      } else if constexpr (kAlibi) {
#pragma unroll
        for (int e = 0; e < kCols / 2; ++e) sc[e] *= p.score_mul;
      }
      if (kAlibi || !full_step) {
#pragma unroll
        for (int pr = 0; pr < kCols / 8; ++pr) {
          const int2 cc =
              *reinterpret_cast<const int2*>(cols + pr * 8 + 2 * tig);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int col = (e & 1) ? cc.y : cc.x;
            float& y = sc[4 * pr + e];
            if constexpr (kAlibi) {
              y -= slope2 * fabsf(static_cast<float>(col - diag[i]));
            }
            if (!full_step &&
                !(col >= 0 && row_ok[i] && in_window(col, diag[i], -1, right))) {
              y = -INFINITY;
            }
          }
        }
      }
      float tmax[2] = {kMask, kMask};
#pragma unroll
      for (int e = 0; e < kCols / 2; ++e) {
        tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], sc[e]);
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(tmax[i]) * mul);
        alpha[i] = exp2_approx(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int e = 0; e < kCols / 2; ++e) {
        const int i = (e >> 1) & 1;
        const float pe = exp2_approx(fmaf(sc[e], mul, -m[i]));  // masked: 0
        l[i] += pe;
        sc[e] = pe;
      }
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pa[kk][j] = Mma<T>::pack(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
        }
      }
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        wgmma_rs<T, D>(o, pa[kk],
                       v_desc + ((s * C::kTileBytes + kk * 16 * 128) >> 4), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
  }

  // O / l and the LSE of this thread's rows below `rows`, 4 bytes at a time.
  T* out = static_cast<T*>(p.out) + b * p.o_b + head * p.o_h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    if (!row_ok[i]) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    T* dst = out + static_cast<long long>(row[i]) * p.o_s + tig * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          Mma<T>::pack(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    }
    if (tig == 0) {
      p.lse[(static_cast<long long>(b) * p.h + head) * p.sq + row[i]] =
          lsum > 0.f ? (m[i] + log2f(lsum)) * kLn2 : -INFINITY;
    }
  }
}

template <typename T, int D, bool kSoftcap, bool kAlibi>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = Cfg<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      gather_sm90_kernel<T, D, kSoftcap, kAlibi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  // All of the SM's unified L1/shared memory as shared memory: two blocks
  // need nearly all of it.
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(gather_sm90_kernel<T, D, kSoftcap, kAlibi>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.h, p.nqb, batch);
  gather_sm90_kernel<T, D, kSoftcap, kAlibi>
      <<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The softcap and ALiBi are template parameters, so a kernel without one
// carries no tanh (or bias) in its score loop.
template <typename T, int D>
int dispatch(const Params& p, int batch, cudaStream_t s) {
  if (p.alibi) {
    return p.cap_log2 > 0.f ? launch<T, D, true, true>(p, batch, s)
                            : launch<T, D, false, true>(p, batch, s);
  }
  return p.cap_log2 > 0.f ? launch<T, D, true, false>(p, batch, s)
                          : launch<T, D, false, false>(p, batch, s);
}

}  // namespace gather90
}  // namespace fa
