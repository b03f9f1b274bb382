// Dense flash-attention forward: out = softmax(scale * Q K^T [masked]) V and
// the fp32 log-sum-exp of every query row.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_fwd.py:95
// (_fwd_kernel, launched at :930 by flash_attention_fwd :540), restricted to
// the features the training path uses: scale, bottom-right-aligned causal,
// sliding window (left, right), GQA/MQA, softcap, head dim 64 or 128,
// bf16/fp16 inputs. The TPU schedule (clamped index maps, folded causal
// grid, 128-lane LSE padding, lane-replicated m/l scratch) is not carried
// over.
//
// Function. Query row i of head hq sees key column j of kv head
// hq / (h / hk) iff j < sk and, with diag = i + sk - sq, j >= diag - left
// (left >= 0) and j <= diag + right (right >= 0); causal is right = 0.
// Scores are s * scale, or tanh(s * scale / softcap) * softcap. Online
// softmax in fp32 (base 2). out = acc / l in q's type; lse = m + ln(l)
// in fp32, natural log; a row that sees no column gives out 0, lse -inf.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * d flops
// for every visible (query head, row, column) triple against q, k, v and
// out moved once. At training shapes (s = 2048, d = 64) that is ~300 flops
// per byte, at or above the card's ridge (~295), so the kernel is bound by
// operations; at short sequences or d = 128 with a narrow window it can be
// bound by bytes.
//
// Design (simple first; no wgmma/TMA yet). One block of 4 warps per
// (64 query rows, query head, batch row); each warp owns 16 rows, and
// blocks of the last rows (the longest causal rows) launch first. Q stays
// in registers as mma.sync A fragments. The block walks only the key tiles
// (64 columns each) that the causal/window range makes visible to its rows;
// K and V tiles are copied with 16-byte cp.async, double-buffered, so the
// next tile loads while this one computes. S = Q K^T and O += P V run on
// mma.sync.m16n8k16 with fp32 accumulation; P is re-packed to 16 bits from
// the S accumulators in registers. Tiles wholly inside every row's visible
// range skip the per-element mask. Inputs are read through their strides,
// so (b, s, h, d) tensors viewed as (b, h, s, d) are taken without a copy.

#include "mma_utils.cuh"

namespace {

using namespace fa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileM = kWarps * 16;  // query rows per block
constexpr int kTileN = 64;           // key columns per shared-memory tile

struct FwdParams {
  const void* q;  // (b, h, sq, d), strides below (elements), last dim dense
  const void* k;  // (b, hk, sk, d)
  const void* v;  // (b, hk, sk, d)
  void* out;      // (b, h, sq, d)
  float* lse;     // (b, h, sq) contiguous
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  int h, group, sq, sk;
  int left, right;  // normalised window; negative = unbounded
  // Score in base 2: x * score_mul, or tanh(x * score_mul) * cap_log2
  // with a softcap (score_mul = scale / softcap, cap_log2 = softcap*log2 e).
  float score_mul, cap_log2;
  bool has_softcap;
};

template <typename T, int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FwdParams p) {
  constexpr int kStride = D + 8;  // padded smem row: conflict-free fragments
  constexpr int kKSteps = D / 16;
  constexpr int kNTiles = kTileN / 8;
  constexpr int kOTiles = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][kTileN][kStride]
  T* sV = sK + 2 * kTileN * kStride;       // [2][kTileN][kStride]

  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int g = head / p.group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int off = p.sk - p.sq;
  const int row0 = m_block * kTileM;
  const int row_last = min(row0 + kTileM, p.sq) - 1;

  // Key columns visible to any row of this block.
  const int col_lo = p.left >= 0 ? max(row0 + off - p.left, 0) : 0;
  const int col_hi =
      p.right >= 0 ? min(row_last + off + p.right, p.sk - 1) : p.sk - 1;
  const int tile_lo = col_lo / kTileN;
  const int n_tiles = col_hi >= col_lo ? col_hi / kTileN - tile_lo + 1 : 0;

  // This thread's two rows: gid and gid + 8 of the warp's 16.
  int diag[2];
  bool row_ok[2];
  const T* qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + gid + 8 * i;
    row_ok[i] = r < p.sq;
    diag[i] = r + off;
    qrow[i] = static_cast<const T*>(p.q) + b * p.q_b + head * p.q_h +
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

  const T* kbase = static_cast<const T*>(p.k) + b * p.k_b + g * p.k_h;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_b + g * p.v_h;

  auto load_tile = [&](int tile, int stage) {
    constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
    for (int c = tid; c < kTileN * kChunksPerRow; c += kThreads) {
      const int tok = c / kChunksPerRow;
      const int part = c % kChunksPerRow;
      const int col = tile * kTileN + tok;
      const int bytes = col < p.sk ? 16 : 0;
      const long long src = static_cast<long long>(min(col, p.sk - 1));
      cp_async_16(sK + (stage * kTileN + tok) * kStride + part * 8,
                  kbase + src * p.k_s + part * 8, bytes);
      cp_async_16(sV + (stage * kTileN + tok) * kStride + part * 8,
                  vbase + src * p.v_s + part * 8, bytes);
    }
  };

  if (n_tiles > 0) load_tile(tile_lo, 0);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_tile(tile_lo + it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const T* ks_ptr = sK + stage * kTileN * kStride;
    const T* vs_ptr = sV + stage * kTileN * kStride;
    const int col0 = (tile_lo + it) * kTileN;
    // Every column of the tile visible to every row of the block?
    const bool full = row0 + kTileM <= p.sq && col0 + kTileN <= p.sk &&
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
        const int col = col0 + nt * 8 + tig * 2 + (e & 1);
        float x = s[nt][e];
        x = kSoftcap ? tanhf(x * p.score_mul) * p.cap_log2 : x * p.score_mul;
        const bool ok = full || (row_ok[i] && col < p.sk &&
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
    T* out = static_cast<T*>(p.out) + b * p.o_b + head * p.o_h +
             static_cast<long long>(r) * p.o_s;
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt) {
      *reinterpret_cast<uint32_t*>(out + nt * 8 + tig * 2) =
          Mma<T>::pack(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
    }
    if (tig == 0) {
      p.lse[(static_cast<long long>(b) * p.h + head) * p.sq + r] =
          lsum > 0.f ? (m[i] + log2f(lsum)) * kLn2 : -INFINITY;
    }
  }
}

template <typename T, int D, bool kSoftcap>
int launch_kernel(const FwdParams& p, int batch, cudaStream_t stream) {
  const size_t smem = 2 * 2 * kTileN * (D + 8) * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kSoftcap>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + kTileM - 1) / kTileM, p.h, batch);
  flash_fwd_kernel<T, D, kSoftcap><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The softcap is a template parameter, so a kernel without one carries no
// tanh in its score loop.
template <typename T, int D>
int launch(const FwdParams& p, int batch, cudaStream_t stream) {
  return p.has_softcap ? launch_kernel<T, D, true>(p, batch, stream)
                       : launch_kernel<T, D, false>(p, batch, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) of q, k, v and out.
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported head
// dim. Launches on `stream`; does not synchronise.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, const long long* strides,
                         int batch, int h, int hk, int sq, int sk, int d,
                         float scale, int window_left, int window_right,
                         float softcap, int is_fp16, void* stream) {
  FwdParams p;
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
  p.left = window_left;
  p.right = window_right;
  p.has_softcap = softcap > 0.f;
  p.score_mul = p.has_softcap ? scale / softcap : scale * kLog2e;
  p.cap_log2 = softcap * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    if (d == 64) return launch<__half, 64>(p, batch, s);
    if (d == 128) return launch<__half, 128>(p, batch, s);
  } else {
    if (d == 64) return launch<__nv_bfloat16, 64>(p, batch, s);
    if (d == 128) return launch<__nv_bfloat16, 128>(p, batch, s);
  }
  return -1;
}
