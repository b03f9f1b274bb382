// The qv (MLA absorbed) paths of kernels 4 and 5: mla_attn.cuh's kernel
// over a latent cache, paged (fused rope|latent pools and split (rope,
// latent) pools, kernel 4: the engine's decode steps and prefill chunks)
// or contiguous (kernel 5: generate's caches). A source of its own, so
// that csrc/paged_decode.cu and csrc/decode.cu keep their instances.

#include "mla_attn.cuh"

namespace {

template <bool kPaged>
int dispatch(const fa::mla::Params& p, int is_fp16, cudaStream_t s) {
  return is_fp16 ? fa::mla::launch<__half, true, kPaged>(p, s)
                 : fa::mla::launch<__nv_bfloat16, true, kPaged>(p, s);
}

}  // namespace

// q (b, sq, h, 64) and qv (b, sq, h, 512), contiguous; k and v the rope
// and latent views, read through pool_strides: 6 element strides, (page,
// head, slot) of k, then of v. With a table (b, max_pages) int32 the
// caches are page pools of `page` slots and `npages` pages; without one
// they are contiguous (b, hk, smax, .) caches, `page` = smax and each batch
// row its own page. seqlens (b,) int32 are total lengths, new tokens
// included; query token t sits at seqlens[b] - sq + t, causal. out (b, sq,
// h, 512) in q's type, lse (b, h, sq) fp32. Calls of at most 16 packed
// rows (sq * h / hk) may take num_splits > 1, with o_part (num_splits, b,
// sq, h, 512) and lse_part (num_splits, b, h, sq) fp32 as the workspace
// that the combine kernel, launched in this call, merges. Returns 0, a
// cudaError_t, or -3 for splits the call cannot take. Launches on
// `stream`; does not synchronise.
extern "C" int mla_decode_fwd(const void* q, const void* qv, const void* k,
                              const void* v, void* out, float* lse,
                              const int* seqlens, const int* table, int batch,
                              int sq, int h, int hk, int page, int max_pages,
                              int npages, const long long* pool_strides,
                              float scale, int causal, int is_fp16,
                              float* o_part, float* lse_part, int num_splits,
                              void* stream) {
  fa::mla::Params p = {};
  const long long row = static_cast<long long>(h) * fa::mla::kD;
  const long long vrow = static_cast<long long>(h) * fa::mla::kDV;
  p.q = q;
  p.q_sb = sq * row;
  p.q_sh = fa::mla::kD;
  p.q_st = row;
  p.qv = qv;
  p.qv_sb = sq * vrow;
  p.qv_sh = fa::mla::kDV;
  p.qv_st = vrow;
  p.k = k;
  p.v = v;
  p.k_sp = pool_strides[0];
  p.k_sh = pool_strides[1];
  p.k_ss = pool_strides[2];
  p.v_sp = pool_strides[3];
  p.v_sh = pool_strides[4];
  p.v_ss = pool_strides[5];
  p.table = table;
  p.page = page;
  p.max_pages = max_pages;
  p.npages = npages;
  p.seqlens = seqlens;
  p.out = out;
  p.o_sb = sq * vrow;
  p.o_sh = fa::mla::kDV;
  p.o_st = vrow;
  p.lse = lse;
  p.o_part = o_part;
  p.lse_part = lse_part;
  p.num_splits = num_splits;
  p.batch = batch;
  p.sq = sq;
  p.h = h;
  p.hk = hk;
  p.group = h / hk;
  p.score_mul = scale * fa::kLog2e;
  p.causal = causal != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return table ? dispatch<true>(p, is_fp16, s) : dispatch<false>(p, is_fp16, s);
}
