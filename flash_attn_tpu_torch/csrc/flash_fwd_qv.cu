// Kernel 1's forward at MLA's widths: d 64 and dv 512, with qv (the
// absorbed scores, S = Q K^T + Qv V^T) or without it, causal or not, over
// dense (b, s, h, .) inputs: mla_attn.cuh's kernel with each batch row its
// own "page". A source of its own, so that csrc/flash_fwd.cu keeps its
// instances.

#include "mla_attn.cuh"

namespace {

template <bool kHasQv>
int dispatch(const fa::mla::Params& p, int is_fp16, cudaStream_t s) {
  return is_fp16 ? fa::mla::launch<__half, kHasQv, false>(p, s)
                 : fa::mla::launch<__nv_bfloat16, kHasQv, false>(p, s);
}

}  // namespace

// q (b, h, sq, 64), qv (b, h, sq, 512) or null, k (b, hk, sk, 64), v (b,
// hk, sk, 512), out (b, h, sq, 512) in q's type, each through its (batch,
// head, seq) element strides (15 in `strides`, in that order of tensors;
// qv's ignored when it is null); lse (b, h, sq) fp32. Query row t sits at
// sk - sq + t (bottom-right aligned) when causal. Returns 0 or a
// cudaError_t. Launches on `stream`; does not synchronise.
extern "C" int flash_fwd_qv(const void* q, const void* qv, const void* k,
                            const void* v, void* out, float* lse,
                            const long long* strides, int batch, int h,
                            int hk, int sq, int sk, float scale, int causal,
                            int is_fp16, void* stream) {
  fa::mla::Params p = {};
  p.q = q;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_st = strides[2];
  p.qv = qv;
  p.qv_sb = strides[3];
  p.qv_sh = strides[4];
  p.qv_st = strides[5];
  p.k = k;
  p.v = v;
  p.k_sp = strides[6];
  p.k_sh = strides[7];
  p.k_ss = strides[8];
  p.v_sp = strides[9];
  p.v_sh = strides[10];
  p.v_ss = strides[11];
  p.page = sk;
  p.max_pages = 1;
  p.npages = batch;
  p.seqlen_k = sk;
  p.out = out;
  p.o_sb = strides[12];
  p.o_sh = strides[13];
  p.o_st = strides[14];
  p.lse = lse;
  p.num_splits = 1;
  p.batch = batch;
  p.sq = sq;
  p.h = h;
  p.hk = hk;
  p.group = h / hk;
  p.score_mul = scale * fa::kLog2e;
  p.causal = causal != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return qv ? dispatch<true>(p, is_fp16, s) : dispatch<false>(p, is_fp16, s);
}
