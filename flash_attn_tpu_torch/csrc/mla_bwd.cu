// Kernels 2 and 3's backward at MLA's widths: d 64 and dv 512, with qv
// (dQv, and dS^T Qv in dV) or without it, causal or not, over dense
// (b, s, h, .) inputs: the kernels of mla_attn_bwd.cuh. A source of its
// own, so that csrc/flash_bwd.cu keeps its instances.

#include "mla_attn_bwd.cuh"

namespace {

using fa::mla::bwd::BwdParams;

// q, qv, k, v, dout, then the two outputs: (batch, head, seq) element
// strides of each, 21 in all.
BwdParams make_params(const void* q, const void* qv, const void* k,
                      const void* v, const void* dout, const float* lse,
                      float* delta, void* g0, void* g1,
                      const long long* s, int batch, int h, int hk, int sq,
                      int sk, float scale, int causal) {
  BwdParams p = {};
  p.q = q;
  p.q_sb = s[0];
  p.q_sh = s[1];
  p.q_st = s[2];
  p.qv = qv;
  p.qv_sb = s[3];
  p.qv_sh = s[4];
  p.qv_st = s[5];
  p.k = k;
  p.k_sb = s[6];
  p.k_sh = s[7];
  p.k_st = s[8];
  p.v = v;
  p.v_sb = s[9];
  p.v_sh = s[10];
  p.v_st = s[11];
  p.dout = dout;
  p.do_sb = s[12];
  p.do_sh = s[13];
  p.do_st = s[14];
  p.g0 = g0;
  p.g0_sb = s[15];
  p.g0_sh = s[16];
  p.g0_st = s[17];
  p.g1 = g1;
  p.g1_sb = s[18];
  p.g1_sh = s[19];
  p.g1_st = s[20];
  p.lse = lse;
  p.delta = delta;
  p.batch = batch;
  p.h = h;
  p.hk = hk;
  p.group = hk > 0 ? h / hk : 0;
  p.sq = sq;
  p.sk = sk;
  p.scale = scale;
  p.score_mul = scale * fa::kLog2e;
  p.causal = causal != 0;
  return p;
}

int dispatch(const BwdParams& p, bool has_qv, bool dq, int is_fp16,
             cudaStream_t s) {
  using fa::mla::bwd::launch_bwd;
  if (is_fp16)
    return has_qv ? launch_bwd<__half, true>(p, dq, s)
                  : launch_bwd<__half, false>(p, dq, s);
  return has_qv ? launch_bwd<__nv_bfloat16, true>(p, dq, s)
                : launch_bwd<__nv_bfloat16, false>(p, dq, s);
}

}  // namespace

// q (b, h, sq, 64), qv (b, h, sq, 512) or null, k (b, hk, sk, 64), v (b,
// hk, sk, 512), dout (b, h, sq, 512), lse (b, h, sq) fp32; writes dq (b,
// h, sq, 64), dqv (b, h, sq, 512; ignored when qv is null) and delta (b,
// h, sq) fp32. Returns 0 or a cudaError_t. Launches on `stream`; does not
// synchronise.
extern "C" int mla_bwd_dq(const void* q, const void* qv, const void* k,
                          const void* v, const void* dout, const float* lse,
                          float* delta, void* dq, void* dqv,
                          const long long* strides, int batch, int h, int hk,
                          int sq, int sk, float scale, int causal, int is_fp16,
                          void* stream) {
  const BwdParams p = make_params(q, qv, k, v, dout, lse, delta, dq, dqv,
                                  strides, batch, h, hk, sq, sk, scale, causal);
  return dispatch(p, qv != nullptr, true, is_fp16,
                  static_cast<cudaStream_t>(stream));
}

// The same inputs and the dQ kernel's delta; writes dk (b, hk, sk, 64) and
// dv (b, hk, sk, 512), each kv head's group of query heads summed.
extern "C" int mla_bwd_dkv(const void* q, const void* qv, const void* k,
                           const void* v, const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv,
                           const long long* strides, int batch, int h, int hk,
                           int sq, int sk, float scale, int causal,
                           int is_fp16, void* stream) {
  const BwdParams p = make_params(q, qv, k, v, dout, lse,
                                  const_cast<float*>(delta), dk, dv, strides,
                                  batch, h, hk, sq, sk, scale, causal);
  return dispatch(p, qv != nullptr, false, is_fp16,
                  static_cast<cudaStream_t>(stream));
}
