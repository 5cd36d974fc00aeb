// The attention backward pair (attention_bwd.cuh) at the padded head_dims
// above 128 (192 and 256: any head_dim that is a multiple of 8 from 136 to
// 256), built beside attention_bwd.cu in a build of its own;
// attention_bwd.cu's entries call these. Each kernel is two launches, one a
// column part of dq (or of dk and dv).
#include "attention_bwd.cuh"

int attention_bwd_dq_xwide(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, void* delta, void* dq,
                           const long long* strides, int batch, int lq, int lk, int heads,
                           int head_dim, float scale, int causal, int prefix, int nomax,
                           float dq_scale, int dq_round, void* stream) {
  return by_head_dim<192, 256>(head_dim, [&](auto hdp) {
    return bwd_dq<decltype(hdp)::value>(q, k, v, o, dout, lse, delta, dq, strides, batch, lq, lk,
                                        heads, head_dim, scale, causal, prefix, nomax, dq_scale,
                                        dq_round, stream);
  });
}

int attention_bwd_dkv_xwide(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv,
                            const long long* strides, int batch, int lq, int lk, int heads,
                            int head_dim, float scale, int causal, int prefix, int nomax,
                            void* stream) {
  return by_head_dim<192, 256>(head_dim, [&](auto hdp) {
    return bwd_dkv<decltype(hdp)::value>(q, k, v, dout, lse, delta, dk, dv, strides, batch, lq,
                                         lk, heads, head_dim, scale, causal, prefix, nomax,
                                         stream);
  });
}
