// The attention backward pair (attention_bwd.cuh) at the padded head_dims
// above 64 (80, 96, 112, 128), built beside attention_bwd.cu in a build of
// its own; attention_bwd.cu's entries call these.
#include "attention_bwd.cuh"

int attention_bwd_dq_wide(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const void* lse, void* delta, void* dq,
                          const long long* strides, int batch, int lq, int lk, int heads,
                          int head_dim, float scale, int causal, int prefix, int nomax,
                          float dq_scale, int dq_round, void* stream) {
  return by_head_dim<80, 96, 112, 128>(head_dim, [&](auto hdp) {
    return bwd_dq<decltype(hdp)::value>(q, k, v, o, dout, lse, delta, dq, strides, batch, lq, lk,
                                        heads, head_dim, scale, causal, prefix, nomax, dq_scale,
                                        dq_round, stream);
  });
}

int attention_bwd_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv,
                           const long long* strides, int batch, int lq, int lk, int heads,
                           int head_dim, float scale, int causal, int prefix, int nomax,
                           void* stream) {
  return by_head_dim<80, 96, 112, 128>(head_dim, [&](auto hdp) {
    return bwd_dkv<decltype(hdp)::value>(q, k, v, dout, lse, delta, dk, dv, strides, batch, lq,
                                         lk, heads, head_dim, scale, causal, prefix, nomax,
                                         stream);
  });
}
