// The forward attention kernel (attention_fwd.cuh) at the padded head_dims
// above 128 (192 and 256: any head_dim that is a multiple of 8 from 136 to
// 256), built beside attention.cu in a build of its own; attention.cu's
// entries call these. Each is two launches, one a column part of O
// (attention.cuh's Part).
#include "attention_fwd.cuh"

int attention_xwide(const void* qkv, void* out, int batch, int seq, int heads, int head_dim,
                    float scale, int nomax, int causal, int prefix, int out_f32, void* stream) {
  return by_head_dim<192, 256>(head_dim, [&](auto hdp) {
    return fwd_packed<decltype(hdp)::value>(qkv, out, batch, seq, heads, head_dim, scale, nomax,
                                            causal, prefix, out_f32, stream);
  });
}

int flash_attention_xwide(const void* q, const void* k, const void* v, void* out, void* lse,
                          const long long* strides, int batch, int lq, int lk, int heads,
                          int head_dim, float scale, int prescale, int causal, int prefix,
                          int nomax, void* stream) {
  return by_head_dim<192, 256>(head_dim, [&](auto hdp) {
    return fwd_flash<decltype(hdp)::value>(q, k, v, out, lse, strides, batch, lq, lk, heads,
                                           head_dim, scale, prescale, causal, prefix, nomax,
                                           stream);
  });
}
