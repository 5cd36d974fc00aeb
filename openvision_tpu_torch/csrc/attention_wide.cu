// The forward attention kernel (attention_fwd.cuh) at the padded head_dims
// above 64 (80, 96, 112, 128: H/14's 80 and So400m's 72 among them), built
// beside attention.cu in a build of its own; attention.cu's entries call
// these.
#include "attention_fwd.cuh"

int attention_wide(const void* qkv, void* out, int batch, int seq, int heads, int head_dim,
                   float scale, int nomax, int causal, int prefix, int out_f32, void* stream) {
  return by_head_dim<80, 96, 112, 128>(head_dim, [&](auto hdp) {
    return fwd_packed<decltype(hdp)::value>(qkv, out, batch, seq, heads, head_dim, scale, nomax,
                                            causal, prefix, out_f32, stream);
  });
}

int flash_attention_wide(const void* q, const void* k, const void* v, void* out, void* lse,
                         const long long* strides, int batch, int lq, int lk, int heads,
                         int head_dim, float scale, int prescale, int causal, int prefix,
                         int nomax, void* stream) {
  return by_head_dim<80, 96, 112, 128>(head_dim, [&](auto hdp) {
    return fwd_flash<decltype(hdp)::value>(q, k, v, out, lse, strides, batch, lq, lk, heads,
                                           head_dim, scale, prescale, causal, prefix, nomax,
                                           stream);
  });
}
