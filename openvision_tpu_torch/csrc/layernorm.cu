// Row LayerNorm over the feature dim: bf16 in, f32 statistics, bf16 out.
// Further down: its backward and column sums, and the int8 serving path's
// LayerNorm + per-row quantise and per-row quantise.
//
// Replaces the LN prologue of the Pallas kernels _mhsa_t_kernel and
// _mlp_t_kernel (openvision_tpu/ops/fused_encoder.py:71, :502) and of the
// natural-layout block _block_kernel (openvision_tpu/ops/fused_attention.py
// :440, whose E[x^2] - mean^2 variance differs from this two-pass one by f32
// rounding only). Bound on the
// card by device-memory bytes (one read and one write of the row; the three
// passes over the row after the first hit L1). One warp owns one row and
// moves 16 bytes a lane, so a block touches contiguous memory and no shared
// memory or block-wide barrier is needed.
#include "common.cuh"

namespace {

using ovt::bf16;

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, bf16* __restrict__ y,
                 int rows, int d, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + static_cast<size_t>(row) * d;
  bf16* yr = y + static_cast<size_t>(row) * d;

  float sum = 0.f;
  for (int i = lane * 8; i < d; i += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + i);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = ovt::unpack_bf16x2(w[j]);
      sum += f.x + f.y;
    }
  }
  const float mean = ovt::warp_sum(sum) / d;

  float sq = 0.f;  // two-pass variance, as the jnp reference (jnp.var)
  for (int i = lane * 8; i < d; i += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + i);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = ovt::unpack_bf16x2(w[j]);
      sq += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
    }
  }
  const float rstd = rsqrtf(ovt::warp_sum(sq) / d + eps);

  for (int i = lane * 8; i < d; i += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + i);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = ovt::unpack_bf16x2(w[j]);
      const int c = i + 2 * j;
      o[j] = ovt::pack_bf16x2((f.x - mean) * rstd * gamma[c] + beta[c],
                              (f.y - mean) * rstd * gamma[c + 1] + beta[c + 1]);
    }
    *reinterpret_cast<uint4*>(yr + i) = out;
  }
}

}  // namespace

// x, y: (rows, d) bf16, rows contiguous, 16-byte aligned; d % 8 == 0.
// gamma, beta: (d,) f32. Returns cudaGetLastError() after the launch.
extern "C" int ovt_layernorm(const void* x, const void* gamma, const void* beta,
                             void* y, int rows, int d, float eps, void* stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  layernorm_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(y), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// LayerNorm backward and column sums
// ---------------------------------------------------------------------------
//
// Replace the LN backward and the packed vector gradients of the Pallas
// backward _block_bwd_kernel (openvision_tpu/ops/fused_attention.py:833-854):
//   dx = g + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
//   dxhat = dy * gamma, in f32 and rounded once to x's dtype;
//   dgamma = sum_rows dy * xhat, dbeta = sum_rows dy          (f32)
// and the bias gradients dbq/dbk/dbv (over dq/dk/dv) and dbo (over g). The
// Pallas kernel adds each image's sums into f32 accumulators that live across
// its grid; here every block (LN) or every image (column sums) writes a
// partial, and a second pass reduces the partials. Bound on the H100 by
// device memory: each input is read once.

namespace {

// Per-block partial column sums, [blocks][2][d] f32 (dgamma, dbeta). Each warp
// walks rows with a grid stride and keeps its lanes' columns in registers;
// the block's warps add their partials in shared memory in a fixed order.
template <int NC>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ dy, const bf16* __restrict__ g,
                     bf16* __restrict__ dx, float* __restrict__ part, int rows, int d,
                     float eps) {
  extern __shared__ float red[];  // 2 * d
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float pg[NC][8], pb[NC][8];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) pg[c][j] = pb[c][j] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * d;
    float xv[NC][8], dv[NC][8];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = lane * 8 + c * 256;
      if (i >= d) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(x + base + i);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = ovt::unpack_bf16x2(w[j]);
        xv[c][2 * j] = f.x;
        xv[c][2 * j + 1] = f.y;
        sum += f.x + f.y;
      }
      const float4 a = *reinterpret_cast<const float4*>(dy + base + i);
      const float4 b = *reinterpret_cast<const float4*>(dy + base + i + 4);
      dv[c][0] = a.x; dv[c][1] = a.y; dv[c][2] = a.z; dv[c][3] = a.w;
      dv[c][4] = b.x; dv[c][5] = b.y; dv[c][6] = b.z; dv[c][7] = b.w;
    }
    const float mean = ovt::warp_sum(sum) / d;
    float sq = 0.f;  // two-pass variance, as the forward kernel
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (lane * 8 + c * 256 >= d) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) sq += (xv[c][j] - mean) * (xv[c][j] - mean);
    }
    const float rstd = rsqrtf(ovt::warp_sum(sq) / d + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = lane * 8 + c * 256;
      if (i >= d) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        xv[c][j] = (xv[c][j] - mean) * rstd;  // xhat
        const float dxh = dv[c][j] * gamma[i + j];
        s1 += dxh;
        s2 += dxh * xv[c][j];
        pg[c][j] += dv[c][j] * xv[c][j];
        pb[c][j] += dv[c][j];
      }
    }
    s1 = ovt::warp_sum(s1) / d;
    s2 = ovt::warp_sum(s2) / d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = lane * 8 + c * 256;
      if (i >= d) continue;
      float gv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (g) {
        const uint4 v = *reinterpret_cast<const uint4*>(g + base + i);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = ovt::unpack_bf16x2(w[j]);
          gv[2 * j] = f.x;
          gv[2 * j + 1] = f.y;
        }
      }
      uint4 out;
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float r[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int jj = 2 * j + t;
          const float dxh = dv[c][jj] * gamma[i + jj];
          r[t] = gv[jj] + rstd * (dxh - s1 - xv[c][jj] * s2);
        }
        o[j] = ovt::pack_bf16x2(r[0], r[1]);
      }
      *reinterpret_cast<uint4*>(dx + base + i) = out;
    }
  }

  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int i = lane * 8 + c * 256;
        if (i >= d) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          red[i + j] = w == 0 ? pg[c][j] : red[i + j] + pg[c][j];
          red[d + i + j] = w == 0 ? pb[c][j] : red[d + i + j] + pb[c][j];
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 2 * d; i += kWarps * 32)
    part[static_cast<size_t>(blockIdx.x) * 2 * d + i] = red[i];
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// out[s][c] = sum of column c over rows [s * seg_len, (s + 1) * seg_len) in
// f32, rounded to bf16 (and kept as f32) when `round_bf16`; one thread per
// (column, segment).
template <typename T>
__global__ void colsum_kernel(const T* __restrict__ in, float* __restrict__ out, int seg_len,
                              int n, int round_bf16) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const size_t r0 = static_cast<size_t>(blockIdx.y) * seg_len;
  float s = 0.f;
  for (int r = 0; r < seg_len; ++r) s += to_f32(in[(r0 + r) * n + c]);
  if (round_bf16) s = __bfloat162float(__float2bfloat16(s));
  out[static_cast<size_t>(blockIdx.y) * n + c] = s;
}

template <typename T>
int colsum(const T* in, float* out, float* work, int rows, int n, int seg_len, int round_bf16,
           cudaStream_t st) {
  const int segments = rows / seg_len;
  const dim3 grid((n + 255) / 256, segments);
  colsum_kernel<T><<<grid, 256, 0, st>>>(in, segments > 1 ? work : out, seg_len, n, round_bf16);
  if (segments > 1)
    colsum_kernel<float><<<dim3((n + 255) / 256, 1), 256, 0, st>>>(work, out, segments, n, 0);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
void launch_ln_bwd(const bf16* x, const float* gamma, const float* dy, const bf16* g, bf16* dx,
                   float* part, int rows, int d, float eps, int blocks, cudaStream_t st) {
  layernorm_bwd_kernel<NC><<<blocks, kWarps * 32, 2 * d * sizeof(float), st>>>(
      x, gamma, dy, g, dx, part, rows, d, eps);
}

}  // namespace

// x, dx: (rows, d) bf16; gamma: (d,) f32; dy: (rows, d) f32; g: (rows, d)
// bf16 added to dx (the residual's gradient) or null; dvec: (2, d) f32, the
// dgamma and dbeta sums; work: (blocks, 2, d) f32 partials. All contiguous
// and 16-byte aligned; d % 8 == 0 and d <= 2048. Returns cudaGetLastError()
// after the launches.
extern "C" int ovt_layernorm_bwd(const void* x, const void* gamma, const void* dy, const void* g,
                                 void* dx, void* dvec, void* work, int rows, int d, float eps,
                                 int blocks, void* stream) {
  if (d % 8 || d > 2048 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* gm = static_cast<const float*>(gamma);
  const float* dyf = static_cast<const float*>(dy);
  const bf16* gb = static_cast<const bf16*>(g);
  bf16* dxb = static_cast<bf16*>(dx);
  float* part = static_cast<float*>(work);
  switch ((d + 255) / 256) {
    case 1: launch_ln_bwd<1>(xb, gm, dyf, gb, dxb, part, rows, d, eps, blocks, st); break;
    case 2: launch_ln_bwd<2>(xb, gm, dyf, gb, dxb, part, rows, d, eps, blocks, st); break;
    case 3: launch_ln_bwd<3>(xb, gm, dyf, gb, dxb, part, rows, d, eps, blocks, st); break;
    case 4: launch_ln_bwd<4>(xb, gm, dyf, gb, dxb, part, rows, d, eps, blocks, st); break;
    case 5: launch_ln_bwd<5>(xb, gm, dyf, gb, dxb, part, rows, d, eps, blocks, st); break;
    case 6: launch_ln_bwd<6>(xb, gm, dyf, gb, dxb, part, rows, d, eps, blocks, st); break;
    case 7: launch_ln_bwd<7>(xb, gm, dyf, gb, dxb, part, rows, d, eps, blocks, st); break;
    default: launch_ln_bwd<8>(xb, gm, dyf, gb, dxb, part, rows, d, eps, blocks, st); break;
  }
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return colsum<float>(part, static_cast<float*>(dvec), nullptr, blocks, 2 * d, blocks, 0, st);
}

// in: (rows, n) bf16 (in_f32 = 0) or f32, contiguous; out: (n,) f32, the
// column sums; rows = segments * seg_len. With more than one segment each
// segment's sum goes to work ((segments, n) f32), rounded to bf16 first when
// round_bf16 (the Pallas kernel's per-image sum of a bf16 gradient), and a
// second pass adds the segments. Returns cudaGetLastError() after the launches.
extern "C" int ovt_colsum(const void* in, int in_f32, void* out, void* work, int rows, int n,
                          int seg_len, int round_bf16, void* stream) {
  if (seg_len < 1 || rows % seg_len || (rows > seg_len && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(work);
  if (in_f32) return colsum<float>(static_cast<const float*>(in), o, w, rows, n, seg_len, round_bf16, st);
  return colsum<bf16>(static_cast<const bf16*>(in), o, w, rows, n, seg_len, round_bf16, st);
}

// ---------------------------------------------------------------------------
// int8 serving: LayerNorm + per-row quantise, and per-row quantise
// ---------------------------------------------------------------------------
//
// Replace the LN prologues and the per-token activation quantisation of the
// Pallas kernels _mhsa_t_int8_kernel and _mlp_t_int8_kernel
// (openvision_tpu/ops/fused_encoder_int8.py:39, :138): LN in f32 with the
// variance as E[x^2] - mean^2 (:58-62, :144-148; the bf16 layernorm above is
// two-pass), its f32 output never rounded to bf16, then _quant_cols (:31-36):
// scale = amax / 127 (1 where amax is 0), q = clip(rint(y / scale), -127,
// 127), by a division, not a multiply by the reciprocal, rounding half to
// even. ovt_quant_rows quantises an f32 (rows, n) input the same way: the
// attention output (:126) and the GELU hidden (:155), whose row max the fc1
// launch gives (gemm_int8.cu), so that the hidden is read once. Both are
// bound on the H100 by device memory (the input read once, int8 and one f32
// scale per row written): one warp per row, 16-byte loads, the LN row (d <=
// 2048) held in registers between its passes, no shared memory.

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int quant1(float y, float scale) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(y, scale)), -127.f), 127.f));
}

// Eight int8 values -> one 8-byte store.
__device__ __forceinline__ void store_q8(int8_t* p, const float (&y)[8], float scale) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j >> 2] |= (static_cast<uint32_t>(quant1(y[j], scale)) & 0xffu) << (8 * (j & 3));
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

__device__ __forceinline__ float row_scale(float amax) {
  return amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
}

template <int NC>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, int8_t* __restrict__ q,
                       float* __restrict__ scale, int rows, int d, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * d;
  float y[NC][8];
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = lane * 8 + c * 256;
    if (i >= d) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(x + base + i);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = ovt::unpack_bf16x2(w[j]);
      y[c][2 * j] = f.x;
      y[c][2 * j + 1] = f.y;
      s += f.x + f.y;
      sq += f.x * f.x + f.y * f.y;
    }
  }
  const float mean = ovt::warp_sum(s) / d;
  const float var = ovt::warp_sum(sq) / d - mean * mean;  // E[x^2] - mean^2, as Pallas
  const float rstd = rsqrtf(var + eps);
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = lane * 8 + c * 256;
    if (i >= d) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      y[c][j] = __fadd_rn(__fmul_rn(__fmul_rn(y[c][j] - mean, rstd), gamma[i + j]), beta[i + j]);
      amax = fmaxf(amax, fabsf(y[c][j]));
    }
  }
  const float sc = row_scale(warp_max(amax));
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = lane * 8 + c * 256;
    if (i < d) store_q8(q + base + i, y[c], sc);
  }
  if (lane == 0) scale[row] = sc;
}

// With row_amax given (the fc1 launch's row max of the GELU hidden, the
// same max of the same f32 values) the row is read once.
__global__ void __launch_bounds__(kWarps * 32)
quant_rows_kernel(const float* __restrict__ x, const float* __restrict__ row_amax,
                  int8_t* __restrict__ q, float* __restrict__ scale, int rows, int n) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + static_cast<size_t>(row) * n;
  float amax = 0.f;
  if (row_amax != nullptr) {
    amax = row_amax[row];
  } else {
    for (int i = lane * 8; i < n; i += 256) {
      const float4 a = *reinterpret_cast<const float4*>(xr + i);
      const float4 b = *reinterpret_cast<const float4*>(xr + i + 4);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)), fmaxf(fabsf(a.z), fabsf(a.w))));
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(b.x), fabsf(b.y)), fmaxf(fabsf(b.z), fabsf(b.w))));
    }
    amax = warp_max(amax);
  }
  const float sc = row_scale(amax);
  for (int i = lane * 8; i < n; i += 256) {  // after a first read, from L1/L2
    const float4 a = *reinterpret_cast<const float4*>(xr + i);
    const float4 b = *reinterpret_cast<const float4*>(xr + i + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    store_q8(q + static_cast<size_t>(row) * n + i, v, sc);
  }
  if (lane == 0) scale[row] = sc;
}

template <int NC>
void launch_ln_quant(const bf16* x, const float* gamma, const float* beta, int8_t* q,
                     float* scale, int rows, int d, float eps, cudaStream_t st) {
  layernorm_quant_kernel<NC><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      x, gamma, beta, q, scale, rows, d, eps);
}

}  // namespace

// x: (rows, d) bf16; gamma, beta: (d,) f32; q: (rows, d) int8; scale: (rows,)
// f32. All contiguous and 16-byte aligned; d % 8 == 0 and d <= 2048. Returns
// cudaGetLastError() after the launch.
extern "C" int ovt_layernorm_quant(const void* x, const void* gamma, const void* beta, void* q,
                                   void* scale, int rows, int d, float eps, void* stream) {
  if (d % 8 || d > 2048) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scale);
  switch ((d + 255) / 256) {
    case 1: launch_ln_quant<1>(xb, g, b, qo, so, rows, d, eps, st); break;
    case 2: launch_ln_quant<2>(xb, g, b, qo, so, rows, d, eps, st); break;
    case 3: launch_ln_quant<3>(xb, g, b, qo, so, rows, d, eps, st); break;
    case 4: launch_ln_quant<4>(xb, g, b, qo, so, rows, d, eps, st); break;
    case 5: launch_ln_quant<5>(xb, g, b, qo, so, rows, d, eps, st); break;
    case 6: launch_ln_quant<6>(xb, g, b, qo, so, rows, d, eps, st); break;
    case 7: launch_ln_quant<7>(xb, g, b, qo, so, rows, d, eps, st); break;
    default: launch_ln_quant<8>(xb, g, b, qo, so, rows, d, eps, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, n) f32; row_amax: (rows,) f32 max |x| of each row, or null;
// q: (rows, n) int8; scale: (rows,) f32. All contiguous and 16-byte aligned;
// n % 8 == 0. Returns cudaGetLastError() after the launch.
extern "C" int ovt_quant_rows(const void* x, const void* row_amax, void* q, void* scale, int rows,
                              int n, void* stream) {
  if (n % 8) return static_cast<int>(cudaErrorInvalidValue);
  quant_rows_kernel<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(row_amax), static_cast<int8_t*>(q),
      static_cast<float*>(scale), rows, n);
  return static_cast<int>(cudaGetLastError());
}
