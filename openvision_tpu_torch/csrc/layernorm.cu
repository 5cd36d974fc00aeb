// Row LayerNorm over the feature dim: bf16 in, f32 statistics, bf16 out, and
// the int8 serving path's LayerNorm + per-row quantise, both on one
// persistent row stream (below); further down the LN backward, column sums
// and the per-row quantise of f32 rows.
//
// The bf16 LayerNorm replaces the LN prologue of the Pallas kernels
// _mhsa_t_kernel and _mlp_t_kernel (openvision_tpu/ops/fused_encoder.py:71,
// :502) and of the natural-layout block _block_kernel
// (openvision_tpu/ops/fused_attention.py:440, whose E[x^2] - mean^2 variance
// differs from this two-pass one by f32 rounding only).
//
// What bounds them: the bf16 LayerNorm, device-memory bytes: it reads x once
// and writes its output once (16448 x 1024 bf16 in and out: 67.4 MB, 20.1 us
// at 3.35 TB/s) and does ~10 f32 operations an element. The int8 one moves
// fewer bytes (15.1 us) but issues ~25 instructions an element, about half
// of them the IEEE division its fidelity needs, and runs near twice its
// bytes bound (PERF.md). So the design keeps enough bytes in flight, touches
// each byte once and keeps enough warps to issue from:
// - A persistent grid (kBlocksPerSm blocks an SM, at most one a tile) walks
//   tiles of kRows contiguous rows with a grid stride.
// - One producer thread copies each tile, kRows * d * 2 contiguous bytes
//   (the ragged last tile fewer), with one 1-D bulk copy (cp.async.bulk)
//   into a ring of shared-memory stages under full/empty mbarriers, up to a
//   ring ahead of the consumers: 64 KB a block (two 32 KB stages at d =
//   1024), two blocks an SM, against the 25-40 KB an SM that 3.35 TB/s over
//   132 SMs needs in flight at ~1 us of latency. A bulk copy takes no tensor
//   map, so there is nothing to encode on the host and the fresh-thread
//   fault that hopper.cuh's bind_context handles does not arise.
// - kRows = 16 consumer warps take one row each: 16 bytes a lane from
//   shared memory into registers once (no bank conflicts), release the
//   stage, then compute the statistics and the epilogue in registers and
//   store straight to device memory while the producer refills the stage.
//   34 warps an SM hide the latency of the reductions and, in the int8
//   epilogue, of the per-element IEEE division (16-row tiles measured 4-12%
//   faster than 8-row ones, PERF.md).
// - gamma and beta are staged in shared memory once a block, lane-major, so
//   a lane's eight values are two conflict-free 16-byte loads.
// The epilogue is a template argument (the bf16 LayerNorm here, the int8
// one further down), and so is NC = ceil(d / 256) <= 8: a lane holds NC
// chunks of 8 values of its row (d <= 2048).
#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

namespace hp = ovt::hopper;
using ovt::bf16;

constexpr int kWarps = 8;  // quant_rows' blocks

constexpr int kRows = 16;                         // consumer warps: the rows of a tile
constexpr int kStreamThreads = (kRows + 1) * 32;  // + the producer warp
constexpr int kRingBytes = 64 * 1024;             // a block's ring, at least two stages
constexpr int kMaxStages = 8;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxWidth = 2048;  // NC <= 8

// `bytes` contiguous bytes of global memory into shared memory; completes
// them on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(ovt::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(ovt::smem_u32(bar))
      : "memory");
}

// gamma or beta, staged lane-major: element e at float4 slot (2 * (e / 256)
// + (e / 4) % 2) * 32 + (e / 8) % 32, so that lane l's values 8l..8l+7 of
// chunk c are the float4s (2c) * 32 + l and (2c + 1) * 32 + l.
__device__ __forceinline__ int vec_slot(int e) {
  return ((e >> 8) * 2 + ((e >> 2) & 1)) * 32 + ((e >> 3) & 31);
}

__device__ __forceinline__ void load_vec8(const float4* sv, int c, int lane, float (&v)[8]) {
  const float4 a = sv[2 * c * 32 + lane], b = sv[(2 * c + 1) * 32 + lane];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The row stream. x: (rows, d) bf16, d % 8 == 0; `stages` ring stages of
// kRows rows. Epi::finish<NC>(v, gamma, beta, row, lane, d, eps) takes the
// row's values (chunk c, lane's 8 values at c * 256 + 8 * lane, those below
// d) and writes the row's output.
template <int NC, class Epi>
__global__ void __launch_bounds__(kStreamThreads)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, Epi epi, int rows, int d, int stages, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  float4* sg = reinterpret_cast<float4*>(smem);  // NC * 64 float4s each
  float4* sb = sg + NC * 64;
  uint8_t* ring = smem + NC * 64 * 16 * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (rows + kRows - 1) / kRows;
  const int row_bytes = d * 2, stage_bytes = kRows * row_bytes;

  if (threadIdx.x == kRows * 32) {
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(&full[s], 1);       // the producer's arrive, plus the bytes
      hp::mbar_init(&empty[s], kRows);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kRows) {  // the producer: one thread runs the ring ahead
    if (lane == 0) {
      for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
        const int s = it % stages;
        if (it >= stages) hp::mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        const uint32_t bytes = min(kRows, rows - t * kRows) * row_bytes;
        hp::mbar_expect_tx(&full[s], bytes);
        bulk_load(ring + s * stage_bytes, x + static_cast<size_t>(t) * kRows * d, bytes, &full[s]);
      }
    }
    return;
  }

  // gamma and beta, while the first tiles arrive
  for (int k = threadIdx.x; k < d / 4; k += kRows * 32) {
    sg[vec_slot(4 * k)] = reinterpret_cast<const float4*>(gamma)[k];
    sb[vec_slot(4 * k)] = reinterpret_cast<const float4*>(beta)[k];
  }
  hp::named_barrier(1, kRows * 32);

  for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
    const int s = it % stages;
    hp::mbar_wait(&full[s], (it / stages) & 1);
    const int row = t * kRows + warp;
    const uint4* src = reinterpret_cast<const uint4*>(ring + s * stage_bytes + warp * row_bytes);
    float v[NC][8];
    if (row < rows) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (lane * 8 + c * 256 >= d) continue;
        const uint4 u = src[c * 32 + lane];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = ovt::unpack_bf16x2(w[j]);
          v[c][2 * j] = f.x;
          v[c][2 * j + 1] = f.y;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[s]);  // the row is in registers
    if (row < rows) epi.template finish<NC>(v, sg, sb, row, lane, d, eps);
  }
}

// Launches the row stream for d's NC: a ring of kRingBytes (at least two
// stages, at most kMaxStages), kBlocksPerSm blocks an SM, at most one a
// tile. Returns a CUDA error code.
template <int NC, class Epi>
int launch_rows(const bf16* x, const float* gamma, const float* beta, const Epi& epi, int rows,
                int d, float eps, cudaStream_t st) {
  auto kernel = ln_rows_kernel<NC, Epi>;
  constexpr int kVecBytes = NC * 64 * 16 * 2;  // gamma and beta
  constexpr int kMaxRing = std::max(kRingBytes, 2 * kRows * NC * 256 * 2);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kVecBytes + kMaxRing);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int stage_bytes = kRows * d * 2;
  const int stages = std::min(kMaxStages, std::max(2, kRingBytes / stage_bytes));
  const int tiles = (rows + kRows - 1) / kRows;
  kernel<<<std::min(tiles, kBlocksPerSm * hp::sm_count()), kStreamThreads,
           kVecBytes + stages * stage_bytes, st>>>(x, gamma, beta, epi, rows, d, stages, eps);
  return static_cast<int>(cudaGetLastError());
}

// Checks the width and launches the row stream at d's NC.
template <class Epi>
int launch_ln(const void* x, const void* gamma, const void* beta, const Epi& epi, int rows, int d,
              float eps, void* stream) {
  if (d < 8 || d % 8 || d > kMaxWidth || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const bf16* xb = static_cast<const bf16*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 255) / 256) {
    case 1: return launch_rows<1>(xb, g, b, epi, rows, d, eps, st);
    case 2: return launch_rows<2>(xb, g, b, epi, rows, d, eps, st);
    case 3: return launch_rows<3>(xb, g, b, epi, rows, d, eps, st);
    case 4: return launch_rows<4>(xb, g, b, epi, rows, d, eps, st);
    case 5: return launch_rows<5>(xb, g, b, epi, rows, d, eps, st);
    case 6: return launch_rows<6>(xb, g, b, epi, rows, d, eps, st);
    case 7: return launch_rows<7>(xb, g, b, epi, rows, d, eps, st);
    default: return launch_rows<8>(xb, g, b, epi, rows, d, eps, st);
  }
}

// The bf16 LayerNorm's epilogue: two-pass variance, as the jnp reference
// (jnp.var), y = (x - mean) * rstd * gamma + beta rounded to bf16 once.
struct LnBf16 {
  bf16* y;

  template <int NC>
  __device__ __forceinline__ void finish(float (&v)[NC][8], const float4* sg, const float4* sb,
                                         int row, int lane, int d, float eps) const {
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (lane * 8 + c * 256 >= d) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += v[c][2 * j] + v[c][2 * j + 1];
    }
    const float mean = ovt::warp_sum(sum) / d;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (lane * 8 + c * 256 >= d) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sq += (v[c][2 * j] - mean) * (v[c][2 * j] - mean) +
              (v[c][2 * j + 1] - mean) * (v[c][2 * j + 1] - mean);
    }
    const float rstd = rsqrtf(ovt::warp_sum(sq) / d + eps);
    bf16* yr = y + static_cast<size_t>(row) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = lane * 8 + c * 256;
      if (i >= d) continue;
      float g[8], b[8];
      load_vec8(sg, c, lane, g);
      load_vec8(sb, c, lane, b);
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = ovt::pack_bf16x2((v[c][2 * j] - mean) * rstd * g[2 * j] + b[2 * j],
                                (v[c][2 * j + 1] - mean) * rstd * g[2 * j + 1] + b[2 * j + 1]);
      *reinterpret_cast<uint4*>(yr + i) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
};

}  // namespace

// x, y: (rows, d) bf16, rows contiguous, 16-byte aligned; d % 8 == 0 and
// d <= 2048. gamma, beta: (d,) f32, 16-byte aligned. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a width
// it does not take).
extern "C" int ovt_layernorm(const void* x, const void* gamma, const void* beta, void* y,
                             int rows, int d, float eps, void* stream) {
  return launch_ln(x, gamma, beta, LnBf16{static_cast<bf16*>(y)}, rows, d, eps, stream);
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
// partial, and a second pass reduces the partials in a fixed order (no float
// atomics: the same bits from run to run).
//
// What bounds the LN backward: device-memory bytes. It reads x (bf16), dy
// (f32) and the residual's gradient g (bf16) once and writes dx (bf16): 10
// bytes an element with g, 8 without (16448 x 1024 with g: 168.4 MB, 50.3 us
// at 3.35 TB/s), and does ~25 f32 operations an element. The statistics are
// recomputed from x with the two-pass variance, as the forward. The design
// keeps the three input streams in flight ahead of the reductions, touches
// each byte of device memory once and spills at no chunk count (PERF.md
// gives its times beside the bound, and those of the designs tried: 8-row
// tiles, 1 or 2 blocks an SM, rows loaded straight into registers with the
// next row's loads first, which was 4% faster at d <= 1024 but spills at
// NC >= 5):
// - A persistent grid (kBwdBlocksPerSm blocks an SM, fewer where the ring
//   or the registers do not fit, at most one a tile) walks tiles of
//   kBwdRows contiguous rows with a grid stride.
// - One producer thread copies each tile's x, dy and g, three contiguous
//   spans, with one 1-D bulk copy each (cp.async.bulk) into a ring of
//   shared-memory stages under full/empty mbarriers, the full barrier
//   expecting the three copies' bytes; a block's ring holds kBwdRingBytes
//   (at least two stages), so the next tile arrives while this one's
//   reductions run.
// - kBwdRows consumer warps take one row each. A lane owns columns 4 lane +
//   128 h + 256 c (h < 2, c < NC = ceil(d / 256) <= 8): 8-byte bf16 and
//   16-byte f32 reads of shared memory, conflict-free, and 8-byte stores of
//   dx, 256 contiguous bytes a warp. x is read once into registers; mean
//   and variance are two warp reductions, s1 = sum dxhat and s2 = sum dxhat
//   xhat one more with two values a step; dy, g and gamma are read from
//   shared memory where they are used (dxhat formed twice rather than held:
//   the same time, fewer registers), and the stage is released after dx is
//   stored.
// - gamma is staged in shared memory once a block; a lane's four values of
//   a column group are one 16-byte load.
// - dgamma/dbeta: each lane sums its columns over its rows in registers; at
//   the end the block's warps add theirs in shared memory in warp order and
//   the block writes one partial. layernorm_bwd_finish_kernel adds the
//   partials over 2d / 8 blocks of 8 columns (256 at d = 1024), every
//   thread its partial rows in order, then a fixed-order tree (the last
//   block adding all partials in the same launch measured ~2.8x slower).

namespace {

constexpr int kBwdRows = 4;                          // consumer warps: the rows of a tile
constexpr int kBwdThreads = (kBwdRows + 1) * 32;     // + the producer warp
constexpr int kBwdRingBytes = 64 * 1024;             // a block's ring, at least two stages
constexpr int kBwdBlocksPerSm = 3;
constexpr int kFinishCols = 8;     // the finish: columns of a block (one 32-byte sector)
constexpr int kFinishGroups = 32;  // and groups of partial rows

// The first of a lane's four columns in column group (c, h).
__device__ __forceinline__ int bwd_col(int c, int h, int lane) {
  return c * 256 + h * 128 + 4 * lane;
}

__device__ __forceinline__ void unpack_bf16x4(uint2 u, float* v) {
  const float2 a = ovt::unpack_bf16x2(u.x), b = ovt::unpack_bf16x2(u.y);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// One row of the LN backward from shared memory (xs, ds, gs: the row's x,
// dy and g, gs null without g; sg: gamma): stores dx's row and adds the
// lane's dy * xhat and dy to pg and pb.
template <int NC>
__device__ __forceinline__ void ln_bwd_row(const uint2* xs, const float4* ds, const uint2* gs,
                                           const float4* sg, bf16* dxr, float (&pg)[NC][8],
                                           float (&pb)[NC][8], int lane, int d, float eps) {
  float xv[NC][8];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = bwd_col(c, h, lane);
      if (i >= d) continue;
      float* v = &xv[c][4 * h];
      unpack_bf16x4(xs[i / 4], v);
      sum += (v[0] + v[1]) + (v[2] + v[3]);
    }
  const float mean = ovt::warp_sum(sum) / d;
  float sq = 0.f;  // two-pass variance, as the forward kernel
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (bwd_col(c, h, lane) >= d) continue;
#pragma unroll
      for (int j = 4 * h; j < 4 * h + 4; ++j) sq += (xv[c][j] - mean) * (xv[c][j] - mean);
    }
  const float rstd = rsqrtf(ovt::warp_sum(sq) / d + eps);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = bwd_col(c, h, lane);
      if (i >= d) continue;
      const float4 dv4 = ds[i / 4], gm4 = sg[i / 4];
      const float dv[4] = {dv4.x, dv4.y, dv4.z, dv4.w}, gm[4] = {gm4.x, gm4.y, gm4.z, gm4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float& xh = xv[c][4 * h + j];
        xh = (xh - mean) * rstd;
        const float dxh = dv[j] * gm[j];
        s1 += dxh;
        s2 += dxh * xh;
        pg[c][4 * h + j] += dv[j] * xh;
        pb[c][4 * h + j] += dv[j];
      }
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {  // one tree, two values a step
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  s1 /= d;
  s2 /= d;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = bwd_col(c, h, lane);
      if (i >= d) continue;
      const float4 dv4 = ds[i / 4], gm4 = sg[i / 4];
      const float dv[4] = {dv4.x, dv4.y, dv4.z, dv4.w}, gm[4] = {gm4.x, gm4.y, gm4.z, gm4.w};
      float gv[4] = {0.f, 0.f, 0.f, 0.f};
      if (gs) unpack_bf16x4(gs[i / 4], gv);
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = gv[j] + rstd * (dv[j] * gm[j] - s1 - xv[c][4 * h + j] * s2);
      *reinterpret_cast<uint2*>(dxr + i) =
          make_uint2(ovt::pack_bf16x2(r[0], r[1]), ovt::pack_bf16x2(r[2], r[3]));
    }
}

// dx and per-block partial column sums part[blocks][2][d] f32 (dgamma,
// dbeta). x, dy, g: (rows, d); `stages` ring stages of kBwdRows rows, each
// x, then dy, then g (when given).
template <int NC>
__global__ void __launch_bounds__(kBwdThreads, 1)  // up to 255 registers: no spill at any NC
layernorm_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ dy, const bf16* __restrict__ g,
                     bf16* __restrict__ dx, float* __restrict__ part, int rows, int d,
                     int stages, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  float4* sg = reinterpret_cast<float4*>(smem);  // gamma: NC * 64 float4s
  uint8_t* ring = smem + NC * 64 * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (rows + kBwdRows - 1) / kBwdRows;
  const int x_bytes = kBwdRows * d * 2;  // dy at x_bytes, g at 3 x_bytes
  const int stage_bytes = x_bytes * (g ? 4 : 3);

  if (threadIdx.x == kBwdRows * 32) {
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(&full[s], 1);          // the producer's arrive, plus the bytes
      hp::mbar_init(&empty[s], kBwdRows);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kBwdRows) {  // the producer: one thread runs the ring ahead
    if (lane == 0) {
      for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
        const int s = it % stages;
        if (it >= stages) hp::mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        const size_t first = static_cast<size_t>(t) * kBwdRows * d;
        const uint32_t n = min(kBwdRows, rows - t * kBwdRows) * d;  // elements
        uint8_t* st = ring + s * stage_bytes;
        hp::mbar_expect_tx(&full[s], n * (g ? 8 : 6));
        bulk_load(st, x + first, n * 2, &full[s]);
        bulk_load(st + x_bytes, dy + first, n * 4, &full[s]);
        if (g) bulk_load(st + 3 * x_bytes, g + first, n * 2, &full[s]);
      }
    }
    return;
  }

  for (int k = threadIdx.x; k < d / 4; k += kBwdRows * 32)  // while the first tiles arrive
    sg[k] = reinterpret_cast<const float4*>(gamma)[k];
  hp::named_barrier(1, kBwdRows * 32);

  float pg[NC][8], pb[NC][8];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) pg[c][j] = pb[c][j] = 0.f;

  for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
    const int s = it % stages;
    const int row = t * kBwdRows + warp;
    hp::mbar_wait(&full[s], (it / stages) & 1);
    if (row < rows) {
      const uint8_t* st = ring + s * stage_bytes;
      ln_bwd_row<NC>(reinterpret_cast<const uint2*>(st + warp * d * 2),
                     reinterpret_cast<const float4*>(st + x_bytes + warp * d * 4),
                     g ? reinterpret_cast<const uint2*>(st + 3 * x_bytes + warp * d * 2) : nullptr,
                     sg, dx + static_cast<size_t>(row) * d, pg, pb, lane, d, eps);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[s]);  // the row's reads are done
  }

  // the warps' sums into the drained ring, [warp][2][d], then added in warp
  // order: one partial a block
  float* red = reinterpret_cast<float*>(ring);
  hp::named_barrier(1, kBwdRows * 32);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = bwd_col(c, h, lane);
      if (i >= d) continue;
      float* r = red + static_cast<size_t>(warp) * 2 * d + i;
      *reinterpret_cast<float4*>(r) =
          make_float4(pg[c][4 * h], pg[c][4 * h + 1], pg[c][4 * h + 2], pg[c][4 * h + 3]);
      *reinterpret_cast<float4*>(r + d) =
          make_float4(pb[c][4 * h], pb[c][4 * h + 1], pb[c][4 * h + 2], pb[c][4 * h + 3]);
    }
  hp::named_barrier(1, kBwdRows * 32);
  for (int k = threadIdx.x; k < 2 * d; k += kBwdRows * 32) {
    float s = red[k];
#pragma unroll
    for (int w = 1; w < kBwdRows; ++w) s += red[w * 2 * d + k];
    part[static_cast<size_t>(blockIdx.x) * 2 * d + k] = s;
  }
}

// out[c] = sum over the `blocks` partial rows of part[.][c], c < n: a block
// takes kFinishCols columns; its thread (column, group) adds rows group,
// group + kFinishGroups, ... in order, then the groups are added in a fixed
// tree.
__global__ void __launch_bounds__(kFinishCols * kFinishGroups)
layernorm_bwd_finish_kernel(const float* __restrict__ part, float* __restrict__ out, int blocks,
                            int n) {
  __shared__ float red[kFinishGroups][kFinishCols];
  const int col = threadIdx.x % kFinishCols, grp = threadIdx.x / kFinishCols;
  const int c = blockIdx.x * kFinishCols + col;
  float s = 0.f;
  if (c < n)
    for (int r = grp; r < blocks; r += kFinishGroups) s += part[static_cast<size_t>(r) * n + c];
  red[grp][col] = s;
  __syncthreads();
#pragma unroll
  for (int half = kFinishGroups / 2; half > 0; half >>= 1) {
    if (grp < half) red[grp][col] += red[grp + half][col];
    __syncthreads();
  }
  if (grp == 0 && c < n) out[c] = red[0][col];
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

// The LN backward's ring at width d: its stages and dynamic shared bytes
// (gamma, then the ring).
template <int NC>
int bwd_smem(int d, bool has_g, int* stages) {
  const int stage_bytes = kBwdRows * d * (has_g ? 8 : 6);
  *stages = std::min(kMaxStages, std::max(2, kBwdRingBytes / stage_bytes));
  return NC * 64 * 16 + *stages * stage_bytes;
}

template <int NC>
cudaError_t bwd_smem_attr() {
  constexpr int kMaxSmem = NC * 64 * 16 + std::max(kBwdRingBytes, 2 * kBwdRows * NC * 256 * 8);
  static const cudaError_t attr = cudaFuncSetAttribute(
      layernorm_bwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return attr;
}

// The most blocks of the persistent grid at width d: kBwdBlocksPerSm an SM,
// fewer where the ring or the registers do not fit. A negative CUDA error
// code on failure.
template <int NC>
int bwd_blocks(int d, bool has_g) {
  const cudaError_t attr = bwd_smem_attr<NC>();
  if (attr != cudaSuccess) return -static_cast<int>(attr);
  int stages, per_sm = 0;
  const int smem = bwd_smem<NC>(d, has_g, &stages);
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, layernorm_bwd_kernel<NC>, kBwdThreads, smem);
  if (occ != cudaSuccess) return -static_cast<int>(occ);
  return std::max(1, std::min(kBwdBlocksPerSm, per_sm)) * hp::sm_count();
}

template <int NC>
int launch_ln_bwd(const bf16* x, const float* gamma, const float* dy, const bf16* g, bf16* dx,
                  float* part, int rows, int d, float eps, int blocks, cudaStream_t st) {
  const cudaError_t attr = bwd_smem_attr<NC>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int stages;
  const int smem = bwd_smem<NC>(d, g != nullptr, &stages);
  layernorm_bwd_kernel<NC><<<blocks, kBwdThreads, smem, st>>>(x, gamma, dy, g, dx, part, rows, d,
                                                              stages, eps);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, NC>) at d's NC = ceil(d / 256).
template <class F>
int with_nc(int d, F&& f) {
  switch ((d + 255) / 256) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

}  // namespace

// The most partial rows (blocks of its persistent grid) that
// ovt_layernorm_bwd writes at width d, with (has_g = 1) or without the
// residual's gradient: its work buffer holds (blocks, 2, d) f32. A negative
// CUDA error code for a width it does not take or a failed query.
extern "C" int ovt_layernorm_bwd_blocks(int d, int has_g) {
  if (d < 8 || d % 8 || d > kMaxWidth) return -static_cast<int>(cudaErrorInvalidValue);
  return with_nc(d, [&](auto nc) { return bwd_blocks<decltype(nc)::value>(d, has_g != 0); });
}

// x, dx: (rows, d) bf16; gamma: (d,) f32; dy: (rows, d) f32; g: (rows, d)
// bf16 added to dx (the residual's gradient) or null; dvec: (2, d) f32, the
// dgamma and dbeta sums; work: (blocks, 2, d) f32 partials, blocks from
// ovt_layernorm_bwd_blocks for the same d and g (a grid of one block a
// tile uses the first rows). All contiguous and 16-byte aligned; d % 8 == 0
// and d <= 2048. Returns cudaGetLastError() after the two launches.
extern "C" int ovt_layernorm_bwd(const void* x, const void* gamma, const void* dy, const void* g,
                                 void* dx, void* dvec, void* work, int rows, int d, float eps,
                                 int blocks, void* stream) {
  if (d < 8 || d % 8 || d > kMaxWidth || rows < 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(work);
  blocks = std::max(1, std::min(blocks, (rows + kBwdRows - 1) / kBwdRows));
  const int rc = with_nc(d, [&](auto nc) {
    return launch_ln_bwd<decltype(nc)::value>(
        static_cast<const bf16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(dy), static_cast<const bf16*>(g), static_cast<bf16*>(dx), part,
        rows, d, eps, blocks, st);
  });
  if (rc != 0) return rc;
  layernorm_bwd_finish_kernel<<<(2 * d + kFinishCols - 1) / kFinishCols,
                                kFinishCols * kFinishGroups, 0, st>>>(
      part, static_cast<float*>(dvec), blocks, 2 * d);
  return static_cast<int>(cudaGetLastError());
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
// ovt_layernorm_quant replaces the LN prologues and the per-token activation
// quantisation of the Pallas kernels _mhsa_t_int8_kernel and
// _mlp_t_int8_kernel (openvision_tpu/ops/fused_encoder_int8.py:39, :138): LN
// in f32 with the variance as E[x^2] - mean^2 (:58-62, :144-148; the bf16
// layernorm above is two-pass), its f32 output never rounded to bf16, then
// _quant_cols (:31-36): scale = amax / 127 (1 where amax is 0), q =
// clip(rint(y / scale), -127, 127), by a division, not a multiply by the
// reciprocal, rounding half to even. It runs on the row stream above (bf16
// read once, int8 and one f32 scale a row written: 16448 x 1024 is 50.4 MB,
// 15.1 us at 3.35 TB/s), with 8-byte int8 stores a lane.
// ovt_quant_rows quantises an f32 (rows, n) input the same way: the
// attention output (:126) and the GELU hidden (:155), whose row max the fc1
// launch gives (gemm_int8.cu), so that the hidden is read once. Bound on the
// H100 by device memory (the input read once, int8 and one f32 scale per row
// written): one warp per row, 16-byte loads, no shared memory.
// Both take an optional static scale instead (one f32 on the device, the
// calibrated per-tensor scale of openvision_tpu/serving/quant.py:38-50):
// q = clip(rint(y / s), -127, 127) by the same division, every row's scale
// written as s; the LayerNorm's output stays f32 before it.

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

// Eight int8 values of a LayerNorm row -> one 8-byte store: quant1's bits
// with the clamp before the rounding conversion (cvt.rni: both bounds are
// integers, and NaN still gives -127), one rounding instruction fewer.
__device__ __forceinline__ void store_ln_q8(int8_t* p, const float (&y)[8], float scale) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int v = __float2int_rn(fminf(fmaxf(__fdiv_rn(y[j], scale), -127.f), 127.f));
    w[j >> 2] |= (static_cast<uint32_t>(v) & 0xffu) << (8 * (j & 3));
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// The int8 LayerNorm's epilogue: E[x^2] - mean^2 as the Pallas body, the
// variance and the normalisation in its order without FMA contraction, then
// the per-row quantise.
struct LnQuant {
  int8_t* q;
  float* scale;
  const float* fixed;  // the static scale, or null for the row's own

  template <int NC>
  __device__ __forceinline__ void finish(float (&v)[NC][8], const float4* sg, const float4* sb,
                                         int row, int lane, int d, float eps) const {
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (lane * 8 + c * 256 >= d) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = v[c][2 * j], b = v[c][2 * j + 1];
        s += a + b;
        sq += a * a + b * b;
      }
    }
    const float mean = ovt::warp_sum(s) / d;
    // E[x^2] - mean^2 as Pallas, mean^2 rounded before the subtraction (an
    // FMA there moves the variance of an offset row by whole percents)
    const float var = __fsub_rn(ovt::warp_sum(sq) / d, __fmul_rn(mean, mean));
    const float rstd = rsqrtf(var + eps);
    float amax = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (lane * 8 + c * 256 >= d) continue;
      float g[8], b[8];
      load_vec8(sg, c, lane, g);
      load_vec8(sb, c, lane, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[c][j] = __fadd_rn(__fmul_rn(__fmul_rn(v[c][j] - mean, rstd), g[j]), b[j]);
        amax = fmaxf(amax, fabsf(v[c][j]));
      }
    }
    const float sc = fixed != nullptr ? *fixed : row_scale(warp_max(amax));
    const size_t base = static_cast<size_t>(row) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = lane * 8 + c * 256;
      if (i < d) store_ln_q8(q + base + i, v[c], sc);
    }
    if (lane == 0) scale[row] = sc;
  }
};

// With row_amax given (the fc1 launch's row max of the GELU hidden, the
// same max of the same f32 values) the row is read once.
__global__ void __launch_bounds__(kWarps * 32)
quant_rows_kernel(const float* __restrict__ x, const float* __restrict__ row_amax,
                  const float* __restrict__ fixed, int8_t* __restrict__ q,
                  float* __restrict__ scale, int rows, int n) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + static_cast<size_t>(row) * n;
  float sc;
  if (fixed != nullptr) {
    sc = *fixed;
  } else {
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
    sc = row_scale(amax);
  }
  for (int i = lane * 8; i < n; i += 256) {  // after a first read, from L1/L2
    const float4 a = *reinterpret_cast<const float4*>(xr + i);
    const float4 b = *reinterpret_cast<const float4*>(xr + i + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    store_q8(q + static_cast<size_t>(row) * n + i, v, sc);
  }
  if (lane == 0) scale[row] = sc;
}

}  // namespace

// x: (rows, d) bf16; gamma, beta: (d,) f32; q: (rows, d) int8; scale: (rows,)
// f32; fixed: one f32 static scale, or null. All contiguous and 16-byte
// aligned; d % 8 == 0 and d <= 2048. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a width it does not take).
extern "C" int ovt_layernorm_quant(const void* x, const void* gamma, const void* beta, void* q,
                                   void* scale, const void* fixed, int rows, int d, float eps,
                                   void* stream) {
  return launch_ln(x, gamma, beta,
                   LnQuant{static_cast<int8_t*>(q), static_cast<float*>(scale),
                           static_cast<const float*>(fixed)},
                   rows, d, eps, stream);
}

// x: (rows, n) f32; row_amax: (rows,) f32 max |x| of each row, or null;
// fixed: one f32 static scale, or null (then row_amax is not read); q:
// (rows, n) int8; scale: (rows,) f32. All contiguous and 16-byte aligned;
// n % 8 == 0. Returns cudaGetLastError() after the launch.
extern "C" int ovt_quant_rows(const void* x, const void* row_amax, const void* fixed, void* q,
                              void* scale, int rows, int n, void* stream) {
  if (n % 8) return static_cast<int>(cudaErrorInvalidValue);
  quant_rows_kernel<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(row_amax),
      static_cast<const float*>(fixed), static_cast<int8_t*>(q), static_cast<float*>(scale),
      rows, n);
  return static_cast<int>(cudaGetLastError());
}
