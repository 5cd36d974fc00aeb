// The pieces the attention kernels share (attention.cu's forward,
// attention_bwd.cu's backward pair): head_dim-64 operands read by TMA in
// 64-row boxes of one head, 128-byte swizzled, and wgmma on them.
//
// Every operand is a (batch, rows, heads, 64) bf16 view at element strides
// (batch, row, head) with unit stride in head_dim: the flash path's tensors,
// or q, k and v as strided views of the (B, L, 3D) QKV buffer. Its tensor
// map is the (64, heads, rows, batch) view read in (64, 1, 64, 1) boxes:
// one head's 64 rows of 128 bytes, one swizzle span each, zero-filled past
// the last row, so ragged tiles need no predicates on load.
//
// The fragments are wgmma's: a 64 x N f32 accumulator d over the
// warpgroup's 128 threads holds d[4j + e] = row 16 w + lane / 4 + 8 (e >> 1),
// column 8 j + 2 (lane % 4) + (e & 1) (w: the warp). Rounded to bf16 in
// place, k16 columns of it are wgmma's register A operand (pack_a), so a
// score tile becomes the next product's A without going through shared
// memory.
#pragma once

#include "hopper.cuh"

namespace ovt {
namespace attn {

namespace hp = ovt::hopper;

constexpr int HD = 64;                   // head_dim the kernels take
constexpr int BT = 64;                   // rows of a box
constexpr int kTileBytes = BT * HD * 2;  // 8 KB: 64 rows of 128 bytes
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // in elements: batch, row (sequence position), head
  long long b;
  int l, h;
};

inline Strides strides_of(const long long* s, int i) {
  return Strides{s[3 * i], static_cast<int>(s[3 * i + 1]), static_cast<int>(s[3 * i + 2])};
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A 64-row box of one head (TMA, 128-byte swizzled) into shared memory.
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                          int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(ovt::smem_u32(bar)), "r"(0),
         "r"(h), "r"(row), "r"(b)
      : "memory");
}

// Descriptors of a swizzled tile of 64-row boxes laid end to end: as a
// K-major operand (the reduction along its 128-byte rows, k16 step kk), or
// as an MN-major B operand (the reduction down its rows: 16 rows a k16
// step; N = the 64 values of a row).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return hp::desc_sw128(tile + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return hp::desc_sw128(tile + kk * 2048, hp::kChunkBytes, 1024);
}

#define OVT_F4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define OVT_F8(i) OVT_F4(i), OVT_F4((i) + 4)
#define OVT_F16(i) OVT_F8(i), OVT_F8((i) + 8)
#define OVT_F32(i) OVT_F16(i), OVT_F16((i) + 16)

// d (64 x N f32) = A (64 x 16) B (16 x N) + (scale_d ? d : 0), both operands
// K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : OVT_F4(0)
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : OVT_F8(0)
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : OVT_F16(0)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    static_assert(N == 64, "a streamed tile is 8, 16, 32 or 64 wide");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : OVT_F32(0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers: mma.m16n8k16's A fragment
// per warp) B (16 x 64, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : OVT_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef OVT_F32
#undef OVT_F16
#undef OVT_F8
#undef OVT_F4

// Starts x (64 x N) = A . B^T over the head dim as one wgmma group, A and B
// K-major tiles.
template <int N>
__device__ __forceinline__ void start_ss(float (&x)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss<N>(x, desc_k(a, kk), desc_k(b, kk), kk);
  hp::wgmma_commit();
}

// X (64 x N f32, the accumulator layout) rounded to bf16 as wgmma's A
// fragments, one per k16 step, into f's first (N + 15) / 16 entries;
// columns past N are zero.
template <int N, int KF>
__device__ __forceinline__ void pack_a(uint32_t (&f)[KF][4], const float (&x)[N / 2]) {
  static_assert((N + 15) / 16 <= KF, "more k16 steps than fragments");
#pragma unroll
  for (int kk = 0; kk < (N + 15) / 16; ++kk) {
    f[kk][0] = ovt::pack_bf16x2(x[8 * kk], x[8 * kk + 1]);
    f[kk][1] = ovt::pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
    if constexpr (N >= 16) {
      f[kk][2] = ovt::pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
      f[kk][3] = ovt::pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
    } else {
      f[kk][2] = f[kk][3] = 0u;
    }
  }
}

// Keeps A fragments alive (and in place) until the products reading them
// have been waited for: wgmma reads its register operands asynchronously.
template <int K>
__device__ __forceinline__ void fence_frag(uint32_t (&f)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[kk][i]) :: "memory");
}

// Starts acc (64 x 64) += X . T for the first K k16 steps of X, X given as
// its A fragments, T the streamed tile's rows (MN-major): the reduction runs
// over X's columns rounded up to k16.
template <int K, int KF>
__device__ __forceinline__ void start_rs(float (&acc)[32], const uint32_t (&f)[KF][4],
                                         uint32_t tile) {
  static_assert(K <= KF, "more k16 steps than fragments");
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_rs(acc, f[kk], desc_mn(tile, kk));
  hp::wgmma_commit();
}

// Writes the warpgroup's 64 x 64 f32 fragment as bf16 rows r0.. (those
// below `rows`), row r0 + 16 w + lane / 4 times sa and the row 8 below it
// times sb, 16 bytes a lane: each row's four lanes swap their column pairs
// (hopper.cuh's transpose_quad) so that a lane holds 8 columns.
__device__ __forceinline__ void store_tile(bf16* base, long long stride, int r0, int rows,
                                           const float (&acc)[32], int warp, int lane,
                                           float sa = 1.f, float sb = 1.f) {
  const int t4 = lane & 3;
  const int ra = r0 + warp * 16 + (lane >> 2), rb = ra + 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t wa[4], wb[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * half + c;
      wa[c] = ovt::pack_bf16x2(acc[4 * j] * sa, acc[4 * j + 1] * sa);
      wb[c] = ovt::pack_bf16x2(acc[4 * j + 2] * sb, acc[4 * j + 3] * sb);
    }
    hp::transpose_quad(wa, t4);
    hp::transpose_quad(wb, t4);
    const int col = 8 * (4 * half + t4);
    if (ra < rows)
      *reinterpret_cast<uint4*>(base + (ra * stride + col)) = make_uint4(wa[0], wa[1], wa[2], wa[3]);
    if (rb < rows)
      *reinterpret_cast<uint4*>(base + (rb * stride + col)) = make_uint4(wb[0], wb[1], wb[2], wb[3]);
  }
}

// The (64, heads, rows, batch) tensor map of a (batch, rows, heads, 64) bf16
// operand at element strides `st`, read in 64-row boxes of one head. A
// dimension of size 1 takes a stride that TMA accepts (its own is never
// used). False if cuTensorMapEncodeTiled refuses the view.
inline bool head_map(CUtensorMap* map, const void* ptr, const Strides& st, int heads, int rows,
                     int batch) {
  const hp::EncodeTiledFn fn = hp::encode_tiled();
  if (fn == nullptr || !hp::bind_context()) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(st.l) * 2;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {heads > 1 ? static_cast<cuuint64_t>(st.h) * 2 : HD * 2, row,
                                 batch > 1 ? static_cast<cuuint64_t>(st.b) * 2 : row * rows};
  const cuuint32_t box[4] = {HD, 1, BT, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace attn
}  // namespace ovt
