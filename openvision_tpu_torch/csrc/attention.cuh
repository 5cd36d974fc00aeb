// The pieces the attention kernels share (attention.cu's forward,
// attention_bwd.cu's backward pair): operands of one head read by TMA in
// 64-row boxes, swizzled, and wgmma on them, at every head_dim that is a
// multiple of 8 from 16 (whole tiles up to 256, slabs above).
//
// Every operand is a (batch, rows, heads, hd) bf16 view at element strides
// (batch, row, head) with unit stride in head_dim: the flash path's tensors,
// or q, k and v as strided views of the (B, L, 3D) QKV buffer. The kernels
// are templated on HDP, hd rounded up to wgmma's k16 (72 -> 80, 88 -> 96,
// 104 -> 112), and a 64-row tile of an operand is HDP columns cut into
// chunks of 64, 32 and 16 columns (Hd<HDP> below: 80 = 64 + 16, 112 =
// 64 + 32 + 16, 128 = 64 + 64), each chunk one TMA box of 64 rows swizzled
// by its own row width (128, 64 or 32 bytes: one swizzle span a row), laid
// one after the other. A chunk's tensor map is the (hd, heads, rows, batch)
// view read in (width, 1, 64, 1) boxes at the chunk's first column: TMA
// zero-fills the columns past hd and the rows past the last, so the pad
// columns add nothing to q.k^T, P.V never writes them, and ragged tiles
// need no predicates on load. hd * 2 bytes must be a multiple of 16 (TMA's
// stride rule), hence hd % 8 == 0 (the wrappers zero-pad any other head_dim
// to the next multiple of 8, and one below 16 to 16).
//
// Above 256 the slab kernels (attention_slab.cu, attention_bwd_slab.cu) take
// over: their shared memory does not grow with the head_dim.
//
// The forward above 128 (attention_xwide.cu) rounds the head_dim up to 16
// as below (144, 160, .., 256) and holds the whole O in two consumer
// warpgroups' registers. The backward above 128 rounds it up to 64 (192 or
// 256: three or four 64-column chunks, TMA's zero fill past hd again) and
// splits the output columns into two parts (Part below): 0..127 and the
// rest. A CTA owns one part: it forms the scores over the whole head_dim
// (q.k^T and do.v^T, k16 steps over every chunk) and accumulates only its
// part's columns of dq, dk and dv, so its accumulator is at most 128
// columns wide, as at head_dim 128, and fits the register file. Each part
// is a launch of its own over the same grid; the two recompute the same
// scores (the dq kernel's part 0 alone writes delta).
//
// The fragments are wgmma's: a 64 x N f32 accumulator d over the
// warpgroup's 128 threads holds d[4j + e] = row 16 w + lane / 4 + 8 (e >> 1),
// column 8 j + 2 (lane % 4) + (e & 1) (w: the warp). A head_dim-wide
// accumulator is the chunks' accumulators end to end (HDP / 2 floats), so a
// row's entries keep that pattern. Rounded to bf16 in place, k16 columns of
// a score accumulator are wgmma's register A operand (pack_a), so a score
// tile becomes the next product's A without going through shared memory.
#pragma once

#include <type_traits>
#include <utility>

#include "hopper.cuh"

namespace ovt {
namespace attn {

namespace hp = ovt::hopper;

constexpr int BT = 64;  // rows of a box
constexpr float kLog2e = 1.4426950408889634f;

// The chunks of a padded head_dim HDP (a multiple of 16, 16..256): full
// 64-column chunks, then 32 and 16 for the rest.
template <int HDP>
struct Hd {
  static_assert(HDP % 16 == 0 && HDP >= 16 && HDP <= 256, "padded head_dim: 16..256, step 16");
  static constexpr int kFull = HDP / 64, kRem = HDP % 64;
  static constexpr int kChunks = kFull + (kRem >= 32 ? 1 : 0) + (kRem % 32 ? 1 : 0);
  static constexpr int kTileBytes = BT * HDP * 2;  // 64 rows of every chunk
  __host__ __device__ static constexpr int width(int c) {
    return c < kFull ? 64 : (c == kFull && kRem >= 32) ? 32 : 16;
  }
  __host__ __device__ static constexpr int col(int c) { return c <= kFull ? 64 * c : 64 * kFull + 32; }
  // byte offset of chunk c in a tile, plus `row` rows into it
  __host__ __device__ static constexpr uint32_t off(int c, int row = 0) {
    return static_cast<uint32_t>(BT * col(c) * 2 + row * width(c) * 2);
  }
};

// The backward's output columns of part P of a padded head_dim: all of them up to 128;
// above, part 0 holds columns 0..127 (chunks 0 and 1) and part 1 the rest
// (chunks 2.., 64 or 128 columns). A part's columns of a tile are laid out
// as the tile of Hd<kCols> at byte offset kOff.
template <int HDP>
constexpr int kParts = HDP <= 128 ? 1 : 2;
template <int HDP, int P>
struct Part {
  static_assert(P < kParts<HDP>, "a head_dim up to 128 has one part, above two");
  static constexpr int kCols = HDP <= 128 ? HDP : P == 0 ? 128 : HDP - 128;
  static constexpr int kCol0 = 128 * P;
  static constexpr uint32_t kOff = Hd<HDP>::off(2 * P);
};

// Calls f(std::integral_constant<int, c>) for each chunk c of Hd<HDP>, so
// that a chunk's width is a constant expression in f.
template <class F, int... C>
__device__ __forceinline__ void for_chunks_(F&& f, std::integer_sequence<int, C...>) {
  (f(std::integral_constant<int, C>{}), ...);
}
template <int HDP, class F>
__device__ __forceinline__ void for_chunks(F&& f) {
  for_chunks_(f, std::make_integer_sequence<int, Hd<HDP>::kChunks>{});
}

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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// A 64-row box of one head's columns col.. (TMA, swizzled by the map) into
// shared memory.
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(ovt::smem_u32(bar)), "r"(col),
         "r"(h), "r"(row), "r"(b)
      : "memory");
}

// One operand's tensor maps, one a chunk.
template <int HDP>
struct OpMaps {
  CUtensorMap m[Hd<HDP>::kChunks];
};

// A whole 64-row tile of one head (every chunk) into shared memory at dst;
// the barrier expects Hd<HDP>::kTileBytes for it.
template <int HDP>
__device__ __forceinline__ void load_tile(uint32_t dst, const OpMaps<HDP>& maps, uint64_t* bar,
                                          int h, int row, int b) {
  using H = Hd<HDP>;
  for_chunks<HDP>([&](auto cc) {
    constexpr int c = decltype(cc)::value;
    load_box(dst + H::off(c), &maps.m[c], bar, H::col(c), h, row, b);
  });
}

template <int HDP>
__device__ __forceinline__ void prefetch_maps(const OpMaps<HDP>& maps) {
#pragma unroll
  for (int c = 0; c < Hd<HDP>::kChunks; ++c) hp::tma_prefetch_map(&maps.m[c]);
}

// A shared-memory matrix descriptor of a chunk W columns wide, swizzled by
// its row of 2 W bytes (layout type 1: 128 B, 2: 64 B, 3: 32 B), as a
// K-major operand (the reduction along its rows, k16 step kk: 32 bytes) or
// as an MN-major B (the reduction down its rows, 16 rows a k16 step; N = the
// W values of a row). The stride offset steps 8 rows.
template <int W>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead) {
  static_assert(W == 64 || W == 32 || W == 16, "a chunk is 64, 32 or 16 columns");
  constexpr uint64_t type = W == 64 ? 1 : W == 32 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(16 * W >> 4) << 32) | (type << 62);
}
template <int W>
__device__ __forceinline__ uint64_t desc_k(uint32_t chunk, int kk) {
  return desc<W>(chunk + kk * 32, 16);
}
template <int W>
__device__ __forceinline__ uint64_t desc_mn(uint32_t chunk, int kk) {
  return desc<W>(chunk + kk * 32 * W, BT * 2 * W);
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

// d (64 x N f32) += A (64 x 16 bf16, registers: mma.m16n8k16's A fragment
// per warp) B (16 x N, MN-major in shared memory): N is a chunk's width, or
// that of several 64-column chunks side by side (128, 192, 256: the
// descriptor's leading offset steps from one chunk to the next).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : OVT_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : OVT_F16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : OVT_F32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : OVT_F32(0), OVT_F32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : OVT_F32(0), OVT_F32(32), OVT_F32(64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : OVT_F32(0), OVT_F32(32), OVT_F32(64), OVT_F32(96)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 0, "a register-A product is 16, 32, 64, 128, 192 or 256 wide");
  }
}

#undef OVT_F32
#undef OVT_F16
#undef OVT_F8
#undef OVT_F4

// Starts x (64 x N) = A . B^T over the head dim as one wgmma group, A and B
// 64-row tiles of HDP columns (K-major), `ra` and `rb` rows into them.
template <int HDP, int N>
__device__ __forceinline__ void start_ss(float (&x)[N / 2], uint32_t a, uint32_t b, int ra = 0,
                                         int rb = 0) {
  using H = Hd<HDP>;
  for_chunks<HDP>([&](auto cc) {
    constexpr int c = decltype(cc)::value, W = H::width(c);
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      wgmma_ss<N>(x, desc_k<W>(a + H::off(c, ra), kk), desc_k<W>(b + H::off(c, rb), kk),
                  c > 0 || kk > 0);
  });
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

// Starts acc (64 x HDP) += X . T for the first K k16 steps of X, X given as
// its A fragments, T a streamed tile of HDP columns (MN-major), `rt` rows
// into it: the reduction runs over X's columns rounded up to k16, one
// product a chunk of T and a step.
template <int HDP, int K, int KF>
__device__ __forceinline__ void start_rs(float (&acc)[HDP / 2], const uint32_t (&f)[KF][4],
                                         uint32_t tile, int rt = 0) {
  static_assert(K <= KF, "more k16 steps than fragments");
  using H = Hd<HDP>;
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    for_chunks<HDP>([&](auto cc) {
      constexpr int c = decltype(cc)::value, W = H::width(c);
      wgmma_rs<W>(acc + H::col(c) / 2, f[kk], desc_mn<W>(tile + H::off(c, rt), kk));
    });
  hp::wgmma_commit();
}

// Writes the warpgroup's 64 x HDP f32 fragment as bf16 rows r0.. (those
// below `rows`), columns below hd, row r0 + 16 w + lane / 4 times sa and
// the row 8 below it times sb. A 64- or 32-column chunk goes 16 bytes a lane
// (each row's four lanes swap their column pairs, hopper.cuh's
// transpose_quad, so that a lane holds 8 columns), a 16-column chunk 4
// bytes a lane.
template <int HDP>
__device__ __forceinline__ void store_tile(bf16* base, long long stride, int r0, int rows, int hd,
                                           const float (&acc)[HDP / 2], int warp, int lane,
                                           float sa = 1.f, float sb = 1.f) {
  using H = Hd<HDP>;
  const int t4 = lane & 3;
  const int ra = r0 + warp * 16 + (lane >> 2), rb = ra + 8;
  for_chunks<HDP>([&](auto cc) {
    constexpr int c = decltype(cc)::value, W = H::width(c);
    const float* d = acc + H::col(c) / 2;
    if constexpr (W >= 32) {
#pragma unroll
      for (int half = 0; half < W / 32; ++half) {
        uint32_t wa[4], wb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * half + q;
          wa[q] = ovt::pack_bf16x2(d[4 * j] * sa, d[4 * j + 1] * sa);
          wb[q] = ovt::pack_bf16x2(d[4 * j + 2] * sb, d[4 * j + 3] * sb);
        }
        hp::transpose_quad(wa, t4);
        hp::transpose_quad(wb, t4);
        const int col = H::col(c) + 8 * (4 * half + t4);
        if (col < hd) {
          if (ra < rows)
            *reinterpret_cast<uint4*>(base + (ra * stride + col)) = make_uint4(wa[0], wa[1], wa[2], wa[3]);
          if (rb < rows)
            *reinterpret_cast<uint4*>(base + (rb * stride + col)) = make_uint4(wb[0], wb[1], wb[2], wb[3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = H::col(c) + 8 * j;
        if (col < hd) {
          if (ra < rows)
            *reinterpret_cast<uint32_t*>(base + (ra * stride + col + 2 * t4)) =
                ovt::pack_bf16x2(d[4 * j] * sa, d[4 * j + 1] * sa);
          if (rb < rows)
            *reinterpret_cast<uint32_t*>(base + (rb * stride + col + 2 * t4)) =
                ovt::pack_bf16x2(d[4 * j + 2] * sb, d[4 * j + 3] * sb);
        }
      }
    }
  });
}

// The 16-byte unit u of row r of a chunk W columns wide, as the swizzle
// (address bits 7.. XOR'd into bits 4..) places it: a byte offset in the
// chunk.
template <int W>
__device__ __forceinline__ int swizzled(int r, int u) {
  return r * 2 * W + ((u ^ ((r * 2 * W >> 7) & (W / 8 - 1))) << 4);
}

// ---------------------------------------------------------------------------
// Slabs: the head_dims above 256
// ---------------------------------------------------------------------------
//
// Above 256 a 64-row tile of the whole head_dim no longer fits beside a ring
// (Q and two stages of K and V at 320: 205 KB; the backward's six tiles
// 246 KB). The slab kernels (attention_slab.cu, attention_bwd_slab.cu) stream
// the head_dim instead: a slab is `rows` rows (64, or 32 for the dk/dv
// kernel's queries) of one head's 128 columns 128 j.., two 64-column boxes
// of one map (OpMaps<64>, 128-byte swizzle) laid one after the other (chunk
// c at c * rows * 128 bytes), TMA's zero fill past hd as for a tile. In the
// backward (and the forward above 512) the score products accumulate over
// the slabs (slab_ss with `acc`), and each CTA accumulates one 128-column
// part of dq, dk and dv (or O) (slab_rs, or start_rs<128> on a 64-row
// slab): ceil(hd / 128) parts, one launch, the part in blockIdx.y. The slabs
// run through one ring of kSlabStages stages of 32 KB in a fixed order,
// loaded by a producer warp (SlabRing), so the shared memory is 129 KB at
// every head_dim. The forward from 264 to 512 (attention_slab.cu) keeps
// every slab of its Q and of 32-key K and V tiles in shared memory instead,
// one consumer warpgroup a slab, and forms the scores once.

constexpr int kSlab = 128;  // columns of a slab
constexpr int kSlabStages = 4;
constexpr int kStageBytes = 2 * BT * kSlab * 2;  // two 64-row slabs
constexpr int kSlabSmem = 1024 + kSlabStages * kStageBytes;
constexpr int kSlabThreads = 128 + 32;  // one consumer warpgroup, then the producer warp

// Slab j of one head's rows row.. (`rows` of them, the map's box) into dst.
__device__ __forceinline__ void load_slab(uint32_t dst, const OpMaps<64>& map, uint64_t* bar,
                                          int j, int h, int row, int b, int rows) {
  load_box(dst, &map.m[0], bar, kSlab * j, h, row, b);
  load_box(dst + rows * 128, &map.m[0], bar, kSlab * j + 64, h, row, b);
}

// Starts x (64 x N) (+)= A . B^T over one slab's 128 columns as one wgmma
// group, A a slab of 64 rows (a_rows apart chunks), B one of b_rows >= N
// rows; acc: add to x (a later slab), else overwrite.
template <int N>
__device__ __forceinline__ void slab_ss(float (&x)[N / 2], uint32_t a, int a_rows, uint32_t b,
                                        int b_rows, bool acc) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<N>(x, desc_k<64>(a + c * a_rows * 128, kk), desc_k<64>(b + c * b_rows * 128, kk),
                  acc || c > 0 || kk > 0);
  hp::wgmma_commit();
}

// Starts acc (64 x 128) += X . T for X's first K k16 steps (A fragments), T
// a slab of `rows` rows (MN-major): start_rs on a slab of any row count.
template <int K, int KF>
__device__ __forceinline__ void slab_rs(float (&acc)[kSlab / 2], const uint32_t (&f)[KF][4],
                                        uint32_t tile, int rows) {
  static_assert(K <= KF, "more k16 steps than fragments");
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      wgmma_rs<64>(acc + 32 * c, f[kk], desc_mn<64>(tile + c * rows * 128, kk));
  hp::wgmma_commit();
}

// The slab kernels' ring: load t goes to stage t % kSlabStages; the
// producer acquires it once its last use was released (one arrive per
// consumer warp), the consumers wait for its bytes and release it.
struct SlabRing {
  uint64_t* full;
  uint64_t* empty;
  uint32_t base;
  __device__ __forceinline__ uint32_t stage(int t) const {
    return base + (t % kSlabStages) * kStageBytes;
  }
  __device__ __forceinline__ uint64_t* bar(int t) const { return &full[t % kSlabStages]; }
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < kSlabStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __device__ __forceinline__ uint32_t acquire(int t, uint32_t bytes) const {
    const int st = t % kSlabStages;
    if (t >= kSlabStages) hp::mbar_wait(&empty[st], (t / kSlabStages - 1) & 1);
    hp::mbar_expect_tx(&full[st], bytes);
    return stage(t);
  }
  __device__ __forceinline__ uint32_t wait(int t) const {
    hp::mbar_wait(&full[t % kSlabStages], (t / kSlabStages) & 1);
    return stage(t);
  }
  __device__ __forceinline__ void release(int t, int lane) const {
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[t % kSlabStages]);
  }
};

// The tensor maps of a (batch, rows, heads, hd) bf16 operand at element
// strides `st`, one a chunk of Hd<HDP>: the (hd, heads, rows, batch) view
// read in (width, 1, box_rows, 1) boxes, swizzled by the chunk's row. A dimension
// of size 1 takes a stride that TMA accepts (its own is never used). False
// if cuTensorMapEncodeTiled refuses the view.
template <int HDP>
inline bool head_maps(OpMaps<HDP>* maps, const void* ptr, const Strides& st, int hd, int heads,
                      int rows, int batch, int box_rows = BT) {
  using H = Hd<HDP>;
  const hp::EncodeTiledFn fn = hp::encode_tiled();
  if (fn == nullptr || !hp::bind_context()) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(st.l) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {heads > 1 ? static_cast<cuuint64_t>(st.h) * 2
                                           : static_cast<cuuint64_t>(hd) * 2,
                                 row, batch > 1 ? static_cast<cuuint64_t>(st.b) * 2 : row * rows};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int c = 0; c < H::kChunks; ++c) {
    const int w = H::width(c);
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(w), 1, static_cast<cuuint32_t>(box_rows), 1};
    const CUtensorMapSwizzle sw = w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
    if (fn(&maps->m[c], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
           box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  }
  return true;
}

// Whether the kernels take head_dim hd: a multiple of 8 from 16 (up to 256
// by the tile kernels, above by the slab kernels).
inline bool head_dim_ok(int hd) { return hd % 8 == 0 && hd >= 16; }

// The backward's padded head_dim of hd: rounded up to 16 up to 128, to 64
// above (its column parts).
inline int padded_head_dim(int hd) { return hd <= 128 ? (hd + 15) / 16 * 16 : (hd + 63) / 64 * 64; }

// The forward's padded head_dim of hd up to 256: rounded up to 16 (wgmma's
// k16), at every width.
inline int fwd_padded_head_dim(int hd) { return (hd + 15) / 16 * 16; }

// Calls f(std::integral_constant<int, HDP>) if the padded head_dim hdp is
// one of kHdps; cudaErrorInvalidValue else.
template <int... kHdps, class F>
inline int by_padded(int hdp, F&& f) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  (void)((hdp == kHdps && (rc = f(std::integral_constant<int, kHdps>{}), true)) || ...);
  return rc;
}
template <int... kHdps, class F>
inline int by_head_dim(int hd, F&& f) {
  return by_padded<kHdps...>(padded_head_dim(hd), f);
}

}  // namespace attn
}  // namespace ovt
