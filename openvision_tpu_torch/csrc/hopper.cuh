// The Hopper GEMM mainloop shared by gemm_bias_act.cu, gemm_grad.cu and
// gemm_int8.cu: TMA tile loads into a ring of shared-memory stages,
// completing on mbarriers, and wgmma.mma_async on them, in one
// warp-specialised persistent kernel.
//
// C[m, n] = sum_k A(m, k) B(k, n) for one of two operand types (Cfg<Op>):
// - Bf16: bf16 operands, f32 accumulators, m64n128k16. Each operand is
//   K-major (stored (rows, K), K contiguous: the forward's A and its (out,
//   in) weight) or MN-major (stored (K, rows), the rows' dimension
//   contiguous: the dgrad's weight W (K, N), the wgrad's A = dC^T read from
//   dC (K, M)), which wgmma reads through its transpose bit.
// - S8: int8 operands, s32 accumulators (exact sums), m64n128k32 or, with a
//   128 x 256 tile, m64n256k32. wgmma has no transpose bit for 8-bit types,
//   so both operands are K-major (the int8 forward's A and its (out, in)
//   weight). TMA moves the bytes as UINT8 (there is no signed 8-bit map).
// The bytes line up: a stage row is 128 bytes of K in both (64 bf16 or 128
// int8 values, one 128-byte swizzle span), a k-step reads 32 bytes of it
// (k16 or k32), and the s32 fragment has the f32 one's layout, so the ring,
// the descriptors, the schedules and the epilogue's addressing are shared.
//
// What bounds it: at the port's shapes (M = B*L of 8192..29632, N and K of
// 256..4096) a bf16 product does ~500 FLOP per byte of its operands and
// output, above the H100's ~295 FLOP/byte ridge, and an int8 one ~400-850
// ops per byte against a ~590 ridge (1979 TOPS), so the tensor cores bound
// most products and the design is about keeping wgmma fed and its epilogue
// out of the way.
// - One block per SM walks the 128 x BN output tiles (split over K into
//   `splits` ranges for the small weight-gradient outputs) in a grouped
//   order: kGroupM tiles down M share each column of B tiles, so B stays in
//   L2.
// - 384 threads: warpgroup 0 is the producer (setmaxnreg.dec to 40; one
//   thread issues the loads), warpgroups 1 and 2 the consumers
//   (setmaxnreg.inc to 232) with their accumulators in registers.
// - A stage holds 128 rows of A and BN rows of B (K-major) of 128 bytes
//   each, loaded as 128-byte-swizzled TMA boxes (one box a K-major operand,
//   two 64 x 64 boxes an MN-major bf16 one): 32 KB at BN = 128, six stages;
//   48 KB at BN = 256, four; 192 KB either way. The producer runs up to a
//   ring ahead, into the next tile while the consumers run this one's
//   epilogue.
// - A consumer issues a k-block's four 32-byte k-steps, commits them, waits
//   for the previous k-block's group (wgmma.wait_group 1) and releases that
//   stage on its empty barrier.
// - Two schedules. Pingpong (BN = 128 only): the consumers take the block's
//   tiles in turn, each a whole tile (two m64 halves, 128 accumulators a
//   thread), so one warpgroup's epilogue overlaps the other's products.
//   Cooperative: both work on every tile, 64 rows each; it takes a second
//   product into a second accumulator (the MLP backward's dual kernel), an
//   epilogue longer than the products (tanh-GELU), which two warpgroups then
//   share, and the 128 x 256 tile (128 accumulators a thread).
// - The epilogues run on the accumulators in registers and store whole
//   32-byte sectors (16 bytes a lane for bf16, transpose_quad; the
//   fragment's own 8-byte pairs for f32): the fragment's 4-byte bf16 stores,
//   half a sector a row, measured ~2x slower end to end on the K = 1024
//   products.
//
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda)
// and passed by value as a __grid_constant__ parameter, which a CUDA graph
// captures with the launch. Ragged M, N and K come from TMA's zero fill on
// load (a partial box reads zeros past the tensor's end) and masked stores
// in the epilogues; every base address and row pitch must be 16-byte
// aligned, which the wrappers check.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time

#include <algorithm>

#include "common.cuh"

namespace ovt {
namespace hopper {

constexpr int BM = 128;
constexpr int kRowBytes = 128;               // a stage row: one 128-byte swizzle span of K
constexpr int kChunkBytes = 64 * kRowBytes;  // 64 rows: one consumer's A rows, or one
                                             // 64 x 64 MN-major bf16 box
constexpr int kRingBytes = 192 * 1024;
constexpr int kThreads = 384;
constexpr int kGroupM = 8;

// The two operand types.
struct Bf16 {
  using Acc = float;
  static constexpr int kBytes = 2;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
struct S8 {
  using Acc = int;
  static constexpr int kBytes = 1;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// A tile configuration: the operand type and the tile's width BN.
template <class T, int kBN = 128>
struct Cfg {
  static_assert(kBN == 128 || (kBN == 256 && T::kBytes == 1),
                "a 128 x 256 tile is taken by the int8 products only");
  using Op = T;
  using Acc = typename T::Acc;
  static constexpr int BN = kBN;
  static constexpr int BK = kRowBytes / T::kBytes;  // K a stage: 64 bf16 or 128 int8
  static constexpr int kSteps = 4;                  // k16 or k32 steps of 32 bytes a row
  static constexpr int kAcc = BN / 2;               // accumulators a thread per 64-row half
  static constexpr int kABytes = BM * kRowBytes, kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;  // 6 at BN = 128, 4 at 256
  static constexpr int kScratchBytes = 2 * 4 * BN * 4;      // one f32 row of BN per consumer warp
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kScratchBytes;  // + alignment
};
using Bf16Cfg = Cfg<Bf16>;
constexpr int BN = Bf16Cfg::BN, BK = Bf16Cfg::BK;  // the bf16 family's tile

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// A 2D box of the tensor map at coordinates (c0 along the contiguous dim,
// c1 along the rows) into shared memory; completes `bytes` on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (bytes; stored in 16-byte units).
// K-major: the stride offset steps 8 rows (1024 bytes), the leading one is
// unused. MN-major: the leading offset steps to the next 64 elements of the
// rows' dimension (the next box), the stride offset 8 rows of K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) | (static_cast<uint64_t>(stride >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products (they are written until wgmma.wait_group).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (64 x 128 f32, this warpgroup's fragment) = A(64 x 16) B(16 x 128) + (scale_d ? d : 0).
// Fragment: warp w of the warpgroup holds rows 16w + lane / 4 (d[4j], d[4j+1])
// and 16w + lane / 4 + 8 (d[4j+2], d[4j+3]), columns 8j + 2 (lane % 4) + {0, 1}.
template <bool kTransA, bool kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(int(kTransA)), "n"(int(kTransB)));
}

// The s8 products: d (64 x BN s32) = A(64 x 32) B(32 x BN) + (scale_d ? d : 0),
// both operands K-major (the integer forms take no scale or transpose
// immediates). The fragment is the f32 one's: d[4j..4j+3] hold columns
// 8j + 2 (lane % 4) + {0, 1} of rows 16w + lane / 4 and + 8.
#define OVT_ACC4(i) "+r"(d[i]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3])
#define OVT_ACC16(i) OVT_ACC4(i), OVT_ACC4((i) + 4), OVT_ACC4((i) + 8), OVT_ACC4((i) + 12)
#define OVT_ACC64(i) OVT_ACC16(i), OVT_ACC16((i) + 16), OVT_ACC16((i) + 32), OVT_ACC16((i) + 48)

__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : OVT_ACC64(0)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_m64n256k32(int (&d)[128], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, "
      "%73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "
      "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
      "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : OVT_ACC64(0), OVT_ACC64(64)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef OVT_ACC64
#undef OVT_ACC16
#undef OVT_ACC4

// One k-step of the configuration's product into d (one 64-row half).
template <class C, bool kTransA, bool kTransB>
__device__ __forceinline__ void mma_step(typename C::Acc (&d)[C::kAcc], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (C::Op::kBytes == 1) {
    static_assert(!kTransA && !kTransB, "s8 wgmma has no transpose: both operands K-major");
    if constexpr (C::BN == 256)
      wgmma_s8_m64n256k32(d, da, db, scale_d);
    else
      wgmma_s8_m64n128k32(d, da, db, scale_d);
  } else {
    wgmma_m64n128k16<kTransA, kTransB>(d, da, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Barrier `id` (1..15) over the `count` threads of one warpgroup.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// The accumulator fragment holds, per lane, column pairs 8j + 2 (lane % 4):
// a row's 16 bytes of bf16 over four lanes, half a 32-byte sector, for each
// chunk j. For whole-sector stores the four lanes of a row transpose the
// packed pairs of four chunks 4g..4g+3: w[c] (lane q) = columns 8 (4g + c)
// + 2q, +1 becomes w[i] = columns 8 (4g + q) + 2i, +1, so lane q holds the
// eight consecutive columns of chunk 4g + q and stores them as 16 bytes.
__device__ __forceinline__ void transpose_quad(uint32_t (&w)[4], int q) {
  // 2 x 2 blocks first (lanes q, q ^ 1), then the blocks (lanes q, q ^ 2)
  uint32_t s0 = (q & 1) ? w[0] : w[1], s1 = (q & 1) ? w[2] : w[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (q & 1) {
    w[0] = s0;
    w[2] = s1;
  } else {
    w[1] = s0;
    w[3] = s1;
  }
  s0 = (q & 2) ? w[0] : w[2];
  s1 = (q & 2) ? w[1] : w[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (q & 2) {
    w[0] = s0;
    w[1] = s1;
  } else {
    w[2] = s0;
    w[3] = s1;
  }
}

// ---------------------------------------------------------------------------
// Work decomposition
// ---------------------------------------------------------------------------

struct Tiles {
  int m, n, k;                            // C is m x n, summed over k
  int tiles_m, tiles_n, splits, k_split;  // k_split: k per split, a multiple of BK

  __host__ __device__ int count() const { return tiles_m * tiles_n * splits; }

  // Work item w -> (M tile, N tile, split), kGroupM M tiles per group.
  __device__ void decode(int w, int& mt, int& nt, int& z) const {
    const int per = tiles_m * tiles_n;
    z = w / per;
    const int t = w - z * per;
    const int group = kGroupM * tiles_n;
    const int first = (t / group) * kGroupM;
    const int rows = min(tiles_m - first, kGroupM);
    mt = first + (t % group) % rows;
    nt = (t % group) / rows;
  }

  // Stages of kBK (the configuration's BK) in split z.
  template <int kBK>
  __device__ int k_blocks(int z) const {
    const int kb = z * k_split, ke = min(k, kb + k_split);
    return ke > kb ? (ke - kb + kBK - 1) / kBK : 0;
  }
};

template <class C = Bf16Cfg>
inline Tiles make_tiles(int m, int n, int k, int splits = 1, int k_split = 0) {
  return Tiles{m, n, k, (m + BM - 1) / BM, (n + C::BN - 1) / C::BN, splits,
               splits > 1 ? k_split : k};
}

// Tensor maps of the (up to) two products: a[p], b[p].
struct Maps {
  CUtensorMap a[2], b[2];
};

// What an epilogue is told about its tile: the tile, which 64-row half of
// it the accumulators hold, the consumer warpgroup that holds them (0 or
// 1), its warp and lane, its thread in the warpgroup, and 4 x BN floats of
// that warpgroup's shared scratch.
struct TileCtx {
  int mt, nt, z, half, wg, warp, lane, tid;
  float* scratch;
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <class C, bool kMnA, bool kMnB>
__device__ __forceinline__ void load_product(const CUtensorMap* ma, const CUtensorMap* mb,
                                             uint8_t* smem, uint64_t* full, uint64_t* empty,
                                             int m0, int n0, int kb, int nk, int& stage,
                                             uint32_t& phase) {
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&empty[stage], phase ^ 1);
    uint8_t* a = smem + stage * C::kStageBytes;
    uint8_t* b = a + C::kABytes;
    uint64_t* bar = &full[stage];
    mbar_expect_tx(bar, C::kStageBytes);
    const int k = kb + kt * C::BK;
    if (kMnA) {
      tma_load_2d(a, ma, bar, m0, k);
      tma_load_2d(a + kChunkBytes, ma, bar, m0 + 64, k);
    } else {
      tma_load_2d(a, ma, bar, k, m0);
    }
    if (kMnB) {
      tma_load_2d(b, mb, bar, n0, k);
      tma_load_2d(b + kChunkBytes, mb, bar, n0 + 64, k);
    } else {
      tma_load_2d(b, mb, bar, k, n0);
    }
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <class C>
__device__ __forceinline__ void skip_stages(int count, int& stage, uint32_t& phase) {
  const int s = stage + count;
  phase ^= (s / C::kStages) & 1;
  stage = s % C::kStages;
}

// One product's k-blocks into `acc`: kHalves 64-row halves of the tile's A,
// from half `first` on (the pingpong schedule takes both halves, the
// cooperative one its warpgroup's). `prev` is the stage whose products may
// still be running, released once the next group has been issued.
template <class C, int kHalves, bool kMnA, bool kMnB>
__device__ __forceinline__ void mma_product(typename C::Acc (&acc)[kHalves][C::kAcc], int first,
                                            uint32_t smem, uint64_t* full, uint64_t* empty,
                                            int lane, int nk, int& stage, uint32_t& phase,
                                            int& prev) {
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&full[stage], phase);
    // a 64-row half of A: the second half of a K-major tile and the second
    // 64 x 64 box of an MN-major one both start 8 KB in
    const uint32_t a = smem + stage * C::kStageBytes + first * kChunkBytes;
    const uint32_t b = smem + stage * C::kStageBytes + C::kABytes;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) fence_acc(acc[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      // 32-byte steps along a K-major row; 16 rows (2 KB) of an MN-major box
      const uint64_t db = kMnB ? desc_sw128(b + kk * 2048, kChunkBytes, 1024)
                               : desc_sw128(b + kk * 32, 16, 1024);
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const uint32_t ah = a + h * kChunkBytes;
        const uint64_t da = kMnA ? desc_sw128(ah + kk * 2048, kChunkBytes, 1024)
                                 : desc_sw128(ah + kk * 32, 16, 1024);
        mma_step<C, kMnA, kMnB>(acc[h], da, db, (kt > 0 || kk > 0) ? 1 : 0);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) fence_acc(acc[h]);
    wgmma_wait<1>();
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Ends a tile's products: waits for the last group and releases its stage.
template <int kHalves, class Acc, int N>
__device__ __forceinline__ void finish_products(Acc (&acc)[kHalves][N], uint64_t* empty, int lane,
                                                int prev) {
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < kHalves; ++h) fence_acc(acc[h]);
  if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
}

// Named barriers 3 and 4 order the pingpong consumers' mainloops: warpgroup
// c waits on 3 + c before its tile, the other arrives on it after issuing
// the previous tile's products. 1 and 2 are the epilogues' (one a
// consumer warpgroup).
constexpr int kOrderBarrier = 3;

// kPingpong: the consumers take this block's tiles in turn, each a whole
// 128-row tile; the order barrier keeps their mainloops in tile order, which
// also keeps every full-barrier wait on the barrier's current phase (a
// waiter may not run a whole ring ahead of the other warpgroup). Else the
// cooperative schedule: both warpgroups work on every tile, 64 rows each,
// with kProducts products into kProducts accumulators.
template <class C, int kProducts, bool kPingpong, bool kMnA0, bool kMnB0, bool kMnA1, bool kMnB1,
          class Epilogue>
__global__ void __launch_bounds__(kThreads, 1)
gemm_ws_kernel(const __grid_constant__ Maps maps, const Tiles tiles, const Epilogue epi) {
  static_assert(kProducts == 1 || !kPingpong, "two products run the cooperative schedule");
  static_assert(!kPingpong || C::BN == 128, "a pingpong consumer holds a whole 128 x 128 tile");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::kStages];
  __shared__ __align__(8) uint64_t empty[C::kStages];

  // the swizzled boxes want 1024-byte-aligned stages
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);                   // the producer's arrive, plus the bytes
      mbar_init(&empty[s], kPingpong ? 4 : 8);  // one arrive per consuming warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load
    setmaxnreg_dec<40>();
    if (tid == 0) {
      tma_prefetch_map(&maps.a[0]);
      tma_prefetch_map(&maps.b[0]);
      if (kProducts == 2) {
        tma_prefetch_map(&maps.a[1]);
        tma_prefetch_map(&maps.b[1]);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int w = blockIdx.x; w < tiles.count(); w += gridDim.x) {
        int mt, nt, z;
        tiles.decode(w, mt, nt, z);
        const int nk = tiles.template k_blocks<C::BK>(z), kb = z * tiles.k_split;
        load_product<C, kMnA0, kMnB0>(&maps.a[0], &maps.b[0], smem, full, empty, mt * BM,
                                      nt * C::BN, kb, nk, stage, phase);
        if constexpr (kProducts == 2)
          load_product<C, kMnA1, kMnB1>(&maps.a[1], &maps.b[1], smem, full, empty, mt * BM,
                                        nt * C::BN, kb, nk, stage, phase);
      }
    }
  } else {  // consumers
    setmaxnreg_inc<232>();
    const int c = wg - 1, warp = tid / 32, lane = tid % 32;
    float* scratch =
        reinterpret_cast<float*>(smem + C::kStages * C::kStageBytes) + c * 4 * C::BN;
    // pingpong: acc[0][h] is half h of the tile; cooperative: acc[p][0] is
    // product p on this warpgroup's half
    typename C::Acc acc[kPingpong ? 1 : kProducts][kPingpong ? 2 : 1][C::kAcc];
    int stage = 0;
    uint32_t phase = 0;
    int j = 0;  // this block's work items so far
    for (int w = blockIdx.x; w < tiles.count(); w += gridDim.x, ++j) {
      int mt, nt, z;
      tiles.decode(w, mt, nt, z);
      const int nk = tiles.template k_blocks<C::BK>(z);
      int prev = -1;
      if constexpr (kPingpong) {
        if ((j & 1) != c) {  // the other warpgroup's tile
          skip_stages<C>(nk, stage, phase);
          continue;
        }
        if (j > 0) named_barrier(kOrderBarrier + c, 256);
        mma_product<C, 2, kMnA0, kMnB0>(acc[0], 0, base, full, empty, lane, nk, stage, phase,
                                        prev);
        if (w + gridDim.x < tiles.count())
          asm volatile("bar.arrive %0, 256;\n" :: "r"(kOrderBarrier + (c ^ 1)) : "memory");
        finish_products<2>(acc[0], empty, lane, prev);
        epi(acc[0][0], TileCtx{mt, nt, z, 0, c, warp, lane, tid, scratch});
        epi(acc[0][1], TileCtx{mt, nt, z, 1, c, warp, lane, tid, scratch});
      } else {
        mma_product<C, 1, kMnA0, kMnB0>(acc[0], c, base, full, empty, lane, nk, stage, phase,
                                        prev);
        if constexpr (kProducts == 2) {
          mma_product<C, 1, kMnA1, kMnB1>(acc[1], c, base, full, empty, lane, nk, stage, phase,
                                          prev);
          finish_products<1>(acc[0], empty, lane, -1);
          finish_products<1>(acc[1], empty, lane, prev);
          epi(acc[0][0], acc[1][0], TileCtx{mt, nt, z, c, c, warp, lane, tid, scratch});
        } else {
          finish_products<1>(acc[0], empty, lane, prev);
          epi(acc[0][0], TileCtx{mt, nt, z, c, c, warp, lane, tid, scratch});
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: internal linkage, so each library (and each source) keeps its
// own cached driver entry point, SM count and per-kernel attribute
// ---------------------------------------------------------------------------

namespace {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc != cudaSuccess || q != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// cuTensorMapEncodeTiled needs a context current on the calling thread. The
// runtime makes its primary context current at a thread's first call that
// needs one, and the map may come first: autograd runs a backward on a
// thread of its own, whose first CUDA call may be this wrapper's. Setting
// the current device again makes its primary context current; once done, a
// thread keeps a current context (the runtime switches it with the device).
inline bool bind_context() {
  thread_local bool bound = false;
  if (!bound) {
    int dev = 0;
    bound = cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess;
  }
  return bound;
}

// A (rows, cols) row-major matrix of T, boxes of `box_cols` columns (128
// bytes, swizzled) by `box_rows` rows. False if cuTensorMapEncodeTiled
// refuses it.
template <class T>
inline bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_cols,
                     int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || !bind_context()) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * T::kBytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, T::kMapType, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The operand map of a K-major (rows, k) operand, read in boxes of
// `box_rows` rows (BM for A, BN for B), or of an MN-major (k, rows) one.
template <class C = Bf16Cfg>
inline bool operand_map(CUtensorMap* map, const void* ptr, bool mn_major, int rows, int k,
                        int box_rows = BM) {
  using T = typename C::Op;
  return mn_major ? make_map<T>(map, ptr, k, rows, 64, 64)
                  : make_map<T>(map, ptr, rows, k, C::BK, box_rows);
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 132;
  }();
  return n;
}

// Launches one persistent block per SM (at most one per work item).
template <class C, int kProducts, bool kPingpong, bool kMnA0, bool kMnB0, bool kMnA1, bool kMnB1,
          class Epilogue>
int launch(const Maps& maps, const Tiles& tiles, const Epilogue& epi, cudaStream_t stream) {
  auto kernel = gemm_ws_kernel<C, kProducts, kPingpong, kMnA0, kMnB0, kMnA1, kMnB1, Epilogue>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int work = tiles.count();
  if (work == 0) return 0;
  kernel<<<std::min(work, sm_count()), kThreads, C::kSmemBytes, stream>>>(maps, tiles, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace hopper
}  // namespace ovt
