// Batched bf16 GEMM for Hopper: TMA ring + wgmma, shared by matmul.cu and
// precond.cu beside the WMMA core (gemm.cuh).
//
// C[b] = A[b] (M, K) @ B[b] (K, N), both row-major, bf16 or (one of them)
// int8 codes with a per-slice fp32 scale, fp32 accumulation.
//
// Replaces, with gemm.cuh, the TPU kernels src/repro/kernels/matmul.py:35
// (matmul) and src/repro/kernels/precond.py:108 (fused_precond's two
// products).
//
// What bounds the work on the H100: tensor-core operations.  At every
// bert-large shape MKOR gives it (96 x 1024^3, 24 x 1024 x 4096 x 4096,
// 24 x 4096 x 4096 x 1024) a slice does 2*M*N*K operations on
// 2*(M*K + K*N) + 4*M*N bytes, some 340-680 operations a byte against the
// card's ~295 bf16 operations a byte, so only the tensor-core rate
// matters.  The design is the one Hopper reaches that rate with:
//   * tiles arrive by TMA (3-D tensor maps (batch, rows, cols), so a ragged
//     edge zero-fills within its own slice; an operand broadcast over the
//     batch takes a 2-D map) into a ring of 128-byte-swizzled shared-memory
//     stages, tracked by full/empty mbarriers.  One producer thread issues
//     every copy; its warpgroup gives up registers with setmaxnreg;
//   * two consumer warpgroups each own 64 rows of a 128 x 256 tile (128 x
//     128 when B is a hi/lo pair) and issue wgmma.mma_async m64n256k16
//     (m64n128k16) with both operands read from shared memory by
//     descriptor: A K-major, B MN-major (row-major (K, N), the transpose
//     bit set), one k-block of 64 in flight while the next one's stage is
//     waited for;
//   * one persistent block per SM walks the (batch, m, n) tiles with n
//     fastest, so the blocks in flight share a slice's A rows and B panel
//     while they are in L2, and one tile's epilogue overlaps the next
//     tile's copies.
// Split mode carries a float32 intermediate as a bf16 pair x = hi + lo
// (hi = bf16(x), lo = bf16(x - hi)): the operand's two parts arrive by TMA
// into the same stage and each k-step runs wgmma(hi, F) and wgmma(lo, F)
// into one accumulator, sharing the other operand's tile.  That is the
// arithmetic of gemm.cuh's on-the-fly split (16 significant bits, the
// products of bf16 parts exact in fp32).
// Epilogues, staged 64 columns at a time through a swizzled buffer per
// warpgroup so that every global store is a 16-byte vector along a row:
// fp32 C, optionally writing each consumer warp's sum of squares of its part
// of a tile to its own slot of sq_parts (kSqParts slots a tile,
// tile_parts() a slice, summed later in a fixed order); or a bf16 hi/lo pair written as two (B, M, N) tensors
// (the first product of fused_precond, 4 bytes an element as fp32), or hi
// alone (a bf16 C).
//
// int8 operands (QA / QB: an int8 factor bank's codes, one fp32 scale a
// slice) are widened on chip.  TMA copies bytes and cannot widen a code,
// and wgmma has no int8 x bf16 product, so the producer thread TMA-loads a
// k-block's codes into a raw buffer of the stage (an int8 map, boxes 64
// codes wide, no swizzle) and completes a "raw full" mbarrier; the
// producer warpgroup's other three warps, idle otherwise, wait on it,
// widen each code exactly to bf16 (|code| <= 127 has 7 significant bits)
// and store the 128-byte-swizzled bf16 tile where TMA would have put it
// (16-byte unit u of row r at unit u ^ r % 8), so the consumers'
// descriptors and loop do not change.  Each widening thread then fences
// its generic-proxy stores for the async proxy (fence.proxy.async) and
// arrives on the stage's full barrier, which expects one arrival for the
// TMA transaction plus one per widening thread.  The raw buffer is freed
// with the stage.  The scale is a scalar factor of each slice's product:
// the epilogue multiplies the accumulator by scale_a[b] * scale_b[b]
// before anything else (the hi/lo split, the sum of squares, the store).
// The widening is integer and packed-bf16 arithmetic (widen4), not the
// conversion unit: three warps converting with I2F/F2F took ~2x a stage's
// tensor time for a 64 x 256 int8 B tile (PERF.md).
//
// What stays on the WMMA core, and why: float32 operands handed to matmul,
// and rows that are not a multiple of 16 bytes or bases that are not
// 16-byte aligned (TMA's rule; for int8 codes, rows of a multiple of 16
// codes).
//
// The tensor maps are encoded on the host per call, through
// cuTensorMapEncodeTiled reached with cudaGetDriverEntryPoint (no -lcuda),
// and passed to the kernel as __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mkor {
namespace wg {

constexpr int BM = 128, BK = 64;
constexpr int kConsumers = 2;                  // warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxCols = 64;                   // 128 bytes: the swizzle span
constexpr int kABytes = BM * BK * 2;           // one (128 x 64) box, 16 KB
constexpr int kBBox = BK * kBoxCols * 2;       // one (64 x 64) box, 8 KB
constexpr int kSmemLimit = 232448;             // a block's 227 KB
constexpr int kMaxStages = 6;
constexpr int kEpiBytes = 64 * 64 * 4;         // a warpgroup's staging buffer
constexpr int kWideners = 96;                  // producer warps 1-3
constexpr int kQBox = BK * kBoxCols;           // one (64 x 64) int8 box, 4 KB

// Tile width: 256 where B is one tensor (measured 1.2-1.3x faster than 128
// at the bert-large products), 128 where B is a hi/lo pair, and where A is
// a pair and B int8 codes (two 256-wide B parts, or a pair beside 16 KB of
// raw codes, would leave room for only two stages).
__host__ __device__ constexpr int tile_n(bool sa, bool sb, bool qb) {
  return (sb || (sa && qb)) ? 128 : 256;
}
constexpr int kSqParts = kConsumers * 4;       // sum-of-squares slots a tile

// Sum-of-squares slots a slice of an (m, n) C takes on the tile
// tile_n(sa, sb, qb) picks.
inline long long tile_parts(int m, int n, bool sa, bool sb, bool qb) {
  const int bn = tile_n(sa, sb, qb);
  return (long long)((m + BM - 1) / BM) * ((n + bn - 1) / bn) * kSqParts;
}

template <bool SA, bool SB, int BN, bool QA, bool QB>
struct Ring {
  static constexpr int A_PARTS = SA ? 2 : 1;
  static constexpr int B_PARTS = SB ? 2 : 1;
  static constexpr int B_BYTES = BK * BN * 2;    // BN / 64 boxes
  // the raw int8 codes of a QA / QB operand follow the bf16 tiles
  static constexpr int RAW = kABytes * A_PARTS + B_BYTES * B_PARTS;
  static constexpr int Q_BYTES = QA ? BM * BK : (QB ? BK * BN : 0);
  static constexpr int STAGE = RAW + Q_BYTES;
  // the bytes TMA writes into the bf16 tiles (a widened tile is stored by
  // the widening warps instead)
  static constexpr int TMA_BYTES =
      RAW - (QA ? kABytes : 0) - (QB ? B_BYTES : 0);
  static constexpr int EPI = kConsumers * kEpiBytes;
  // a full and an empty mbarrier a stage, and a raw-full one for codes
  static constexpr int BARS = (QA || QB) ? 24 : 16;
  static constexpr int FIT =
      (kSmemLimit - 1024 - EPI - BARS * kMaxStages) / STAGE;
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  // 1024 bytes of slack to align the ring to the swizzle atom, then the
  // stages, the epilogue's staging buffers, and the mbarriers
  static constexpr int BYTES = 1024 + STAGES * STAGE + EPI + BARS * STAGES;
  static_assert(STAGES >= 2, "the ring needs two stages");
};

struct Params {
  CUtensorMap a, a_lo, b, b_lo;  // the lo maps are read in split mode only;
                                 // a / b map int8 codes for QA / QB
  void* c;                       // fp32 C, or the bf16 hi part
  void* c_lo;                    // bf16 lo part, or null
  float* sq_parts;               // per-warp sums of squares of C, or null
  const float* scale_a;          // (batch,) scales of int8 A / B codes
  const float* scale_b;
  int m, n, k, batch;
  int a_3d, b_3d;                // 0: 2-D map, broadcast over the batch
  int tiles_m, tiles_n;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of `map` at (c0 cols, c1 rows[, c2 batch]) into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int three_d) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (three_d)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(dst), "l"(m), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(dst), "l"(m), "r"(bar), "r"(c0), "r"(c1) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A (BM x BK) K-major: rows of 128 bytes, 8-row swizzle atoms 1024 bytes
// apart (SBO); K advances inside the 128-byte row by moving the start
// address (LBO unused for swizzled K-major layouts).
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 32, 16, 1024);
}

// B (BK x BN) MN-major: 64-column boxes kBBox apart (LBO), 8 k-rows of 128
// bytes a swizzle atom, atoms 1024 bytes apart (SBO); k16 = 2048 bytes.
__device__ __forceinline__ uint64_t desc_b(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, kBBox, 1024);
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

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The four int8 codes of w as two bf16 pairs, exactly, without the
// conversion unit (a quarter-rate pipe, and the first design's bottleneck:
// one I2F a code and one F2F a pair kept the int8-B products at ~2.4x the
// bf16 time).  A code x with low bits l = x & 0x7f and sign bit s is
// (128 + l) - (128 + 128 s); both terms are bf16 bit patterns built by byte
// permutes -- high byte 0x43 (2^7), low byte l, or 0x00 / 0x80 for 128 /
// 256 -- and one packed bf16 subtraction a pair gives x exactly (every
// term and the result are integers of at most 8 significant bits).
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t low = w & 0x7f7f7f7fu, sign = w & 0x80808080u;
  uint2 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // bytes {code 2h, 0x43, code 2h + 1, 0x43}
    const uint32_t sel = h ? 0x4342u : 0x4140u;
    const uint32_t a = __byte_perm(low, 0x43434343u, sel);
    const uint32_t b = __byte_perm(sign, 0x43434343u, sel);
    o[h] = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  }
  return out;
}

// A stage's int8 codes (raw: (rows x 64) boxes of 64-byte rows) into the
// bf16 tile at dst ((rows x 64) boxes of 128-byte rows, TMA's 128-byte
// swizzle: 16-byte unit u of row r stored at unit u ^ r % 8).  Chunk c is
// 8 codes, raw bytes 8c.., bf16 row c / 8, unit c % 8.  Widening thread t
// takes chunks t, t + 96, ...: always unit u = t % 8, rows t / 8 + 12 i,
// and 12 i moves row % 8 by 4 i, so the swizzled unit alternates between
// two values and the addresses advance by constants.
static_assert(kWideners % 8 == 0, "a widening thread keeps its unit");
template <int CHUNKS>
__device__ __forceinline__ void widen_stage(uint32_t raw, uint32_t dst,
                                            int t) {
  const int r0 = t >> 3;
  const uint32_t swz = ((t & 7) ^ (r0 & 7)) << 4;
  raw += 8 * t;
  dst += r0 * 128;
#pragma unroll 2
  for (int i = 0; t + i * kWideners < CHUNKS; ++i) {
    const uint2 w = lds64(raw + i * 8 * kWideners);
    const uint2 lo = widen4(w.x), hi = widen4(w.y);
    sts128(dst + i * (kWideners / 8) * 128 + (swz ^ ((i & 1) << 6)),
           make_uint4(lo.x, lo.y, hi.x, hi.y));
  }
}

// Barrier of one consumer warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void epi_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// Keep the compiler from moving accumulator reads across the asynchronous
// wgmma that writes them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A (64 x 16, K-major) @ B (16 x BN, MN-major), fp32 accumulators
// (BN / 2 a thread).
__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39,\n"
      " %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55,\n"
      " %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, 1, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_tile(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39,\n"
      " %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55,\n"
      " %56, %57, %58, %59, %60, %61, %62, %63,\n"
      " %64, %65, %66, %67, %68, %69, %70, %71,\n"
      " %72, %73, %74, %75, %76, %77, %78, %79,\n"
      " %80, %81, %82, %83, %84, %85, %86, %87,\n"
      " %88, %89, %90, %91, %92, %93, %94, %95,\n"
      " %96, %97, %98, %99, %100, %101, %102, %103,\n"
      " %104, %105, %106, %107, %108, %109, %110, %111,\n"
      " %112, %113, %114, %115, %116, %117, %118, %119,\n"
      " %120, %121, %122, %123, %124, %125, %126, %127},\n"
      " %128, %129, 1, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db));
}

// SA / SB: A / B arrives as a bf16 hi/lo pair (split mode).  HILO: write C
// as bf16 hi (and lo when c_lo is set) instead of fp32.  QA / QB: A / B
// arrives as int8 codes, widened on chip, with scale_a / scale_b.
template <bool SA, bool SB, bool HILO, bool QA, bool QB>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_gemm_kernel(__grid_constant__ const Params p) {
  constexpr bool Q = QA || QB;
  constexpr int BN = tile_n(SA, SB, QB);
  using R = Ring<SA, SB, BN, QA, QB>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + R::STAGES * R::STAGE + kConsumers * kEpiBytes;
  auto full = [&](uint32_t s) { return bars + 8 * s; };
  auto empty = [&](uint32_t s) { return bars + 8 * (R::STAGES + s); };
  auto raw_full = [&](uint32_t s) { return bars + 8 * (2 * R::STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      // the producer's expect_tx, and each widening thread's arrive
      mbar_init(full(s), Q ? 1 + kWideners : 1);
      mbar_init(empty(s), kConsumers * 4);    // one arrive per consumer warp
      if (Q) mbar_init(raw_full(s), 1);       // the codes' expect_tx
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int per_slice = p.tiles_m * p.tiles_n;
  const int total = per_slice * p.batch;
  const int k_blocks = (p.k + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ---------------- producer: one thread issues every copy -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = threadIdx.x - kConsumers * 128;
    if (pt == 0) {
      uint32_t it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int b = t / per_slice, r = t % per_slice;
        const int m0 = (r / p.tiles_n) * BM, n0 = (r % p.tiles_n) * BN;
        for (int kb = 0; kb < k_blocks; ++kb, ++it) {
          const uint32_t s = it % R::STAGES;
          mbar_wait(empty(s), ((it / R::STAGES) & 1) ^ 1);
          const uint32_t stage = base + s * R::STAGE;
          const uint32_t bar = full(s);
          const int k0 = kb * BK;
          if constexpr (Q) {           // the codes first: widening waits
            const uint32_t rb = raw_full(s), raw = stage + R::RAW;
            mbar_expect_tx(rb, R::Q_BYTES);
            if constexpr (QA) {
              tma_load(raw, &p.a, rb, k0, m0, b, p.a_3d);
            } else {
#pragma unroll
              for (int j = 0; j < BN / kBoxCols; ++j)
                tma_load(raw + j * kQBox, &p.b, rb, n0 + j * kBoxCols, k0, b,
                         p.b_3d);
            }
          }
          mbar_expect_tx(bar, R::TMA_BYTES);
          if constexpr (!QA) {
            tma_load(stage, &p.a, bar, k0, m0, b, p.a_3d);
            if (SA)
              tma_load(stage + kABytes, &p.a_lo, bar, k0, m0, b, p.a_3d);
          }
          const uint32_t bt = stage + kABytes * R::A_PARTS;
          if constexpr (!QB) {
#pragma unroll
            for (int j = 0; j < BN / kBoxCols; ++j) {
              tma_load(bt + j * kBBox, &p.b, bar, n0 + j * kBoxCols, k0, b,
                       p.b_3d);
              if (SB)
                tma_load(bt + R::B_BYTES + j * kBBox, &p.b_lo, bar,
                         n0 + j * kBoxCols, k0, b, p.b_3d);
            }
          }
        }
      }
    } else if constexpr (Q) {
      // ------------- widening warps: int8 codes -> swizzled bf16 --------
      if (pt >= 32) {
        uint32_t it = 0;
        for (int t = blockIdx.x; t < total; t += gridDim.x) {
          for (int kb = 0; kb < k_blocks; ++kb, ++it) {
            const uint32_t s = it % R::STAGES;
            mbar_wait(raw_full(s), (it / R::STAGES) & 1);
            const uint32_t stage = base + s * R::STAGE;
            widen_stage<R::Q_BYTES / 8>(
                stage + R::RAW, QA ? stage : stage + kABytes * R::A_PARTS,
                pt - 32);
            // make the generic-proxy stores visible to wgmma's async
            // proxy, then count this thread in the stage's full barrier
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(full(s));
          }
        }
      }
    }
  } else {
    // ---------------- consumers: 64 rows of the tile each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    unsigned char* ebuf = smem_raw + (base - smem_u32(smem_raw)) +
                          R::STAGES * R::STAGE + wg * kEpiBytes;
    float acc[BN / 2];
    uint32_t it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const int b = t / per_slice, r = t % per_slice;
      const int m0 = (r / p.tiles_n) * BM, n0 = (r % p.tiles_n) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      uint32_t prev = 0;
      for (int kb = 0; kb < k_blocks; ++kb, ++it) {
        const uint32_t s = it % R::STAGES;
        mbar_wait(full(s), (it / R::STAGES) & 1);
        const uint32_t stage = base + s * R::STAGE;
        const uint32_t at = stage + wg * (64 * BK * 2);
        const uint32_t bt = stage + kABytes * R::A_PARTS;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = desc_a(at, kk), db = desc_b(bt, kk);
          wgmma_tile(acc, da, db);
          if (SA) wgmma_tile(acc, desc_a(at + kABytes, kk), db);
          if (SB) wgmma_tile(acc, da, desc_b(bt + R::B_BYTES, kk));
        }
        wgmma_commit();
        // the previous k-block's products are done: release its stage
        wgmma_wait<1>();
        if (kb > 0 && lane == 0) mbar_arrive(empty(prev));
        prev = s;
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty(prev));
      fence_acc(acc);

      // Epilogue, 64 columns at a time through this warpgroup's staging
      // buffer, so that global stores are whole 16-byte vectors along rows.
      // Accumulator i of a thread holds row warp*16 + lane/4 (+8 for
      // i%4 >= 2), column (i/4)*8 + (lane%4)*2 (+1 for odd i) of this
      // warpgroup's 64 x BN block.  The buffer's 16-byte units are swizzled
      // by row (unit ^ row%8) so neither side has bank conflicts.
      const int q = lane % 4, tid = threadIdx.x % 128;
      const int rows_left = p.m - (m0 + wg * 64);
      const long long slice = (long long)b * p.m * p.n;
      // the int8 operands' scales, a factor of the whole slice's product:
      // applied first, so the hi/lo pair, the sum of squares and the
      // stored C are all of the scaled product
      float sc = 1.0f;
      if constexpr (QA) sc *= p.scale_a[b];
      if constexpr (QB) sc *= p.scale_b[b];
      float sq = 0.0f;
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) {
        const int cols_left = p.n - (n0 + c * 64);
        epi_sync(wg);                  // the last chunk's reads are done
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = warp * 16 + lane / 4 + h * 8;
            const int i = 4 * (c * 8 + jj) + 2 * h;
            float v0 = acc[i], v1 = acc[i + 1];
            if constexpr (QA || QB) {
              v0 *= sc;
              v1 *= sc;
            }
            sq += v0 * v0 + v1 * v1;   // zero outside C: TMA zero-fills
            if constexpr (HILO) {
              const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
              const int off = row * 128 + ((jj ^ (row & 7)) << 4) + q * 4;
              *reinterpret_cast<__nv_bfloat162*>(ebuf + off) = hi;
              const float2 hf = __bfloat1622float2(hi);
              *reinterpret_cast<__nv_bfloat162*>(ebuf + kEpiBytes / 2 + off) =
                  __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
            } else {
              const int unit = (2 * jj + q / 2) ^ (row & 7);
              *reinterpret_cast<float2*>(ebuf + row * 256 + unit * 16 +
                                         (q & 1) * 8) = make_float2(v0, v1);
            }
          }
        }
        epi_sync(wg);                  // the chunk is staged
        if constexpr (HILO) {          // 64 rows x 8 units, hi then lo
#pragma unroll
          for (int pass = 0; pass < 4; ++pass) {
            const int idx = pass * 128 + tid, row = idx / 8, unit = idx % 8;
            if (row < rows_left && unit * 8 < cols_left) {
              const int off = row * 128 + ((unit ^ (row & 7)) << 4);
              const long long g = slice + (long long)(m0 + wg * 64 + row) *
                                  p.n + n0 + c * 64 + unit * 8;
              *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.c) +
                                        g) =
                  *reinterpret_cast<const uint4*>(ebuf + off);
              if (p.c_lo != nullptr)
                *reinterpret_cast<uint4*>(
                    static_cast<__nv_bfloat16*>(p.c_lo) + g) =
                    *reinterpret_cast<const uint4*>(ebuf + kEpiBytes / 2 +
                                                    off);
            }
          }
        } else {                       // 64 rows x 16 units of fp32
#pragma unroll
          for (int pass = 0; pass < 8; ++pass) {
            const int idx = pass * 128 + tid, row = idx / 16, unit = idx % 16;
            if (row < rows_left && unit * 4 < cols_left) {
              const int off = row * 256 + ((unit ^ (row & 7)) << 4);
              const long long g = slice + (long long)(m0 + wg * 64 + row) *
                                  p.n + n0 + c * 64 + unit * 4;
              *reinterpret_cast<uint4*>(static_cast<float*>(p.c) + g) =
                  *reinterpret_cast<const uint4*>(ebuf + off);
            }
          }
        }
      }
      if (!HILO && p.sq_parts != nullptr) {
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          sq += __shfl_xor_sync(0xffffffffu, sq, off);
        if (lane == 0)
          p.sq_parts[((long long)b * per_slice + r) * kSqParts + wg * 4 +
                     warp] = sq;
      }
    }
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A row-major (batch, rows, cols) operand as a map of (box_rows x 64)
// boxes, zero fill outside; batch_stride 0 (broadcast) gives a 2-D map.
// Strides in elements.  bf16 boxes take the 128-byte swizzle the wgmma
// descriptors read; int8 codes (the raw boxes of a widened operand) take
// none, 64-byte rows.
inline bool encode(CUtensorMap* map, const void* ptr, int rows, int cols,
                   int batch, long long batch_stride, int box_rows,
                   bool int8 = false) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr || ptr == nullptr) return false;
  const cuuint64_t elem_bytes = int8 ? 1 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem_bytes,
                                 (cuuint64_t)batch_stride * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)kBoxCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map,
            int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            batch_stride != 0 ? 3 : 2, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One operand: its hi part (or its int8 codes), its lo part in split mode
// (else null), its batch stride in elements (0: broadcast over the batch),
// and the (batch,) fp32 scales of int8 codes (else null).
struct Operand {
  const void* hi;
  const void* lo;
  long long batch_stride;
  const float* scale;
};

template <bool SA, bool SB, bool HILO, bool QA = false, bool QB = false>
cudaError_t launch(const Operand& a, const Operand& b, void* c, void* c_lo,
                   float* sq_parts, int m, int n, int k, int batch,
                   cudaStream_t stream) {
  static_assert(!(QA && (SA || QB)) && !(QB && SB),
                "int8 codes are one tensor, in one operand");
  constexpr int BN = tile_n(SA, SB, QB);
  using R = Ring<SA, SB, BN, QA, QB>;
  Params p{};
  if ((QA && a.scale == nullptr) || (QB && b.scale == nullptr))
    return cudaErrorInvalidValue;
  if (!encode(&p.a, a.hi, m, k, batch, a.batch_stride, BM, QA) ||
      (SA && !encode(&p.a_lo, a.lo, m, k, batch, a.batch_stride, BM)) ||
      !encode(&p.b, b.hi, k, n, batch, b.batch_stride, BK, QB) ||
      (SB && !encode(&p.b_lo, b.lo, k, n, batch, b.batch_stride, BK)))
    return cudaErrorInvalidValue;
  p.c = c;
  p.c_lo = c_lo;
  p.sq_parts = sq_parts;
  p.scale_a = a.scale;
  p.scale_b = b.scale;
  p.m = m;
  p.n = n;
  p.k = k;
  p.batch = batch;
  p.a_3d = a.batch_stride != 0;
  p.b_3d = b.batch_stride != 0;
  p.tiles_m = (m + BM - 1) / BM;
  p.tiles_n = (n + BN - 1) / BN;
  const long long total = (long long)p.tiles_m * p.tiles_n * batch;
  if (total <= 0 || total > 0x7fffffffLL) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wgmma_gemm_kernel<SA, SB, HILO, QA, QB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             R::BYTES);
  if (err != cudaSuccess) return err;
  const int grid = total < sms ? (int)total : sms;
  wgmma_gemm_kernel<SA, SB, HILO, QA, QB>
      <<<grid, kThreads, R::BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace mkor
