// Batched tensor-core GEMM shared by matmul.cu and precond.cu.
//
// C[b] = A[b] (M, K) @ B[b] (K, N), row-major, fp32 accumulation, with
// batch strides (0 broadcasts an operand over the batch).  The product
// runs on the tensor cores through the WMMA API (bf16 16x16x16 fragments,
// fp32 accumulators).  A float32 operand is split on its way into shared
// memory into two bf16 parts, x = hi + lo with hi = bf16(x) and
// lo = bf16(x - hi), so a float32 input keeps 16 significant bits:
//   bf16 x bf16 -> 1 product, f32 x bf16 -> 2 (hi, lo), f32 x f32 -> 3
//   (hi*hi + hi*lo + lo*hi).
// The products of bf16 parts are exact in fp32, so the result differs
// from a float32 GEMM only by the dropped lo*lo term (about 2^-16
// relative) and the summation order.
//
// An int8 operand (the codes of MKOR's int8 factor banks) is read as
// 1-byte loads, 16 to a 16-byte vector, and enters shared memory as one
// bf16 part: |code| <= 127 is exact in bf16, so it needs no hi/lo split.
// Its per-slice scale is a scalar factor of the product, so the epilogue
// multiplies the accumulator by scale_a[b] * scale_b[b] before the store
// and before the sum of squares: no decoded copy of the operand exists.
//
// This is the WMMA core: it takes every operand type and any row width.
// Products of bf16 operands with 16-byte rows run on the Hopper core of
// wgmma_gemm.cuh instead (kernels/matmul.py:gemm_route decides); float32
// and int8 operands and ragged row widths stay here.
//
// Design, simple first: 128x128 block tile, BK = 32, 8 warps each owning
// a 64x32 sub-tile (4x2 fragments).  Two shared-memory stages with the
// next tile's global loads held in registers while the current tile is
// multiplied (no TMA, no wgmma).  Ragged M, N and K are masked at the
// tile loads (zeros) and at the stores, so callers never pad.  The optional
// epilogue writes each warp's sum of squares of its part of C to its own
// slot of sq_parts (kSqParts slots a tile, tile_parts() a slice); the
// caller sums the slots in a fixed order, so the result is the same bits on
// every run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace mkor {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM;  // 64
constexpr int kWN = kBN / kWarpsN;  // 32
constexpr int kFM = kWM / 16;       // 4 fragments down
constexpr int kFN = kWN / 16;       // 2 fragments across
constexpr int kSqParts = kThreads / 32;  // sum-of-squares slots a tile
constexpr int kALd = kBK + 8;       // padded smem leading dims (multiples
constexpr int kBLd = kBN + 8;       // of 8 elements, as WMMA requires)

template <typename T>
struct IsF32 { static constexpr bool value = false; };
template <>
struct IsF32<float> { static constexpr bool value = true; };
template <typename T>
struct IsI8 { static constexpr bool value = false; };
template <>
struct IsI8<int8_t> { static constexpr bool value = true; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

struct GemmArgs {
  const void* a;
  const void* b;
  void* c;
  int m, n, k;
  long long lda, ldb, ldc;  // row strides, elements
  long long sa, sb, sc;     // batch strides, elements (0 = broadcast)
  int vec_a, vec_b;         // 16-byte aligned rows: vector tile loads
  float* sq_parts;          // optional per-warp sums of squares of C
  const float* scale_a;     // per-batch scale of an int8 A, else null
  const float* scale_b;     // per-batch scale of an int8 B, else null
};

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}
template <>
__device__ __forceinline__ int8_t zero_value<int8_t>() { return 0; }

// One (ROWS x COLS) tile of a row-major matrix, moved in two halves so the
// global loads of tile k+1 are in flight while the tensor cores work on
// tile k: fetch() reads 16-byte chunks into registers (masking the ragged
// edge with zeros), commit() converts them to bf16 (hi, and lo for a
// float32 source; int8 codes convert exactly) and stores them to shared
// memory.
template <typename T, int ROWS, int COLS>
struct TileLoader {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CHUNKS = ROWS * COLS / VEC;
  static constexpr int PER_THREAD = CHUNKS / kThreads;
  static_assert(CHUNKS % kThreads == 0, "tile must split evenly");
  uint4 regs[PER_THREAD];

  __device__ __forceinline__ void fetch(const T* __restrict__ src,
                                        long long ld, int nrows, int ncols,
                                        int r0, int c0, bool vec) {
    const bool full = vec && r0 + ROWS <= nrows && c0 + COLS <= ncols;
#pragma unroll
    for (int p = 0; p < PER_THREAD; ++p) {
      const int ch = threadIdx.x + p * kThreads;
      const int r = ch / (COLS / VEC), c = (ch % (COLS / VEC)) * VEC;
      const T* row = src + (long long)(r0 + r) * ld + (c0 + c);
      if (full) {
        regs[p] = *reinterpret_cast<const uint4*>(row);
      } else {
        alignas(16) T tmp[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const bool ok = (r0 + r) < nrows && (c0 + c + i) < ncols;
          tmp[i] = ok ? row[i] : zero_value<T>();
        }
        regs[p] = *reinterpret_cast<const uint4*>(tmp);
      }
    }
  }

  template <int LD, bool SPLIT>
  __device__ __forceinline__ void commit(__nv_bfloat16* hi,
                                         __nv_bfloat16* lo) const {
#pragma unroll
    for (int p = 0; p < PER_THREAD; ++p) {
      const int ch = threadIdx.x + p * kThreads;
      const int r = ch / (COLS / VEC), c = (ch % (COLS / VEC)) * VEC;
      if constexpr (IsI8<T>::value) {       // int8 codes: exact in bf16
        const int8_t* e = reinterpret_cast<const int8_t*>(&regs[p]);
        alignas(16) __nv_bfloat16 h[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) h[i] = __float2bfloat16_rn((float)e[i]);
        uint4* dst = reinterpret_cast<uint4*>(hi + r * LD + c);
        dst[0] = reinterpret_cast<const uint4*>(h)[0];
        dst[1] = reinterpret_cast<const uint4*>(h)[1];
      } else if constexpr (!IsF32<T>::value) {  // bf16 source: copy as is
        *reinterpret_cast<uint4*>(hi + r * LD + c) = regs[p];
      } else {                              // float32: bf16 hi (+ lo)
        const float* e = reinterpret_cast<const float*>(&regs[p]);
        alignas(8) __nv_bfloat16 h[VEC];
        alignas(8) __nv_bfloat16 l[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          h[i] = __float2bfloat16_rn(e[i]);
          l[i] = __float2bfloat16_rn(e[i] - __bfloat162float(h[i]));
        }
        *reinterpret_cast<uint2*>(hi + r * LD + c) =
            *reinterpret_cast<const uint2*>(h);
        if (SPLIT)
          *reinterpret_cast<uint2*>(lo + r * LD + c) =
              *reinterpret_cast<const uint2*>(l);
      }
    }
  }
};

// Shared memory: two stages of the A and B tiles (bf16 hi, plus lo for a
// float32 operand) and a per-warp 16x16 fp32 staging tile for the
// epilogue.  Dynamic, since the split variants exceed 48 KB.
template <bool SA, bool SB>
struct SmemLayout {
  static constexpr int A_STAGE = kBM * kALd;   // bf16 elements
  static constexpr int B_STAGE = kBK * kBLd;
  static constexpr int A_ELEMS = 2 * A_STAGE * (SA ? 2 : 1);
  static constexpr int B_ELEMS = 2 * B_STAGE * (SB ? 2 : 1);
  static constexpr int BYTES = (A_ELEMS + B_ELEMS) * 2 +
                               (kThreads / 32) * 256 * 4;
};

template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads) gemm_kernel(GemmArgs p) {
  using namespace nvcuda;
  constexpr bool SA = IsF32<TA>::value;
  constexpr bool SB = IsF32<TB>::value;
  using L = SmemLayout<SA, SB>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* a_lo = a_hi + 2 * L::A_STAGE;        // used only if SA
  __nv_bfloat16* b_hi = a_hi + L::A_ELEMS;
  __nv_bfloat16* b_lo = b_hi + 2 * L::B_STAGE;        // used only if SB
  float* stage_all = reinterpret_cast<float*>(b_hi + L::B_ELEMS);

  const int batch = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const TA* A = static_cast<const TA*>(p.a) + batch * p.sa;
  const TB* B = static_cast<const TB*>(p.b) + batch * p.sb;
  TC* C = static_cast<TC*>(p.c) + batch * p.sc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  TileLoader<TA, kBM, kBK> la;
  TileLoader<TB, kBK, kBN> lb;
  const int k_tiles = (p.k + kBK - 1) / kBK;
  la.fetch(A, p.lda, p.m, p.k, m0, 0, p.vec_a);
  lb.fetch(B, p.ldb, p.k, p.n, 0, n0, p.vec_b);
  la.template commit<kALd, SA>(a_hi, a_lo);
  lb.template commit<kBLd, SB>(b_hi, b_lo);
  __syncthreads();

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) {                       // next tile's loads fly during the MMAs
      la.fetch(A, p.lda, p.m, p.k, m0, (kt + 1) * kBK, p.vec_a);
      lb.fetch(B, p.ldb, p.k, p.n, (kt + 1) * kBK, n0, p.vec_b);
    }
    const __nv_bfloat16* ah = a_hi + cur * L::A_STAGE;
    const __nv_bfloat16* al = a_lo + cur * L::A_STAGE;
    const __nv_bfloat16* bh = b_hi + cur * L::B_STAGE;
    const __nv_bfloat16* bl = b_lo + cur * L::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[kFM], fa_lo[SA ? kFM : 1];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[kFN], fb_lo[SB ? kFN : 1];
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
        const int off = (wm * kWM + i * 16) * kALd + kk;
        wmma::load_matrix_sync(fa[i], ah + off, kALd);
        if (SA) wmma::load_matrix_sync(fa_lo[SA ? i : 0], al + off, kALd);
      }
#pragma unroll
      for (int j = 0; j < kFN; ++j) {
        const int off = kk * kBLd + wn * kWN + j * 16;
        wmma::load_matrix_sync(fb[j], bh + off, kBLd);
        if (SB) wmma::load_matrix_sync(fb_lo[SB ? j : 0], bl + off, kBLd);
      }
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) {
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
          if (SB) wmma::mma_sync(acc[i][j], fa[i], fb_lo[SB ? j : 0], acc[i][j]);
          if (SA) wmma::mma_sync(acc[i][j], fa_lo[SA ? i : 0], fb[j], acc[i][j]);
        }
    }
    if (more) {
      // the other stage was last read one iteration ago, before the
      // barrier that ended it, so it is free to overwrite
      const int nxt = cur ^ 1;
      la.template commit<kALd, SA>(a_hi + nxt * L::A_STAGE,
                                   a_lo + nxt * L::A_STAGE);
      lb.template commit<kBLd, SB>(b_hi + nxt * L::B_STAGE,
                                   b_lo + nxt * L::B_STAGE);
    }
    __syncthreads();
  }

  // Epilogue: stage each fragment through shared memory, apply the int8
  // operands' scales, masked stores, optional sum of squares.
  const float cs = (p.scale_a != nullptr ? p.scale_a[batch] : 1.0f) *
                   (p.scale_b != nullptr ? p.scale_b[batch] : 1.0f);
  float sq = 0.0f;
  float* st = stage_all + warp * 256;
  const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * kWM + i * 16 + er;
      const int gc0 = n0 + wn * kWN + j * 16 + ec;
      if (gr < p.m) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (gc0 + e < p.n) {
            const float v = st[er * 16 + ec + e] * cs;
            from_f32(v, C + (long long)gr * p.ldc + gc0 + e);
            sq += v * v;
          }
        }
      }
      __syncwarp();
    }
  if (p.sq_parts != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const long long tile = ((long long)batch * gridDim.y + blockIdx.y) *
                           gridDim.x + blockIdx.x;
    if (lane == 0) p.sq_parts[tile * kSqParts + warp] = sq;
  }
}

// Sum-of-squares slots a slice of an (m, n) C takes: kSqParts a tile.
inline long long tile_parts(int m, int n) {
  return (long long)((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN) * kSqParts;
}

template <typename TA, typename TB, typename TC>
cudaError_t launch_gemm(const GemmArgs& p, int batch, cudaStream_t stream) {
  constexpr int bytes =
      SmemLayout<IsF32<TA>::value, IsF32<TB>::value>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<TA, TB, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM, batch);
  gemm_kernel<TA, TB, TC><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Runtime dispatch over the operand types: a_type / b_type are 0 (bf16),
// 1 (float32) or 2 (int8, with its scale in p), c_f32 selects a float32
// (1) or bf16 (0) C.  An int8 operand pairs with a bf16 or float32 one
// and a float32 C; other int8 combinations are refused.
inline cudaError_t dispatch_gemm(const GemmArgs& p, int batch, int a_type,
                                 int b_type, int c_f32, cudaStream_t s) {
  using bf = __nv_bfloat16;
  using i8 = int8_t;
  if (a_type == 2 || b_type == 2) {
    if (!c_f32) return cudaErrorInvalidValue;
    switch (a_type * 3 + b_type) {
      case 6: return launch_gemm<i8, bf, float>(p, batch, s);
      case 7: return launch_gemm<i8, float, float>(p, batch, s);
      case 2: return launch_gemm<bf, i8, float>(p, batch, s);
      case 5: return launch_gemm<float, i8, float>(p, batch, s);
      default: return cudaErrorInvalidValue;
    }
  }
  const int code = (a_type << 2) | (b_type << 1) | c_f32;
  switch (code) {
    case 0: return launch_gemm<bf, bf, bf>(p, batch, s);
    case 1: return launch_gemm<bf, bf, float>(p, batch, s);
    case 2: return launch_gemm<bf, float, bf>(p, batch, s);
    case 3: return launch_gemm<bf, float, float>(p, batch, s);
    case 4: return launch_gemm<float, bf, bf>(p, batch, s);
    case 5: return launch_gemm<float, bf, float>(p, batch, s);
    case 6: return launch_gemm<float, float, bf>(p, batch, s);
    default: return launch_gemm<float, float, float>(p, batch, s);
  }
}

}  // namespace mkor
