// The two unfused building blocks of the reference's rank-1 SMW update
// (MKOR Alg. 1 lines 7-8):
//   * matvec_kernel replaces src/repro/kernels/rank1_smw.py::matvec
//     (pallas_call :63): u = J v, fp32 accumulation;
//   * rank1_update_kernel replaces rank1_smw.py::rank1_update (pallas_call
//     :95): out = gamma J + coef u u^T, coef read on the device (no host
//     sync), the outer product never in memory; out may be J itself.
// The TPU kernels tile J 256 x 256 into VMEM and carry u across a
// sequential column grid; nothing of that carries over.  The fused update
// (rank1_smw.py::fused_smw, pallas_call :381) is the rank-1 instance of
// the block kernel in block_smw.cu.
//
// What bounds them on the H100: bytes.  Each does 2-3 fp32 operations per
// element of J against 2 (bf16) or 4 (fp32) bytes read, and rank1_update
// as many written: far below the ~20 operations per byte the CUDA cores
// need at 3.35 TB/s.  At d = 4096 (32 MB of bf16 J) that is streaming;
// at d = 1024 (2 MB, 0.6 us at full rate) it is latency: the whole matrix
// has to be in flight at once, and the launch and the first load are
// most of the time.
//
// What the design does about it:
//   * The fp32 operand (v, or u) is staged once per block into shared
//     memory with float4 loads, at a padded stride (column c at
//     c + c / VEC, VEC = 16 / sizeof(T)): the lanes of a warp read it one
//     element each at stride VEC + 1, which no two lanes share a bank at,
//     for aligned and unaligned rows alike.  It is tiled over columns
//     (kTile) when d exceeds what a block keeps.
//   * J moves in 16-byte vectors, kUnroll of them in flight per lane (all
//     of a 1024-wide bf16 row), each warp one row at a time; a block's
//     first loads of J are issued before the operand is staged, so the
//     two latencies overlap.
//   * Rows that do not start on 16 bytes (ragged d, offset views) take a
//     few scalar columns to the next 16-byte boundary and vectors after
//     it (mode kPerRow); only an output whose alignment differs from J's
//     falls back to scalars (kScalar).
//   * rank1_update reads J and writes out with streaming hints
//     (ld/st.global.cs): neither is read again by this kernel.
//   * The launch plan (grid, shared memory, mode) is worked out here, in
//     the C entry points, from d, the pointers, the SM count and the
//     kernel's occupancy (the last two kept per device).
//   * matvec sums each row in a fixed order (a lane's vectors in order,
//     then its scalars, then shuffles): the same inputs give the same
//     bits.  No atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;         // warps a block, one row each at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;        // 16-byte loads of J in flight per lane
constexpr int kBlocksPerSm = 4;   // the grid's cap, in blocks an SM
constexpr int kTile = 8192;       // operand columns a block keeps staged
constexpr int kDevices = 64;      // devices whose occupancy is kept

// how a row of J is cut into 16-byte vectors
enum Mode { kAligned = 0, kPerRow = 1, kScalar = 2 };

// 16 bytes of J as fp32 values, and single elements
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8, LOG = 3;
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&f)[N]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // the lower address is the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ unsigned bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bits(f[2 * i]) | bits(f[2 * i + 1]) << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4, LOG = 2;
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&f)[N]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  static __device__ __forceinline__ void store1(float* p, float x) { *p = x; }
};

// shared-memory slot of operand column c (relative to the staged tile)
template <int LOG>
__device__ __forceinline__ int pad(int c) {
  return c + (c >> LOG);
}

// x[0, len) -> s, float4 loads where x is 16-byte aligned
template <int LOG>
__device__ void stage(float* s, const float* __restrict__ x, int len) {
  int c = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int n4 = len / 4;
    for (int m = threadIdx.x; m < n4; m += kThreads) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(x) + m);
      s[pad<LOG>(4 * m)] = q.x;
      s[pad<LOG>(4 * m + 1)] = q.y;
      s[pad<LOG>(4 * m + 2)] = q.z;
      s[pad<LOG>(4 * m + 3)] = q.w;
    }
    c += 4 * n4;
  }
  for (; c < len; c += kThreads) s[pad<LOG>(c)] = __ldg(x + c);
}

// A row of J: `head` scalar columns up to its first 16-byte boundary,
// then `nvec` vectors, then scalar columns up to `end` (0 for no row).
struct Span {
  int head, nvec, end;
};

template <typename T, int kMode>
__device__ __forceinline__ Span row_span(const T* row, int d) {
  constexpr int N = Vec<T>::N;
  if (kMode == kScalar) return {0, 0, d};
  int head = 0;
  if (kMode == kPerRow) {
    const int mis =
        (int)((reinterpret_cast<uintptr_t>(row) & 15) / sizeof(T));
    head = mis ? min(d, N - mis) : 0;
  }
  return {head, (d - head) / N, d};
}

// Walks the block's rows (warp w of the block takes rows blockIdx.x *
// kWarps + w, then a grid's worth further on) over the operand x staged
// in tiles of kTile columns; `op` does the arithmetic:
//   op.row(row, off, head)       a live row starts at element off of J
//   op.load(raw, k, kend)        issue loads of vectors k + 32 q < kend
//   op.vec(raw, k, kend, c)      consume them; c: vector k's column in the
//                                staged tile
//   op.one(c, c_rel)             one scalar column
//   op.done(row)                 a live row ends (every lane calls it)
// Vector k lies in tile k / (kTile / VEC), a scalar column c in tile
// c / kTile; the tile stages VEC columns more, so a vector that starts in
// it ends in it.  Every thread of the block reaches every __syncthreads.
template <typename T, int kMode, class Op>
__device__ __forceinline__ void walk_rows(Op& op, const T* j,
                                          const float* __restrict__ x,
                                          int d, float* s) {
  constexpr int N = Vec<T>::N, LOG = Vec<T>::LOG, kTileVecs = kTile / N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntiles = (d + kTile - 1) / kTile;
  bool staged = false;
  for (int row0 = blockIdx.x * kWarps; row0 < d; row0 += gridDim.x * kWarps) {
    const int row = row0 + warp;
    const bool live = row < d;
    const long long off = (long long)(live ? row : 0) * d;
    const Span sp = live ? row_span<T, kMode>(j + off, d) : Span{0, 0, 0};
    if (live) op.row(row, off, sp.head);
    for (int t = 0; t < ntiles; ++t) {
      const int c0 = t * kTile;
      const int kend = min(sp.nvec, (t + 1) * kTileVecs);
      int k = t * kTileVecs + lane;
      uint4 raw[kUnroll];
      op.load(raw, k, kend);          // in flight while the tile stages
      if (!staged || ntiles > 1) {
        __syncthreads();              // the previous tile is consumed
        stage<LOG>(s, x + c0, min(d, c0 + kTile + N) - c0);
        __syncthreads();
        staged = true;
      }
      while (k < kend) {
        op.vec(raw, k, kend, sp.head + k * N - c0);
        k += 32 * kUnroll;
        op.load(raw, k, kend);
      }
      if (t == 0 && lane < sp.head) op.one(lane, lane);
      const int hi = min(sp.end, c0 + kTile);
      for (int c = max(sp.head + sp.nvec * N, c0) + lane; c < hi; c += 32)
        op.one(c, c - c0);
    }
    if (live) op.done(row);
  }
}

// u[row] = J[row, :] . v
template <typename T>
struct MatvecOp {
  static constexpr int N = Vec<T>::N, LOG = Vec<T>::LOG;
  const T* j;
  const float* s;
  float* u;
  const T* jr;
  const uint4* jv;
  float acc;

  __device__ __forceinline__ void row(int, long long off, int head) {
    jr = j + off;
    jv = reinterpret_cast<const uint4*>(jr + head);
    acc = 0.0f;
  }
  __device__ __forceinline__ void load(uint4 (&raw)[kUnroll], int k,
                                       int kend) const {
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)
      if (k + 32 * q < kend) raw[q] = __ldg(jv + k + 32 * q);
  }
  __device__ __forceinline__ void vec(const uint4 (&raw)[kUnroll], int k,
                                      int kend, int c) {
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      if (k + 32 * q < kend) {
        float f[N];
        Vec<T>::unpack(raw[q], f);
        const int cq = c + 32 * q * N;
#pragma unroll
        for (int i = 0; i < N; ++i)
          acc = fmaf(f[i], s[pad<LOG>(cq + i)], acc);
      }
    }
  }
  __device__ __forceinline__ void one(int c, int c_rel) {
    acc = fmaf(Vec<T>::load1(jr + c), s[pad<LOG>(c_rel)], acc);
  }
  __device__ __forceinline__ void done(int row) {
    float a = acc;
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    if (threadIdx.x % 32 == 0) u[row] = a;
  }
};

// out[row, :] = gamma J[row, :] + (coef u[row]) u
template <typename T>
struct Rank1Op {
  static constexpr int N = Vec<T>::N, LOG = Vec<T>::LOG;
  const T* j;
  T* out;
  const float* s;
  const float* u;
  float gamma, coef;
  const T* jr;
  T* orow;
  const uint4* jv;
  uint4* ov;
  float cu;

  // one element, the same rounding on every path
  __device__ __forceinline__ float update(float x, float uc) const {
    return __fmaf_rn(cu, uc, __fmul_rn(gamma, x));
  }
  __device__ __forceinline__ void row(int r, long long off, int head) {
    jr = j + off;
    orow = out + off;
    jv = reinterpret_cast<const uint4*>(jr + head);
    ov = reinterpret_cast<uint4*>(orow + head);
    cu = coef * __ldg(u + r);
  }
  __device__ __forceinline__ void load(uint4 (&raw)[kUnroll], int k,
                                       int kend) const {
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)
      if (k + 32 * q < kend) raw[q] = __ldcs(jv + k + 32 * q);
  }
  __device__ __forceinline__ void vec(const uint4 (&raw)[kUnroll], int k,
                                      int kend, int c) {
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      if (k + 32 * q < kend) {
        float f[N];
        Vec<T>::unpack(raw[q], f);
        const int cq = c + 32 * q * N;
#pragma unroll
        for (int i = 0; i < N; ++i)
          f[i] = update(f[i], s[pad<LOG>(cq + i)]);
        __stcs(ov + k + 32 * q, Vec<T>::pack(f));
      }
    }
  }
  __device__ __forceinline__ void one(int c, int c_rel) {
    const float x = Vec<T>::load1(jr + c);
    Vec<T>::store1(orow + c, update(x, s[pad<LOG>(c_rel)]));
  }
  __device__ __forceinline__ void done(int) {}
};

// j: (batch, d, d); v, u: (batch, d); blockIdx.y is the slice
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const T* __restrict__ j, const float* __restrict__ v, int d,
              float* __restrict__ u) {
  extern __shared__ float s[];
  const long long b = blockIdx.y;
  MatvecOp<T> op{j + b * d * d, s, u + b * d};
  walk_rows<T, kMode>(op, op.j, v + b * d, d, s);
}

// j, out: (batch, d, d), out may be j (each element is read before it is
// written, by the thread that writes it); u: (batch, d); coef: (batch,)
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
rank1_update_kernel(const T* j, T* out, const float* __restrict__ u,
                    const float* __restrict__ coef, int d, float gamma) {
  extern __shared__ float s[];
  const long long b = blockIdx.y;
  Rank1Op<T> op{j + b * d * d, out + b * d * d, s, u + b * d, gamma,
                __ldg(coef + blockIdx.y)};
  walk_rows<T, kMode>(op, op.j, op.u, d, s);
}

// shared memory for one staged tile: kTile + VEC columns at most, padded
template <typename T>
size_t stage_bytes(int d) {
  const int len = d < kTile + Vec<T>::N ? d : kTile + Vec<T>::N;
  return (size_t)(len + ((len - 1) >> Vec<T>::LOG) + 1) * sizeof(float);
}

// One row a warp at a time, at most kBlocksPerSm blocks on each SM (fewer
// where the kernel's occupancy says so), one block a slice row if that is
// fewer: the grid-stride row loop takes the rest.  The cap (SMs times
// blocks an SM) is reckoned once per device at the largest staging, which
// holds no more blocks than a smaller one; `cap` is the kernel instance's
// own cache.
template <typename T, typename Kernel>
int plan_grid(Kernel kernel, int (&cap)[kDevices], int d, int batch,
              dim3* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int held = dev < kDevices ? cap[dev] : 0;
  if (held == 0) {
    int sms = 0, occ = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, kernel, kThreads, stage_bytes<T>(kTile + Vec<T>::N));
    if (err != cudaSuccess) return (int)err;
    if (sms < 1 || occ < 1) return (int)cudaErrorInvalidConfiguration;
    held = sms * (occ < kBlocksPerSm ? occ : kBlocksPerSm);
    if (dev < kDevices) cap[dev] = held;
  }
  const int groups = (d + kWarps - 1) / kWarps;
  *grid = dim3(groups < held ? groups : held, batch);
  return (int)cudaSuccess;
}

template <typename T, int kMode>
int launch_matvec(const T* j, const float* v, float* u, int d, int batch,
                  cudaStream_t stream) {
  static int cap[kDevices] = {};
  dim3 grid;
  const int err = plan_grid<T>(matvec_kernel<T, kMode>, cap, d, batch, &grid);
  if (err != 0) return err;
  matvec_kernel<T, kMode><<<grid, kThreads, stage_bytes<T>(d), stream>>>(
      j, v, d, u);
  return (int)cudaGetLastError();
}

template <typename T, int kMode>
int launch_rank1_update(const T* j, T* out, const float* u, const float* coef,
                        int d, int batch, float gamma, cudaStream_t stream) {
  static int cap[kDevices] = {};
  dim3 grid;
  const int err =
      plan_grid<T>(rank1_update_kernel<T, kMode>, cap, d, batch, &grid);
  if (err != 0) return err;
  rank1_update_kernel<T, kMode>
      <<<grid, kThreads, stage_bytes<T>(d), stream>>>(j, out, u, coef, d,
                                                      gamma);
  return (int)cudaGetLastError();
}

template <typename T>
int matvec_t(const void* jp, const float* v, float* u, int d, int batch,
             int vec, cudaStream_t stream) {
  const T* j = static_cast<const T*>(jp);
  return vec ? launch_matvec<T, kAligned>(j, v, u, d, batch, stream)
             : launch_matvec<T, kPerRow>(j, v, u, d, batch, stream);
}

template <typename T>
int rank1_update_t(const void* jp, void* op, const float* u,
                   const float* coef, int d, int batch, int vec, float gamma,
                   cudaStream_t stream) {
  const T* j = static_cast<const T*>(jp);
  T* out = static_cast<T*>(op);
  // vectors need J's and out's rows on the same 16-byte phase
  const bool same_phase =
      ((reinterpret_cast<uintptr_t>(j) ^ reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  if (vec)
    return launch_rank1_update<T, kAligned>(j, out, u, coef, d, batch, gamma,
                                            stream);
  if (same_phase)
    return launch_rank1_update<T, kPerRow>(j, out, u, coef, d, batch, gamma,
                                           stream);
  return launch_rank1_update<T, kScalar>(j, out, u, coef, d, batch, gamma,
                                         stream);
}

}  // namespace

// j: (batch, d, d) bf16 (j_f32 = 0) or fp32; v, u: (batch, d) fp32; vec:
// every row of j starts on 16 bytes (else each row finds its boundary).
extern "C" int mkor_matvec(const void* j, const float* v, float* u, int d,
                           int batch, int j_f32, int vec, void* stream) {
  if (d <= 0 || batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return j_f32 ? matvec_t<float>(j, v, u, d, batch, vec, s)
               : matvec_t<__nv_bfloat16>(j, v, u, d, batch, vec, s);
}

// j, out: (batch, d, d) bf16 or fp32 (out may equal j); u: (batch, d)
// fp32; coef: (batch,) fp32 on the device; vec: every row of j and of out
// starts on 16 bytes.
extern "C" int mkor_rank1_update(const void* j, void* out, const float* u,
                                 const float* coef, int d, int batch,
                                 int j_f32, int vec, float gamma,
                                 void* stream) {
  if (d <= 0 || batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return j_f32 ? rank1_update_t<float>(j, out, u, coef, d, batch, vec, gamma,
                                       s)
               : rank1_update_t<__nv_bfloat16>(j, out, u, coef, d, batch,
                                               vec, gamma, s);
}
