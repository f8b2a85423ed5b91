// The two unfused building blocks of the reference's rank-1 SMW update
// (MKOR Alg. 1 lines 7-8), each bound by memory bytes on the H100: about
// 2-3 fp32 operations per element of J against 2 bytes (bf16) read, far
// below the ~20 operations per byte the CUDA cores need at 3.35 TB/s.
//   * matvec_kernel replaces src/repro/kernels/rank1_smw.py::matvec
//     (pallas_call :63): u = J v with fp32 accumulation, one read of J.
//     One warp a row (row_dot): 16-byte loads of J and a warp reduction.
//   * rank1_update_kernel replaces rank1_smw.py::rank1_update (pallas_call
//     :95): J <- gamma J + coef u u^T, one read and one write of J in
//     16-byte vectors, coef read from device memory (no host sync): the
//     outer product never exists in memory.
// The fused update itself (rank1_smw.py::fused_smw, pallas_call :381) is
// the rank-1 instance of the block kernel in block_smw.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // one warp per row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// The vector a lane loads from J: 16 bytes.
template <typename T>
struct LoadVec {
  static constexpr int VEC = 16 / sizeof(T);
  using Raw = uint4;
};

// J[row, :] . v over one warp (every lane gets the sum); 0 past the last
// row.  Every lane of the warp must call it.
template <typename T>
__device__ __forceinline__ float row_dot(const T* __restrict__ j,
                                         const float* __restrict__ v, int d,
                                         int vec, int row, int lane) {
  constexpr int VEC = LoadVec<T>::VEC;
  using Raw = typename LoadVec<T>::Raw;
  float acc = 0.0f;
  if (row < d) {
    const T* jr = j + (long long)row * d;
    if (vec) {
      for (int c = lane * VEC; c < d; c += 32 * VEC) {
        const Raw raw = *reinterpret_cast<const Raw*>(jr + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc += to_f32(e[i]) * v[c + i];
      }
    } else {
      for (int c = lane; c < d; c += 32) acc += to_f32(jr[c]) * v[c];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const T* __restrict__ j, const float* __restrict__ v, int d,
              int vec, float* __restrict__ u) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  const float acc = row_dot(j + (long long)b * d * d, v + (long long)b * d,
                            d, vec, row, lane);
  if (lane == 0 && row < d) u[(long long)b * d + row] = acc;
}

// out = gamma J + coef u u^T, coef read from device memory
template <typename T>
__global__ void __launch_bounds__(kThreads)
rank1_update_kernel(const T* j, T* out, const float* __restrict__ u,
                    const float* __restrict__ coef_p, int d, int vec,
                    float gamma) {
  constexpr int VEC = 16 / sizeof(T);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= d) return;
  const float* ub = u + (long long)b * d;
  const float cu = coef_p[b] * ub[row];
  const long long base = ((long long)b * d + row) * d;
  const T* jr = j + base;
  T* orow = out + base;
  if (vec) {
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      uint4 raw = *reinterpret_cast<const uint4*>(jr + c);
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        store(gamma * to_f32(e[i]) + cu * ub[c + i], e + i);
      *reinterpret_cast<uint4*>(orow + c) = raw;
    }
  } else {
    for (int c = lane; c < d; c += 32)
      store(gamma * to_f32(jr[c]) + cu * ub[c], orow + c);
  }
}

}  // namespace

// j: (batch, d, d) bf16 (j_f32 = 0) or fp32; v, u: (batch, d) fp32.
extern "C" int mkor_matvec(const void* j, const float* v, float* u, int d,
                           int batch, int j_f32, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((d + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  if (j_f32)
    matvec_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(j), v, d, vec, u);
  else
    matvec_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(j), v, d, vec, u);
  return (int)cudaGetLastError();
}

// j, out: (batch, d, d) bf16 or fp32 (out may equal j); u: (batch, d)
// fp32; coef: (batch,) fp32 on the device.
extern "C" int mkor_rank1_update(const void* j, void* out, const float* u,
                                 const float* coef, int d, int batch,
                                 int j_f32, int vec, float gamma,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((d + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  if (j_f32)
    rank1_update_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(j), static_cast<float*>(out), u, coef, d,
        vec, gamma);
  else
    rank1_update_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(j),
        static_cast<__nv_bfloat16*>(out), u, coef, d, vec, gamma);
  return (int)cudaGetLastError();
}
