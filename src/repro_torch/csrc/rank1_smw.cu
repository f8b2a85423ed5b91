// Fused rank-1 Sherman-Morrison inverse update (MKOR Alg. 1 lines 7-8,
// paper Eq. 5/6), batched over a whole factor bank:
//
//   u = J v,  s = v^T u,  J <- scale * J + coef(s) * u u^T
//   paper:     scale = gamma,   coef = (1-gamma) / (gamma^2 (1 + gamma(1-gamma) s))
//   exact_smw: scale = 1/gamma, coef = -(1-gamma) / (gamma (gamma + (1-gamma) s))
//
// Replaces the TPU kernel src/repro/kernels/rank1_smw.py::fused_smw (the
// pallas_call at rank1_smw.py:381), which runs a sequential two-pass grid
// and keeps u in VMEM and s in SMEM.  On the H100 blocks run in no order,
// and the write pass needs all of u and the finished s, so the port uses
// two launches on one stream:
//   1. smw_uv_kernel: one warp per row computes u[row] = J[row,:] . v with
//      16-byte loads and a warp reduction; each block writes its partial
//      of s = v^T u to a (batch, n_blocks) scratch.  No atomics, so s is
//      summed in a fixed order and the result is deterministic.
//   2. smw_write_kernel: every block sums the partials of its slice in
//      the same fixed order, forms coef in fp32 on the device (no host
//      sync), and streams J once more, writing scale*J + coef*u_i*u_k.
// u and the partials live in a small device scratch the wrapper owns.  The
// grid's second axis is the bank slice, so one launch pair covers a whole
// bucket.  The write may alias J (in-place update): each element is read
// and written by the same thread, and pass 1 has finished reading J.
//
// What bounds it on the H100: 4 d^2 operations against 2 reads and one
// write of J (bf16) per slice -- far below the ~295 operations per byte
// the tensor cores need, so it is bound by memory bytes.  The design keeps
// every byte of J moving in 16-byte vectors and touches J exactly twice
// for reading and once for writing; u and v stay in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
smw_uv_kernel(const T* __restrict__ j, const float* __restrict__ v, int d,
              int vec, float* __restrict__ u, float* __restrict__ s_part) {
  constexpr int VEC = 16 / sizeof(T);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  const float* vb = v + (long long)b * d;
  float acc = 0.0f;
  if (row < d) {
    const T* jr = j + ((long long)b * d + row) * d;
    if (vec) {
      for (int c = lane * VEC; c < d; c += 32 * VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(jr + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc += to_f32(e[i]) * vb[c + i];
      }
    } else {
      for (int c = lane; c < d; c += 32) acc += to_f32(jr[c]) * vb[c];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ float part[kRowsPerBlock];
  if (lane == 0) {
    if (row < d) u[(long long)b * d + row] = acc;
    part[warp] = row < d ? vb[row] * acc : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kRowsPerBlock; ++w) s += part[w];
    s_part[(long long)b * gridDim.x + blockIdx.x] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
smw_write_kernel(const T* j, T* out, const float* __restrict__ u,
                 const float* __restrict__ s_part, int n_parts, int d,
                 int vec, float gamma, int variant) {
  constexpr int VEC = 16 / sizeof(T);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // s for this slice, summed in a fixed order (deterministic).
  __shared__ float red[kThreads];
  __shared__ float coef_s;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n_parts; i += kThreads)
    acc += s_part[(long long)b * n_parts + i];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float s = red[0];
    const float g = gamma, omg = 1.0f - gamma;
    coef_s = variant == 0 ? omg / (g * g * (1.0f + g * omg * s))
                          : -omg / (g * (g + omg * s));
  }
  __syncthreads();
  const float coef = coef_s;
  const float scale = variant == 0 ? gamma : 1.0f / gamma;

  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= d) return;
  const float* ub = u + (long long)b * d;
  const float cu = coef * ub[row];
  const long long base = ((long long)b * d + row) * d;
  const T* jr = j + base;
  T* orow = out + base;
  if (vec) {
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      uint4 raw = *reinterpret_cast<const uint4*>(jr + c);
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        store(scale * to_f32(e[i]) + cu * ub[c + i], e + i);
      *reinterpret_cast<uint4*>(orow + c) = raw;
    }
  } else {
    for (int c = lane; c < d; c += 32)
      store(scale * to_f32(jr[c]) + cu * ub[c], orow + c);
  }
}

template <typename T>
int launch(const void* j, const float* v, void* out, float* u,
           float* s_part, int d, int batch, int vec, float gamma,
           int variant, cudaStream_t stream) {
  const dim3 grid((d + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  smw_uv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(j), v, d, vec, u, s_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smw_write_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(j), static_cast<T*>(out), u, s_part,
      (int)grid.x, d, vec, gamma, variant);
  return (int)cudaGetLastError();
}

}  // namespace

// j, out: (batch, d, d) bf16 (j_f32 = 0) or fp32; v: (batch, d) fp32;
// u: (batch, d) fp32 scratch; s_part: (batch, ceil(d / 8)) fp32 scratch.
// out may equal j.  variant: 0 = paper, 1 = exact_smw.
extern "C" int mkor_fused_smw(const void* j, const float* v, void* out,
                              float* u, float* s_part, int d, int batch,
                              int j_f32, int vec, float gamma, int variant,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (j_f32)
    return launch<float>(j, v, out, u, s_part, d, batch, vec, gamma,
                         variant, s);
  return launch<__nv_bfloat16>(j, v, out, u, s_part, d, batch, vec, gamma,
                               variant, s);
}

extern "C" int mkor_smw_partials(int d) {
  return (d + kRowsPerBlock - 1) / kRowsPerBlock;
}
