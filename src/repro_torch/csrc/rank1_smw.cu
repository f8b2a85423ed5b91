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
// What bounds it on the H100: 4 d^2 fp32 operations against 2 reads and
// one write of J (bf16) per slice -- far below the ~20 fp32 operations per
// byte the CUDA cores need at 3.35 TB/s, so it is bound by memory bytes.
// The design keeps every byte of J moving in 16-byte vectors and touches J
// exactly twice for reading and once for writing; u and v stay in L2.
//
// int8 banks (fused_smw[int8], MKOR's int8 factor state): replaces the
// quant body of the same TPU kernel (sc_ref at rank1_smw.py:139, the
// dequantizing _j_tile at :143, int8 in and fp32 out at :381-391).  J
// arrives as int8 codes with one fp32 scale per slice; both passes read
// the codes, 4 to a 32-bit load (a warp reads 128 contiguous bytes), and
// decode each one in registers (code * scale) before it is used, so no
// fp32 or bf16 copy of the bank is made.  Four codes a lane keep the fp32
// values beside them (v, u and the output) one coalesced float4 a lane;
// a first version read 16 codes a lane, its float4s at a 64-byte stride
// across the warp, and took 2.1x the bf16 kernel's time on an H100.  The update comes back fp32 -- the caller
// requantizes it, which needs the slice's new max-abs -- so it goes to a
// separate output (int8 in, fp32 out: never in place).  Bytes per
// element: 1 + 1 read, 4 written, the same 6 as the bf16 route.
//
// The same file holds the two unfused building blocks of the reference,
// each bound by memory bytes as well:
//   * matvec_kernel replaces rank1_smw.py::matvec (pallas_call :63):
//     u = J v with fp32 accumulation, one read of J.  It is pass 1 above
//     without the s partials: the same warp-per-row dot product
//     (row_dot), 16-byte loads and a warp reduction.
//   * rank1_update_kernel replaces rank1_smw.py::rank1_update (pallas_call
//     :95): J <- gamma J + coef u u^T, one read and one write of J.  It is
//     pass 2 above with coef read from device memory instead of formed
//     from s: the outer product never exists in memory.
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
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// The vector a lane loads from J: 16 bytes of bf16 or fp32; for int8
// codes 4 bytes, so that the fp32 values a lane reads (v, Vt) and writes
// (the int8 variant's fp32 output) beside them are one coalesced float4.
template <typename T>
struct LoadVec {
  static constexpr int VEC = 16 / sizeof(T);
  using Raw = uint4;
};
template <>
struct LoadVec<int8_t> {
  static constexpr int VEC = 4;
  using Raw = uint32_t;
};

// Writes VEC values (VEC * sizeof(TO) bytes, a multiple of 16) as 16-byte
// stores.
template <typename TO, int VEC>
__device__ __forceinline__ void store_vec(const float* x, TO* dst) {
  alignas(16) TO o[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) store(x[i], o + i);
#pragma unroll
  for (int k = 0; k < VEC * (int)sizeof(TO) / 16; ++k)
    reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(o)[k];
}

// J[row, :] . v over one warp (every lane gets the sum); 0 past the last
// row.  Each element of J is decoded as to_f32(J) * sc at its load (sc is
// the slice's int8 scale, 1 for bf16 and fp32).  Every lane of the warp
// must call it.
template <typename T>
__device__ __forceinline__ float row_dot(const T* __restrict__ j,
                                         const float* __restrict__ v, int d,
                                         int vec, int row, int lane,
                                         float sc) {
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
        for (int i = 0; i < VEC; ++i) acc += to_f32(e[i]) * sc * v[c + i];
      }
    } else {
      for (int c = lane; c < d; c += 32) acc += to_f32(jr[c]) * sc * v[c];
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
                            d, vec, row, lane, 1.0f);
  if (lane == 0 && row < d) u[(long long)b * d + row] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
smw_uv_kernel(const T* __restrict__ j, const float* __restrict__ v,
              const float* __restrict__ scale, int d, int vec,
              float* __restrict__ u, float* __restrict__ s_part) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  const float* vb = v + (long long)b * d;
  const float sc = scale != nullptr ? scale[b] : 1.0f;
  const float acc = row_dot(j + (long long)b * d * d, vb, d, vec, row, lane,
                            sc);
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

// T: the bank's type; TO: the output's (T itself, or fp32 for int8).
template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
smw_write_kernel(const T* j, TO* out, const float* __restrict__ u,
                 const float* __restrict__ s_part,
                 const float* __restrict__ scale, int n_parts, int d,
                 int vec, float gamma, int variant) {
  constexpr int VEC = LoadVec<T>::VEC;
  using Raw = typename LoadVec<T>::Raw;
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
  const float alpha = variant == 0 ? gamma : 1.0f / gamma;
  const float sc = scale != nullptr ? scale[b] : 1.0f;

  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= d) return;
  const float* ub = u + (long long)b * d;
  const float cu = coef * ub[row];
  const long long base = ((long long)b * d + row) * d;
  const T* jr = j + base;
  TO* orow = out + base;
  if (vec) {
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      const Raw raw = *reinterpret_cast<const Raw*>(jr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
      float x[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        x[i] = alpha * (to_f32(e[i]) * sc) + cu * ub[c + i];
      store_vec<TO, VEC>(x, orow + c);
    }
  } else {
    for (int c = lane; c < d; c += 32)
      store(alpha * (to_f32(jr[c]) * sc) + cu * ub[c], orow + c);
  }
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

template <typename T, typename TO>
int launch(const void* j, const float* v, const float* scale, void* out,
           float* u, float* s_part, int d, int batch, int vec, float gamma,
           int variant, cudaStream_t stream) {
  const dim3 grid((d + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  smw_uv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(j), v, scale, d, vec, u, s_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smw_write_kernel<T, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(j), static_cast<TO*>(out), u, s_part, scale,
      (int)grid.x, d, vec, gamma, variant);
  return (int)cudaGetLastError();
}

}  // namespace

// j: (batch, d, d) of type j_type (0 bf16, 1 fp32, 2 int8); out: the same
// shape in j's type, or fp32 for int8 (then scale is the (batch,) fp32
// per-slice scale, else null).  v: (batch, d) fp32; u: (batch, d) fp32
// scratch; s_part: (batch, ceil(d / 8)) fp32 scratch.  out may equal j
// when the types agree.  variant: 0 = paper, 1 = exact_smw.
extern "C" int mkor_fused_smw(const void* j, const float* v,
                              const float* scale, void* out, float* u,
                              float* s_part, int d, int batch, int j_type,
                              int vec, float gamma, int variant,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (j_type) {
    case 0: return launch<__nv_bfloat16, __nv_bfloat16>(
        j, v, nullptr, out, u, s_part, d, batch, vec, gamma, variant, s);
    case 1: return launch<float, float>(j, v, nullptr, out, u, s_part, d,
                                        batch, vec, gamma, variant, s);
    case 2: return launch<int8_t, float>(j, v, scale, out, u, s_part, d,
                                         batch, vec, gamma, variant, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mkor_smw_partials(int d) {
  return (d + kRowsPerBlock - 1) / kRowsPerBlock;
}

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
