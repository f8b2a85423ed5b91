// Fused two-sided precondition + Frobenius rescale (MKOR Alg. 1 lines
// 9-10): out[b] = D[b] * ||G[b]||_F / max(||D[b]||_F, 1e-30), where
// D[b] = P[b] @ Q[b] is the second product of R^-1 G L^-1.
//
// Replaces the TPU kernel src/repro/kernels/precond.py::fused_precond
// (the pallas_call at precond.py:144).  The TPU kernel keeps T = R^-1 G
// and D in two VMEM scratches across a sequential three-pass grid.  On
// the H100 blocks run in no order and a (d_in, d_out) fp32 slice does
// not fit in shared memory, so the work is split by what each step needs:
//   * the first product goes through the port's matmul kernel
//     (matmul.cu), written as fp32 to device scratch.  The wrapper picks
//     the association ((R^-1 G) L^-1 or R^-1 (G L^-1)) that makes the
//     second product -- the one with a float32 operand, two tensor-core
//     products per tile -- the cheaper one;
//   * this file's entry then launches, on one stream: a per-slice sum of
//     squares of G, the second product with the sum of squares of D
//     fused into its epilogue (gemm.cuh, one atomic per warp), and an
//     in-place scale pass.  The cross-block reductions that the TPU grid
//     carried in SMEM become atomics into a (2, batch) scratch.
// Zero padding never appears: ragged dims are masked in the tiles.
//
// What bounds it on the H100: 2*d_in*d_out*(d_in+d_out) operations per
// slice on bf16 inputs against ~(d_in^2 + d_in*d_out + d_out^2)*2 bytes
// read: bound by tensor-core operations.  The scale pass re-reads D
// (fp32), a bytes-bound tail.  Summation order (atomics) varies from run
// to run, so results agree with the plain version to float32 rounding,
// not bit for bit.
#include "gemm.cuh"

namespace {

template <typename T>
__global__ void sumsq_kernel(const T* __restrict__ x, long long per_batch,
                             float* __restrict__ out) {
  const int b = blockIdx.y;
  const T* xb = x + b * per_batch;
  float acc = 0.0f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < per_batch; i += (long long)gridDim.x * blockDim.x) {
    const float v = mkor::to_f32(xb[i]);
    acc += v * v;
  }
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[32];
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < blockDim.x / 32; ++w) s += warp_sums[w];
    atomicAdd(out + b, s);
  }
}

__global__ void rescale_kernel(float* __restrict__ d, long long per_batch,
                               const float* __restrict__ gsq,
                               const float* __restrict__ dsq) {
  const int b = blockIdx.y;
  const float scale = sqrtf(gsq[b]) / fmaxf(sqrtf(dsq[b]), 1e-30f);
  float* db = d + b * per_batch;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < per_batch; i += (long long)gridDim.x * blockDim.x)
    db[i] *= scale;
}

}  // namespace

// p (batch, m, k) @ q (batch, k, n) -> out (batch, m, n) fp32, rescaled
// per slice by ||g[b]||_F / max(||out[b]||_F, 1e-30) when rescale != 0.
// g is (batch, g_elems) bf16 or fp32; sums is a (2 * batch) fp32 scratch.
extern "C" int mkor_fused_precond(const void* p, const void* q,
                                  const void* g, float* out, float* sums,
                                  int m, int n, int k, int batch,
                                  int p_f32, int q_f32, int g_f32,
                                  int vec_p, int vec_q, int rescale,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long per_out = (long long)m * n;
  float* gsq = sums;
  float* dsq = sums + batch;
  if (rescale) {
    cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(float) * 2 * batch,
                                      stream);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(64, batch);
    if (g_f32)
      sumsq_kernel<float><<<grid, 256, 0, stream>>>(
          static_cast<const float*>(g), per_out, gsq);
    else
      sumsq_kernel<__nv_bfloat16><<<grid, 256, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(g), per_out, gsq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  mkor::GemmArgs a{p, q, out, m, n, k, (long long)k, (long long)n,
                   (long long)n, (long long)m * k, (long long)k * n, per_out,
                   vec_p, vec_q, rescale ? dsq : nullptr};
  cudaError_t err = mkor::dispatch_gemm(a, batch, p_f32, q_f32, 1, stream);
  if (err != cudaSuccess || !rescale) return (int)err;
  rescale_kernel<<<dim3(256, batch), 256, 0, stream>>>(out, per_out, gsq, dsq);
  return (int)cudaGetLastError();
}
