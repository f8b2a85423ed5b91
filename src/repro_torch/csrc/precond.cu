// Fused two-sided precondition + Frobenius rescale (MKOR Alg. 1 lines
// 9-10): out[b] = D[b] * ||G[b]||_F / max(||D[b]||_F, 1e-30), where
// D[b] = P[b] @ Q[b] is the second product of R^-1 G L^-1.
//
// Replaces the TPU kernel src/repro/kernels/precond.py::fused_precond
// (def at precond.py:108, the pallas_call at precond.py:144).  The TPU
// kernel keeps T = R^-1 G and D in two VMEM scratches across a sequential
// three-pass grid.  On the H100 blocks run in no order and a (d_in, d_out)
// fp32 slice does not fit in shared memory, so the work is split by what
// each step needs:
//   * the first product goes through the port's matmul kernel (matmul.cu)
//     into device scratch.  The wrapper picks the association
//     ((R^-1 G) L^-1 or R^-1 (G L^-1)) that makes the second product -- the
//     one with the float32 intermediate, two tensor-core products per
//     tile -- the cheaper one;
//   * this file's entry then launches, on one stream: a per-slice sum of
//     squares of G, the second product with the sum of squares of D fused
//     into its epilogue (one atomic per warp), and an in-place scale pass.
//     The cross-block reductions that the TPU grid carried in SMEM become
//     atomics into a (2, batch) scratch.
// Zero padding never appears: ragged dims are masked (WMMA) or zero-filled
// by TMA within each slice.
//
// What bounds it on the H100: 2*d_in*d_out*(d_in+d_out) operations per
// slice on bf16 inputs against ~(d_in^2 + d_in*d_out + d_out^2)*2 bytes
// read: tensor-core operations at every bert-large shape.  The scale pass
// re-reads D (fp32), a bytes-bound tail.  Two cores, picked by the wrapper
// before the launch (kernels/matmul.py:gemm_route):
//   * mkor_fused_precond_tma -- bf16 R, G and L, or int8 R and L, with
//     rows that are multiples of 16 bytes (every bert-large shape): the
//     first product writes T directly as a bf16 hi/lo pair (hi = bf16(T),
//     lo = bf16(T - hi), 4 bytes an element as fp32), and the second
//     product runs on the Hopper core of wgmma_gemm.cuh in split mode: both
//     parts of T arrive by TMA into the same stage as the factor's tile and
//     each k-step issues wgmma(T_hi, F) and wgmma(T_lo, F) into one
//     accumulator -- the hi*f + lo*f arithmetic of the WMMA core, on
//     Hopper's tensor-core path;
//   * mkor_fused_precond -- everything else, on the WMMA core of gemm.cuh
//     (fp32 T split into hi/lo on its way into shared memory).
// Summation order (atomics) varies from run to run, so results agree with
// the plain version to float32 rounding, not bit for bit.
//
// int8 factors (fused_precond[int8], MKOR's int8 factor state): replaces
// the quant body of the same TPU kernel (precond.py:57-63, the dequantized
// R and L panels at :86-88 and :94-96, the scale operands at :140-143).
// R and L arrive as int8 codes with one fp32 scale per slice, and no
// decoded copy of a bank is made.  On the Hopper core the codes are
// TMA-loaded as bytes and widened exactly to bf16 in shared memory
// (wgmma_gemm.cuh) in both products -- the first one through matmul.cu,
// whose hi/lo pair is of the scaled product -- and each product's scale
// multiplies its accumulator in the epilogue, before the sum of squares of
// D and before the store; on the WMMA core (ragged rows) the codes enter
// the tensor cores as single bf16 parts, with the same epilogue.  With
// rescale on the two scales cancel in exact arithmetic, but they are
// applied all the same: the output without rescale, and the sum of
// squares against the 1e-30 guard, depend on them.
#include "gemm.cuh"
#include "wgmma_gemm.cuh"

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

// Zero the (2 * batch) sums and add each slice's sum of squares of g into
// the first half.
cudaError_t start_sums(const void* g, int g_f32, long long per_out,
                       int batch, float* sums, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(float) * 2 * batch,
                                    stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(64, batch);
  if (g_f32)
    sumsq_kernel<float><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(g), per_out, sums);
  else
    sumsq_kernel<__nv_bfloat16><<<grid, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(g), per_out, sums);
  return cudaGetLastError();
}

cudaError_t finish_rescale(float* out, long long per_out, int batch,
                           const float* sums, cudaStream_t stream) {
  rescale_kernel<<<dim3(256, batch), 256, 0, stream>>>(
      out, per_out, sums, sums + batch);
  return cudaGetLastError();
}

}  // namespace

// p (batch, m, k) @ q (batch, k, n) -> out (batch, m, n) fp32, rescaled
// per slice by ||g[b]||_F / max(||out[b]||_F, 1e-30) when rescale != 0.
// p_type / q_type: 0 bf16, 1 fp32, 2 int8 (then p_scale / q_scale is its
// (batch,) fp32 scale, else null).  g is (batch, g_elems) bf16 or fp32;
// sums is a (2 * batch) fp32 scratch.
extern "C" int mkor_fused_precond(const void* p, const void* q,
                                  const void* g, float* out, float* sums,
                                  const float* p_scale,
                                  const float* q_scale, int m, int n, int k,
                                  int batch, int p_type, int q_type,
                                  int g_f32, int vec_p, int vec_q,
                                  int rescale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long per_out = (long long)m * n;
  float* dsq = sums + batch;
  if (rescale) {
    const cudaError_t err = start_sums(g, g_f32, per_out, batch, sums,
                                       stream);
    if (err != cudaSuccess) return (int)err;
  }
  mkor::GemmArgs a{p, q, out, m, n, k, (long long)k, (long long)n,
                   (long long)n, (long long)m * k, (long long)k * n, per_out,
                   vec_p, vec_q, rescale ? dsq : nullptr, p_scale, q_scale};
  cudaError_t err = mkor::dispatch_gemm(a, batch, p_type, q_type, 1, stream);
  if (err != cudaSuccess || !rescale) return (int)err;
  return (int)finish_rescale(out, per_out, batch, sums, stream);
}

// The Hopper core: p (batch, m, k) @ q (batch, k, n) -> out fp32, with
// exactly one operand a bf16 hi/lo pair (p_lo or q_lo not null: the first
// product's T) and the other a bf16 factor, or int8 codes when its scale
// (p_scale / q_scale, (batch,) fp32) is not null; otherwise as
// mkor_fused_precond.
extern "C" int mkor_fused_precond_tma(const void* p, const void* p_lo,
                                      const void* q, const void* q_lo,
                                      const void* g, float* out, float* sums,
                                      const float* p_scale,
                                      const float* q_scale, int m, int n,
                                      int k, int batch, int g_f32,
                                      int rescale, void* stream_ptr) {
  namespace wg = mkor::wg;
  if ((p_lo == nullptr) == (q_lo == nullptr) ||
      (p_lo != nullptr && p_scale != nullptr) ||
      (q_lo != nullptr && q_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long per_out = (long long)m * n;
  float* dsq = rescale ? sums + batch : nullptr;
  if (rescale) {
    const cudaError_t err = start_sums(g, g_f32, per_out, batch, sums,
                                       stream);
    if (err != cudaSuccess) return (int)err;
  }
  const wg::Operand a{p, p_lo, (long long)m * k, p_scale};
  const wg::Operand b{q, q_lo, (long long)k * n, q_scale};
  cudaError_t err;
  if (p_lo != nullptr)
    err = q_scale ? wg::launch<true, false, false, false, true>(
                        a, b, out, nullptr, dsq, m, n, k, batch, stream)
                  : wg::launch<true, false, false>(a, b, out, nullptr, dsq,
                                                   m, n, k, batch, stream);
  else
    err = p_scale ? wg::launch<false, true, false, true, false>(
                        a, b, out, nullptr, dsq, m, n, k, batch, stream)
                  : wg::launch<false, true, false>(a, b, out, nullptr, dsq,
                                                   m, n, k, batch, stream);
  if (err != cudaSuccess || !rescale) return (int)err;
  return (int)finish_rescale(out, per_out, batch, sums, stream);
}
