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
//     into its epilogue, a fixed-order sum of the partial sums, and an
//     in-place scale pass.  The cross-block reductions that the TPU grid
//     carried in SMEM become partial sums in device scratch, one slot per
//     block of the G pass and per warp of each product tile, each written
//     once (no atomics); one block a slice then adds its slots in index
//     order with a fixed tree (sum_parts_kernel).
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
// Every sum runs in the same order on every call, so a second call on the
// same inputs gives the same bits; the results agree with the plain
// version to float32 rounding (another order than torch's), not bit for
// bit.  Replicas of a data-parallel step that run fused_precond on equal
// inputs therefore stay equal.
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

constexpr int kGParts = 64;       // blocks of the G pass a slice
constexpr int kSumThreads = 256;

// One call's scratch: the (2, batch) sums (G, then D), then kGParts slots a
// slice for G, then n_d slots a slice for D.
struct Scratch {
  float* sums;
  float* g_parts;
  float* d_parts;
  long long n_d;
};

Scratch carve(float* scratch, int batch, long long n_d) {
  float* g_parts = scratch + 2 * batch;
  return {scratch, g_parts, g_parts + (long long)kGParts * batch, n_d};
}

// Each thread's sum in a fixed stride order, then a fixed shuffle tree, then
// the warps' sums in index order: the same bits on every launch.  The
// block's sum is in thread 0.
__device__ __forceinline__ float block_sum(float acc) {
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[32];
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < blockDim.x / 32; ++w) s += warp_sums[w];
  return s;
}

// parts[b * kGParts + blockIdx.x] = this block's share of sum(x[b]^2).
template <typename T>
__global__ void sumsq_kernel(const T* __restrict__ x, long long per_batch,
                             float* __restrict__ parts) {
  const int b = blockIdx.y;
  const T* xb = x + b * per_batch;
  float acc = 0.0f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < per_batch; i += (long long)gridDim.x * blockDim.x) {
    const float v = mkor::to_f32(xb[i]);
    acc += v * v;
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) parts[(long long)b * kGParts + blockIdx.x] = s;
}

// sums[b] = sum of g_parts[b, :] (blockIdx.y 0), sums[batch + b] = sum of
// d_parts[b, :] (blockIdx.y 1), one block each.
__global__ void sum_parts_kernel(Scratch sc, int batch) {
  const int b = blockIdx.x;
  const bool d = blockIdx.y == 1;
  const long long n = d ? sc.n_d : kGParts;
  const float* parts = (d ? sc.d_parts : sc.g_parts) + b * n;
  float acc = 0.0f;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) acc += parts[i];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) sc.sums[(d ? batch : 0) + b] = s;
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

// Each slice's partial sums of squares of g into sc.g_parts.
cudaError_t start_sums(const void* g, int g_f32, long long per_out,
                       int batch, const Scratch& sc, cudaStream_t stream) {
  const dim3 grid(kGParts, batch);
  if (g_f32)
    sumsq_kernel<float><<<grid, kSumThreads, 0, stream>>>(
        static_cast<const float*>(g), per_out, sc.g_parts);
  else
    sumsq_kernel<__nv_bfloat16><<<grid, kSumThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(g), per_out, sc.g_parts);
  return cudaGetLastError();
}

// The fixed-order sums of both sets of slots, then the scale pass.
cudaError_t finish_rescale(float* out, long long per_out, int batch,
                           const Scratch& sc, cudaStream_t stream) {
  sum_parts_kernel<<<dim3(batch, 2), kSumThreads, 0, stream>>>(sc, batch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rescale_kernel<<<dim3(256, batch), 256, 0, stream>>>(
      out, per_out, sc.sums, sc.sums + batch);
  return cudaGetLastError();
}

}  // namespace

// The floats of scratch that mkor_fused_precond (tma = 0) or
// mkor_fused_precond_tma (tma = 1; p_split: the hi/lo pair is p, else q;
// q_int8: q is int8 codes) needs for a (batch, m, n) out.
extern "C" long long mkor_fused_precond_scratch(int m, int n, int batch,
                                                int tma, int p_split,
                                                int q_int8) {
  const long long n_d =
      tma ? mkor::wg::tile_parts(m, n, p_split, !p_split, p_split && q_int8)
          : mkor::tile_parts(m, n);
  return (long long)batch * (2 + kGParts + n_d);
}

// p (batch, m, k) @ q (batch, k, n) -> out (batch, m, n) fp32, rescaled
// per slice by ||g[b]||_F / max(||out[b]||_F, 1e-30) when rescale != 0.
// p_type / q_type: 0 bf16, 1 fp32, 2 int8 (then p_scale / q_scale is its
// (batch,) fp32 scale, else null).  g is (batch, g_elems) bf16 or fp32;
// scratch holds mkor_fused_precond_scratch(m, n, batch, 0, 0, 0) floats.
extern "C" int mkor_fused_precond(const void* p, const void* q,
                                  const void* g, float* out, float* scratch,
                                  const float* p_scale,
                                  const float* q_scale, int m, int n, int k,
                                  int batch, int p_type, int q_type,
                                  int g_f32, int vec_p, int vec_q,
                                  int rescale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long per_out = (long long)m * n;
  const Scratch sc = carve(scratch, batch, mkor::tile_parts(m, n));
  if (rescale) {
    const cudaError_t err = start_sums(g, g_f32, per_out, batch, sc, stream);
    if (err != cudaSuccess) return (int)err;
  }
  mkor::GemmArgs a{p, q, out, m, n, k, (long long)k, (long long)n,
                   (long long)n, (long long)m * k, (long long)k * n, per_out,
                   vec_p, vec_q, rescale ? sc.d_parts : nullptr, p_scale,
                   q_scale};
  cudaError_t err = mkor::dispatch_gemm(a, batch, p_type, q_type, 1, stream);
  if (err != cudaSuccess || !rescale) return (int)err;
  return (int)finish_rescale(out, per_out, batch, sc, stream);
}

// The Hopper core: p (batch, m, k) @ q (batch, k, n) -> out fp32, with
// exactly one operand a bf16 hi/lo pair (p_lo or q_lo not null: the first
// product's T) and the other a bf16 factor, or int8 codes when its scale
// (p_scale / q_scale, (batch,) fp32) is not null; scratch holds
// mkor_fused_precond_scratch(m, n, batch, 1, p_lo != null, q_scale != null)
// floats; otherwise as mkor_fused_precond.
extern "C" int mkor_fused_precond_tma(const void* p, const void* p_lo,
                                      const void* q, const void* q_lo,
                                      const void* g, float* out,
                                      float* scratch,
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
  const bool p_split = p_lo != nullptr;
  const Scratch sc = carve(
      scratch, batch,
      wg::tile_parts(m, n, p_split, !p_split, p_split && q_scale != nullptr));
  float* dsq = rescale ? sc.d_parts : nullptr;
  if (rescale) {
    const cudaError_t err = start_sums(g, g_f32, per_out, batch, sc, stream);
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
  return (int)finish_rescale(out, per_out, batch, sc, stream);
}
