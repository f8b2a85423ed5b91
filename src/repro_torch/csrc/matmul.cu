// Batched matmul: C[b] = A[b] @ B[b] with fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py::matmul (the
// pallas_call at matmul.py:45, def at matmul.py:35), a (M,K)@(K,N) product
// with an fp32 accumulator and an out_dtype output.  The port adds a batch
// axis so one launch covers a whole factor bank (the reference vmaps).
//
// What bounds it on the H100: at the shapes MKOR gives it (K >= 1024) the
// arithmetic intensity is far above the card's ~295 bf16 operations per
// byte, so it is bound by tensor-core operations.  Two cores, picked by the
// wrapper before the launch (kernels/matmul.py:gemm_route):
//   * mkor_matmul_tma -- bf16 operands whose bases are 16-byte aligned and
//     whose rows are multiples of 16 bytes (every bert-large shape): the
//     Hopper core of wgmma_gemm.cuh (TMA ring of swizzled stages, wgmma,
//     one persistent block per SM).  Its output is fp32 C or, for the first
//     product of fused_precond, a bf16 hi/lo pair (hi = bf16(c),
//     lo = bf16(c - hi)) that the second product loads by TMA;
//   * mkor_matmul -- everything else, on the WMMA core of gemm.cuh:
//     float32 operands (split into bf16 hi/lo parts on their way into
//     shared memory, 16 significant bits), ragged row widths, and int8
//     operands.  An int8 operand (an int8 factor bank's codes, with one
//     fp32 scale per batch entry) enters the tensor cores as exact bf16
//     parts and its scale multiplies the accumulator in the epilogue: the
//     first product of fused_precond[int8] runs here with no decoded copy of
//     the bank.  It stays on this core until an int8 widening stage exists
//     for the TMA core (wgmma_gemm.cuh says why).
#include "gemm.cuh"
#include "wgmma_gemm.cuh"

// a_type / b_type: 0 bf16, 1 fp32, 2 int8 (then a_scale / b_scale is its
// (batch,) fp32 scale, else null).  c_f32: fp32 (1) or bf16 (0) out.
extern "C" int mkor_matmul(const void* a, const void* b, void* c,
                           const float* a_scale, const float* b_scale,
                           int m, int n, int k, long long lda, long long ldb,
                           long long ldc, long long sa, long long sb,
                           long long sc, int batch, int a_type, int b_type,
                           int c_f32, int vec_a, int vec_b, void* stream) {
  mkor::GemmArgs p{a, b, c, m, n, k, lda, ldb, ldc, sa, sb, sc,
                   vec_a, vec_b, nullptr, a_scale, b_scale};
  return (int)mkor::dispatch_gemm(p, batch, a_type, b_type, c_f32,
                                  static_cast<cudaStream_t>(stream));
}

// The Hopper core: a (batch, m, k) @ b (batch, k, n), both bf16, with batch
// strides sa / sb in elements (0 broadcasts a 2-D operand).  hilo = 0: c is
// (batch, m, n) fp32.  hilo = 1: c is the bf16 hi part and c_lo, when not
// null, the bf16 lo part.
extern "C" int mkor_matmul_tma(const void* a, const void* b, void* c,
                               void* c_lo, int m, int n, int k, long long sa,
                               long long sb, int batch, int hilo,
                               void* stream) {
  const mkor::wg::Operand oa{a, nullptr, sa}, ob{b, nullptr, sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      hilo ? mkor::wg::launch<false, false, true>(oa, ob, c, c_lo, nullptr,
                                                  m, n, k, batch, s)
           : mkor::wg::launch<false, false, false>(oa, ob, c, nullptr,
                                                   nullptr, m, n, k, batch,
                                                   s);
  return (int)err;
}
