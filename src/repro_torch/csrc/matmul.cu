// Batched matmul: C[b] = A[b] @ B[b] with fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py::matmul (the
// pallas_call at matmul.py:45), a (M,K)@(K,N) product with an fp32
// accumulator and an out_dtype output.  The port adds a batch axis so one
// launch covers a whole factor bank (the reference vmaps).
//
// What bounds it on the H100: at the shapes MKOR gives it (K >= 1024) the
// arithmetic intensity is far above the card's ~295 bf16 operations per
// byte, so it is bound by tensor-core operations.  The design therefore
// puts the inner product on the tensor cores (WMMA bf16, fp32
// accumulators, gemm.cuh) instead of scalar fp32 FMAs; float32 inputs are
// split into bf16 hi/lo parts so they keep 16 significant bits.  128x128
// tiles with two shared-memory stages (the next tile's loads held in
// registers during the current tile's products) are the simple version;
// TMA and wgmma, the way to the card's full tensor-core rate, come later.
// An int8 operand (an int8 factor bank's codes, with one fp32 scale per
// batch entry) enters the tensor cores as exact bf16 parts and its scale
// multiplies the accumulator in the epilogue (gemm.cuh): the first product
// of fused_precond[int8] runs here with no decoded copy of the bank.
#include "gemm.cuh"

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
