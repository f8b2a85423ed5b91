// Fused block rank-r Woodbury inverse update (MKOR paper §4), batched over
// a whole factor bank:
//
//   U = J Vt^T (d, r),  S = Vt U (r, r),  M = A(gm, S)^-1
//   paper:     out = gm J + U M U^T,        A = gm^2 I + gm^3 S
//   exact_smw: out = (J - U M U^T) / gm,    A = gm I + S
//
// Vt (r, d) holds the window rows already weighted by sqrt(w_i), and gm =
// gamma^m is a per-slice scalar (the window of each slice may be filled to
// a different depth; a slice with an empty window has Vt = 0 and gm = 1
// and comes back unchanged).
//
// Replaces the TPU kernel src/repro/kernels/rank1_smw.py::fused_block_smw
// (the pallas_call at rank1_smw.py:340, kernel body :183-291), which runs a
// sequential two-pass grid, keeps U, S and M in VMEM and inverts the r x r
// mid matrix in the first write tile.  On the H100 blocks run in no order
// and the write pass needs all of U and the finished M, so the port uses
// three launches on one stream:
//   1. block_uv_kernel: each warp takes 4 rows of J and keeps r fp32
//      accumulators per row, so one read of J yields all r matvecs
//      U[row, i] = J[row, :] . Vt[i, :] (16-byte loads; the Vt values
//      loaded for a column chunk serve all 4 rows).  Each block writes its
//      partial of S = Vt U (r x r) to a (batch, n_blocks, r*r) scratch:
//      no atomics, so S is summed in a fixed order and the result is
//      deterministic.
//   2. block_mid_kernel: one block per slice sums the partials in that
//      fixed order, forms A(gm, S) and inverts it in fp32 by unpivoted
//      Gauss-Jordan (A is positive definite by the block form of the
//      paper's Lemma 3.1, as in the reference; rows are eliminated in the
//      reference's order).  It writes M already multiplied by the sign
//      and 1/gm of the variant, and, when asked, the smallest |pivot| of
//      the elimination over the real (unpadded) rows.
//   3. block_write_kernel: streams J once more; each warp forms
//      W = U[row, :] M for its 4 rows and writes alpha J[row, c] +
//      W . U[c, :].
// The rank is a template parameter (1, 2, 4, 8 or 16); the wrapper pads
// Vt with zero rows up to it, which leaves U's real columns, S's real
// block and the real pivots unchanged.  U, the S partials and M live in a
// small device scratch the wrapper owns.  The grid's second axis is the
// bank slice, so one launch triple covers a whole bucket.  The write may
// alias J (in-place update): each element is read and written by the same
// thread, and pass 1 has finished reading J.  Nothing goes back to the
// host: no synchronisation reads S, M or the pivot.
//
// What bounds it on the H100: about 4 r d^2 fp32 operations against two
// reads and one write of J (bf16) per slice, about 0.7 r operations per
// byte, far below the ~20 fp32 operations per byte the CUDA cores need at
// 3.35 TB/s: it is bound by memory bytes at every rank MKOR uses.  The
// design reads J exactly twice and writes it once, in 16-byte vectors;
// Vt, U and M stay in L1/L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
block_uv_kernel(const T* __restrict__ j, const float* __restrict__ vt,
                int d, int vec, float* __restrict__ u,
                float* __restrict__ s_part) {
  constexpr int VEC = 16 / sizeof(T);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const float* vb = vt + (long long)b * R * d;
  const T* jb = j + (long long)b * d * d;

  float acc[kRowsPerWarp][R];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[rr][i] = 0.0f;

  if (vec) {
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float jv[kRowsPerWarp][VEC];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int row = row0 + rr;
        if (row < d) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(jb + (long long)row * d + c);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int q = 0; q < VEC; ++q) jv[rr][q] = to_f32(e[q]);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) jv[rr][q] = 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float vv[VEC];
#pragma unroll
        for (int q = 0; q < VEC; q += 4) {
          const float4 f =
              *reinterpret_cast<const float4*>(vb + (long long)i * d + c + q);
          vv[q] = f.x; vv[q + 1] = f.y; vv[q + 2] = f.z; vv[q + 3] = f.w;
        }
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[rr][i] += jv[rr][q] * vv[q];
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      float jv[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int row = row0 + rr;
        jv[rr] = row < d ? to_f32(jb[(long long)row * d + c]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float vv = vb[(long long)i * d + c];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr][i] += jv[rr] * vv;
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        acc[rr][i] += __shfl_xor_sync(0xffffffffu, acc[rr][i], off);

  // this block's rows of U and of Vt, for its partial of S = Vt U
  __shared__ float us[kRowsPerBlock][R];
  __shared__ float vs[kRowsPerBlock][R];
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int row = row0 + rr;
      const int sr = warp * kRowsPerWarp + rr;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        us[sr][i] = row < d ? acc[rr][i] : 0.0f;
        vs[sr][i] = row < d ? vb[(long long)i * d + row] : 0.0f;
        if (row < d) u[((long long)b * d + row) * R + i] = acc[rr][i];
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < R * R; t += kThreads) {
    const int i = t / R, k = t % R;
    float s = 0.0f;
    for (int sr = 0; sr < kRowsPerBlock; ++sr) s += vs[sr][i] * us[sr][k];
    s_part[((long long)b * gridDim.x + blockIdx.x) * R * R + t] = s;
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
block_mid_kernel(const float* __restrict__ s_part, int n_parts,
                 const float* __restrict__ gm_arr, int variant, int r_real,
                 float* __restrict__ m_out, float* __restrict__ piv_out) {
  const int b = blockIdx.x;
  const float gm = gm_arr[b];
  __shared__ float a[R][R];
  __shared__ float m[R][R];
  __shared__ float col[R];
  for (int t = threadIdx.x; t < R * R; t += kThreads) {
    const int i = t / R, k = t % R;
    float s = 0.0f;                       // S summed in a fixed order
    for (int p = 0; p < n_parts; ++p)
      s += s_part[((long long)b * n_parts + p) * R * R + t];
    const float eye = i == k ? 1.0f : 0.0f;
    a[i][k] = variant == 0 ? gm * gm * eye + gm * gm * gm * s : gm * eye + s;
    m[i][k] = eye;
  }
  __syncthreads();
  float pmin = INFINITY;
  for (int kk = 0; kk < R; ++kk) {
    const float piv = a[kk][kk];
    // NaN-propagating min over the real rows, only when it is asked for:
    // a non-finite pivot surfaces
    if (piv_out != nullptr && kk < r_real) {
      const float ap = fabsf(piv);
      if (isnan(ap) || ap < pmin) pmin = isnan(pmin) ? pmin : ap;
    }
    if (threadIdx.x < R) col[threadIdx.x] = threadIdx.x == kk
        ? 0.0f : a[threadIdx.x][kk];
    __syncthreads();
    if (threadIdx.x < R) {
      a[kk][threadIdx.x] /= piv;
      m[kk][threadIdx.x] /= piv;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < R * R; t += kThreads) {
      const int i = t / R, k = t % R;
      if (i != kk) {
        a[i][k] -= col[i] * a[kk][k];
        m[i][k] -= col[i] * m[kk][k];
      }
    }
    __syncthreads();
  }
  // paper: + U M U^T; exact_smw: - U M U^T / gm
  const float beta = variant == 0 ? 1.0f : -1.0f / gm;
  for (int t = threadIdx.x; t < R * R; t += kThreads)
    m_out[(long long)b * R * R + t] = beta * m[t / R][t % R];
  if (piv_out != nullptr && threadIdx.x == 0) piv_out[b] = pmin;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
block_write_kernel(const T* j, T* out, const float* __restrict__ u,
                   const float* __restrict__ m_arr,
                   const float* __restrict__ gm_arr, int d, int vec,
                   int variant) {
  constexpr int VEC = 16 / sizeof(T);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const float gm = gm_arr[b];
  const float alpha = variant == 0 ? gm : 1.0f / gm;
  __shared__ float ms[R * R];
  for (int t = threadIdx.x; t < R * R; t += kThreads)
    ms[t] = m_arr[(long long)b * R * R + t];
  __syncthreads();

  const float* ub = u + (long long)b * d * R;
  float w[kRowsPerWarp][R];             // W = U[row, :] M, per row
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + rr;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float s = 0.0f;
      if (row < d) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          s += ub[(long long)row * R + i] * ms[i * R + k];
      }
      w[rr][k] = s;
    }
  }
  const long long base = (long long)b * d * d;
  if (vec) {
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      uint4 raw[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        raw[rr] = row0 + rr < d
            ? *reinterpret_cast<const uint4*>(
                  j + base + (long long)(row0 + rr) * d + c)
            : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        float uc[R];
#pragma unroll
        for (int k = 0; k < R; ++k) uc[k] = ub[(long long)(c + q) * R + k];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          float t = 0.0f;
#pragma unroll
          for (int k = 0; k < R; ++k) t += w[rr][k] * uc[k];
          T* e = reinterpret_cast<T*>(&raw[rr]);
          store(alpha * to_f32(e[q]) + t, e + q);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        if (row0 + rr < d)
          *reinterpret_cast<uint4*>(out + base + (long long)(row0 + rr) * d
                                    + c) = raw[rr];
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      float uc[R];
#pragma unroll
      for (int k = 0; k < R; ++k) uc[k] = ub[(long long)c * R + k];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int row = row0 + rr;
        if (row >= d) continue;
        float t = 0.0f;
#pragma unroll
        for (int k = 0; k < R; ++k) t += w[rr][k] * uc[k];
        const long long at = base + (long long)row * d + c;
        store(alpha * to_f32(j[at]) + t, out + at);
      }
    }
  }
}

template <typename T, int R>
int launch(const void* j, const float* vt, const float* gm, void* out,
           float* u, float* s_part, float* m, float* piv, int d, int batch,
           int r_real, int vec, int variant, cudaStream_t stream) {
  const dim3 grid((d + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  block_uv_kernel<T, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(j), vt, d, vec, u, s_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  block_mid_kernel<R><<<batch, kThreads, 0, stream>>>(
      s_part, (int)grid.x, gm, variant, r_real, m, piv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  block_write_kernel<T, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(j), static_cast<T*>(out), u, m, gm, d, vec,
      variant);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int rank, const void* j, const float* vt, const float* gm,
             void* out, float* u, float* s_part, float* m, float* piv, int d,
             int batch, int r_real, int vec, int variant,
             cudaStream_t stream) {
  switch (rank) {
    case 1: return launch<T, 1>(j, vt, gm, out, u, s_part, m, piv, d, batch,
                                r_real, vec, variant, stream);
    case 2: return launch<T, 2>(j, vt, gm, out, u, s_part, m, piv, d, batch,
                                r_real, vec, variant, stream);
    case 4: return launch<T, 4>(j, vt, gm, out, u, s_part, m, piv, d, batch,
                                r_real, vec, variant, stream);
    case 8: return launch<T, 8>(j, vt, gm, out, u, s_part, m, piv, d, batch,
                                r_real, vec, variant, stream);
    case 16: return launch<T, 16>(j, vt, gm, out, u, s_part, m, piv, d,
                                  batch, r_real, vec, variant, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// j, out: (batch, d, d) bf16 (j_f32 = 0) or fp32; vt: (batch, rank, d) fp32
// (rows beyond r_real zero); gm: (batch,) fp32; u: (batch, d, rank) fp32
// scratch; s_part: (batch, mkor_block_smw_partials(d), rank * rank) fp32
// scratch; m: (batch, rank * rank) fp32 scratch; piv: (batch,) fp32 or
// null (then no pivot is written).  out may equal j.  rank is 1, 2, 4, 8
// or 16.  variant: 0 = paper, 1 = exact_smw.
extern "C" int mkor_fused_block_smw(const void* j, const float* vt,
                                    const float* gm, void* out, float* u,
                                    float* s_part, float* m, float* piv,
                                    int d, int batch, int rank, int r_real,
                                    int j_f32, int vec, int variant,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (j_f32)
    return dispatch<float>(rank, j, vt, gm, out, u, s_part, m, piv, d, batch,
                           r_real, vec, variant, s);
  return dispatch<__nv_bfloat16>(rank, j, vt, gm, out, u, s_part, m, piv, d,
                                 batch, r_real, vec, variant, s);
}

extern "C" int mkor_block_smw_partials(int d) {
  return (d + kRowsPerBlock - 1) / kRowsPerBlock;
}
