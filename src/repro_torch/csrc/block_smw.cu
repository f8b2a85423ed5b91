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
//
// int8 banks (fused_block_smw[int8], MKOR's int8 factor state): replaces
// the quant body of the same TPU kernel (sc_ref at rank1_smw.py:214, the
// dequantizing _j_tile at :220, the scale operand at :335-339).  J arrives
// as int8 codes with one fp32 scale per slice; passes 1 and 3 read the
// codes 4 to a 32-bit load, which keeps the Vt values and fp32 outputs
// beside them one coalesced float4 a lane, and decode each one in
// registers (code * scale), so no decoded copy of the bank exists.  The
// update comes back fp32 for the caller to requantize, into a separate
// output.  Pass 2 and the pivot are unchanged.
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

// scale: the (batch,) int8 scales, or null (bf16 / fp32: 1).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
block_uv_kernel(const T* __restrict__ j, const float* __restrict__ vt,
                const float* __restrict__ scale, int d, int vec,
                float* __restrict__ u, float* __restrict__ s_part) {
  constexpr int VEC = LoadVec<T>::VEC;
  using Raw = typename LoadVec<T>::Raw;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const float* vb = vt + (long long)b * R * d;
  const T* jb = j + (long long)b * d * d;
  const float sc = scale != nullptr ? scale[b] : 1.0f;

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
          const Raw raw =
              *reinterpret_cast<const Raw*>(jb + (long long)row * d + c);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int q = 0; q < VEC; ++q) jv[rr][q] = to_f32(e[q]) * sc;
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
        jv[rr] = row < d ? to_f32(jb[(long long)row * d + c]) * sc : 0.0f;
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

// T: the bank's type; TO: the output's (T itself, or fp32 for int8).
template <typename T, typename TO, int R>
__global__ void __launch_bounds__(kThreads)
block_write_kernel(const T* j, TO* out, const float* __restrict__ u,
                   const float* __restrict__ m_arr,
                   const float* __restrict__ gm_arr,
                   const float* __restrict__ scale, int d, int vec,
                   int variant) {
  constexpr int VEC = LoadVec<T>::VEC;
  using Raw = typename LoadVec<T>::Raw;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const float gm = gm_arr[b];
  const float alpha = variant == 0 ? gm : 1.0f / gm;
  const float sc = scale != nullptr ? scale[b] : 1.0f;
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
      Raw raw[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        raw[rr] = row0 + rr < d
            ? *reinterpret_cast<const Raw*>(
                  j + base + (long long)(row0 + rr) * d + c)
            : Raw{};
      float x[kRowsPerWarp][VEC];
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
          const T* e = reinterpret_cast<const T*>(&raw[rr]);
          x[rr][q] = alpha * (to_f32(e[q]) * sc) + t;
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        if (row0 + rr < d)
          store_vec<TO, VEC>(x[rr],
                             out + base + (long long)(row0 + rr) * d + c);
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
        store(alpha * (to_f32(j[at]) * sc) + t, out + at);
      }
    }
  }
}

template <typename T, typename TO, int R>
int launch(const void* j, const float* vt, const float* gm,
           const float* scale, void* out, float* u, float* s_part, float* m,
           float* piv, int d, int batch, int r_real, int vec, int variant,
           cudaStream_t stream) {
  const dim3 grid((d + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  block_uv_kernel<T, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(j), vt, scale, d, vec, u, s_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  block_mid_kernel<R><<<batch, kThreads, 0, stream>>>(
      s_part, (int)grid.x, gm, variant, r_real, m, piv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  block_write_kernel<T, TO, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(j), static_cast<TO*>(out), u, m, gm, scale, d,
      vec, variant);
  return (int)cudaGetLastError();
}

template <typename T, typename TO>
int dispatch(int rank, const void* j, const float* vt, const float* gm,
             const float* scale, void* out, float* u, float* s_part,
             float* m, float* piv, int d, int batch, int r_real, int vec,
             int variant, cudaStream_t stream) {
#define MKOR_BLOCK_RANK(R)                                                 \
  case R:                                                                  \
    return launch<T, TO, R>(j, vt, gm, scale, out, u, s_part, m, piv, d,   \
                            batch, r_real, vec, variant, stream);
  switch (rank) {
    MKOR_BLOCK_RANK(1)
    MKOR_BLOCK_RANK(2)
    MKOR_BLOCK_RANK(4)
    MKOR_BLOCK_RANK(8)
    MKOR_BLOCK_RANK(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MKOR_BLOCK_RANK
}

}  // namespace

// j: (batch, d, d) of type j_type (0 bf16, 1 fp32, 2 int8); out: the same
// shape in j's type, or fp32 for int8 (then scale is the (batch,) fp32
// per-slice scale, else null).  vt: (batch, rank, d) fp32 (rows beyond
// r_real zero); gm: (batch,) fp32; u: (batch, d, rank) fp32 scratch;
// s_part: (batch, mkor_block_smw_partials(d), rank * rank) fp32 scratch;
// m: (batch, rank * rank) fp32 scratch; piv: (batch,) fp32 or null (then
// no pivot is written).  out may equal j when the types agree.  rank is
// 1, 2, 4, 8 or 16.  variant: 0 = paper, 1 = exact_smw.
extern "C" int mkor_fused_block_smw(const void* j, const float* vt,
                                    const float* gm, const float* scale,
                                    void* out, float* u, float* s_part,
                                    float* m, float* piv, int d, int batch,
                                    int rank, int r_real, int j_type,
                                    int vec, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (j_type) {
    case 0: return dispatch<__nv_bfloat16, __nv_bfloat16>(
        rank, j, vt, gm, nullptr, out, u, s_part, m, piv, d, batch, r_real,
        vec, variant, s);
    case 1: return dispatch<float, float>(
        rank, j, vt, gm, nullptr, out, u, s_part, m, piv, d, batch, r_real,
        vec, variant, s);
    case 2: return dispatch<int8_t, float>(
        rank, j, vt, gm, scale, out, u, s_part, m, piv, d, batch, r_real,
        vec, variant, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mkor_block_smw_partials(int d) {
  return (d + kRowsPerBlock - 1) / kRowsPerBlock;
}
