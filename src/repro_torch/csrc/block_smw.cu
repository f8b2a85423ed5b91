// Fused block rank-r Woodbury inverse update (MKOR paper §4), batched over
// a whole factor bank, in one persistent launch:
//
//   U = J Vt^T (d, r),  S = w Vt U (r, r),  M = A(gm, S)^-1
//   paper:     out = gm J + w U M U^T,        A = gm^2 I + gm^3 S
//   exact_smw: out = (J - w U M U^T) / gm,    A = gm I + S
//
// Vt (r, d) holds the window rows already weighted by sqrt(w_i), gm = gamma^m
// is a per-slice scalar (the window of each slice may be filled to a
// different depth; a slice with an empty window has Vt = 0 and gm = 1 and
// comes back unchanged), and w is a weight on every row of Vt, 1 for the
// block update.  The rank-1 update of MKOR Alg. 1 (paper Eq. 5/6,
// fused_smw) is the r = 1 instance with Vt = v, gm = gamma and w = 1 - gamma:
// then A = gamma^2 (1 + gamma (1-gamma) s) or gamma + (1-gamma) s, and
// w U M U^T is coef(s) u u^T.
//
// Replaces the TPU kernel src/repro/kernels/rank1_smw.py::fused_block_smw
// (the pallas_call at rank1_smw.py:340, kernel body :183-291) and, as its
// r = 1 instance, rank1_smw.py::fused_smw (pallas_call :381).  Both run a
// sequential two-pass grid that keeps U, S and M in VMEM.
//
// What bounds it on the H100: about 4 r d^2 fp32 operations against one
// read and one write of J per slice, about 0.7 r operations per byte for
// bf16, far below the ~20 fp32 operations per byte the CUDA cores need at
// 3.35 TB/s: it is bound by memory bytes at every rank MKOR uses.  The write
// of a slice needs the whole of its U and M, so J is read twice: 1.5 times
// the bytes of one read and one write.  The design keeps J's bytes moving
// at HBM speed and keeps every latency off the path of a tile:
//
//   * Tiles, runs and tickets.  A tile is `rows` whole rows of one slice, at
//     most kTileBytes of J, which one cp.async.bulk copies into one of two
//     shared-memory buffers (16-byte rows; other banks are loaded element
//     by element).  A ticket names a run of up to `run` tiles (32 rows) of
//     one slice, in pass 1 (U, S) or in the write.  Persistent blocks, two
//     an SM, take tickets from one atomic counter in the order decode_ticket
//     gives: pass-1 runs alone for `lag` tickets, then write and pass-1 runs
//     in turn.  The lag puts a slice's writes more tickets after its pass 1
//     than the blocks hold at once (the launch reckons it from the card's
//     SM count and the kernel's occupancy; smw_plan.cuh holds the plan and
//     the ticket order), so its M is formed before they come and no block
//     waits (sequential groups sized to L2, so that the second
//     read of J would hit it, made the blocks wait on M at every group and
//     ran slower).  Thread 0 walks the tiles two steps ahead of its block:
//     it starts each tile's copy a tile before the block works on it, and
//     takes the next ticket at a run's last tile, a tile before it needs it.
//   * Coalesced operands, loaded once a run.  A block's threads lie across
//     the columns in 1 to 8 row groups, 4 columns to a thread, so the fp32
//     operands beside J -- Vt in pass 1 and U in the write, which pass 1
//     stores transposed as Ut (r, dp) -- are one float4 a thread,
//     neighbouring threads on neighbouring addresses.  They are the same for
//     every tile of a run: a thread loads its chunks of them (at most 64
//     floats) into registers when a run starts, and W = U M for the run's
//     rows into shared memory, so within a run only shared memory is read.
//     Pass 1 reads J's copy once; the write reads it and stores the output
//     with st.global.cs (evict first).
//   * S in a fixed order.  A pass-1 tile reduces its rows' sums across the
//     block (a transposing warp reduction, then its group's warps in order),
//     stores its rows of Ut and adds its share of the run's partial of
//     S = Vt U, which the run's last tile stores to scratch before it
//     arrives on the slice's counter (a release atomic).  The block learns
//     whether it was the last to arrive a tile later (the atomic's reply),
//     and before it waits on any flag.  That block sums the slice's
//     partials in a fixed order, so the result is deterministic, forms
//     A(gm, S), inverts it in fp32 by unpivoted Gauss-Jordan (A is positive
//     definite by the block form of the paper's Lemma 3.1, as in the
//     reference; rows are eliminated in the reference's order), stores M
//     already multiplied by w, the sign and 1/gm of the variant, and, when
//     asked, the smallest pivot over the real (unpadded) rows (NaN when
//     one is not positive or not finite, as the reference's Cholesky), then
//     releases the slice's ready flag.  A block acquires that flag at its
//     first write run of the slice, before it reads U or M.
//
// Why the waits cannot deadlock: tickets are taken in order from the
// counter, and only a running block takes one.  Every ticket a block holds
// beyond the run it works on is larger than that run's.  A write run of
// slice s waits only for the pass-1 runs of s, whose tickets are all
// smaller; pass-1 runs never wait; and a block settles its arrivals (forms
// the M it owes) before it waits.  So the smallest unfinished ticket is
// the run some block works on, and it can always finish, whatever the grid
// size or the order in which the blocks run.  A wait that lasts seconds is
// a fault, and traps instead of hanging the card.
//
// The rank is a template parameter (1, 2, 4, 8 or 16); the wrapper pads Vt
// with zero rows up to it, which leaves U's real columns, S's real block and
// the real pivots unchanged.  The write may alias J (in-place update): each
// element is read and written by the same thread, and a slice is written
// only after all of its pass-1 reads are done.  Ut, the S partials, M and
// the counters live in scratch the wrapper allocates (the counters zeroed);
// nothing goes back to the host, and nothing stops the launch from being
// captured into a CUDA graph.
//
// int8 banks (fused_block_smw[int8] and fused_smw[int8], MKOR's int8 factor
// state): replace the quant bodies of the same TPU kernels (rank1_smw.py:214
// and :139, the dequantizing _j_tile at :220 and :143).  J arrives as int8
// codes with one fp32 scale per slice; both passes read 4 codes a thread
// and decode each in registers (code * scale), so no decoded copy of the
// bank exists.  The update comes back fp32 for the caller to requantize,
// into a separate output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define MKOR_SMW_PLAN_ENTRIES
#include "smw_plan.cuh"

namespace {

using mkor_smw::kMaxTileRows;
using mkor_smw::kThreads;
using mkor_smw::kTileBytes;
using mkor_smw::Run;
using mkor_smw::decode_ticket;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kMaxSpins = 1u << 26;   // ~9 s of 128 ns naps

// The most rows a thread covers at rank R (mkor_smw::max_rows).
template <int R>
struct Rows {
  static constexpr int MAX = mkor_smw::max_rows(R);
};

// The raw word that holds VEC elements of T (VEC = 4 or 1), and its
// decoding into fp32 by bit operations (no type punning through pointers).
template <typename T, int VEC> struct Raw;
template <> struct Raw<float, 4> { using type = uint4; };
template <> struct Raw<float, 1> { using type = unsigned int; };
template <> struct Raw<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };
template <> struct Raw<int8_t, 4> { using type = unsigned int; };
template <> struct Raw<int8_t, 1> { using type = unsigned char; };

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float code(unsigned w, int q) {
  return (float)(int)(signed char)((w >> (8 * q)) & 0xffu);
}

__device__ __forceinline__ void unpack(uint4 r, float* x) {
  x[0] = __uint_as_float(r.x); x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z); x[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(uint2 r, float* x) {
  x[0] = bf16_lo(r.x); x[1] = bf16_hi(r.x);
  x[2] = bf16_lo(r.y); x[3] = bf16_hi(r.y);
}

// Decodes VEC elements of J (code * sc for int8, sc = 1 otherwise).
template <typename T, int VEC>
__device__ __forceinline__ void decode(typename Raw<T, VEC>::type raw,
                                       float sc, float* x) {
  if constexpr (std::is_same<T, int8_t>::value) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) x[q] = code(raw, q) * sc;
  } else if constexpr (VEC == 4) {
    unpack(raw, x);
  } else if constexpr (std::is_same<T, float>::value) {
    x[0] = __uint_as_float(raw);
  } else {
    x[0] = bf16_lo(raw);
  }
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Writes VEC outputs with an evict-first store.
template <typename TO, int VEC>
__device__ __forceinline__ void store_out(const float* x, TO* dst) {
  if constexpr (std::is_same<TO, float>::value) {
    if constexpr (VEC == 4)
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(x[0], x[1], x[2], x[3]));
    else
      __stcs(dst, x[0]);
  } else if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<uint2*>(dst),
           make_uint2(bf16_bits(x[0]) | bf16_bits(x[1]) << 16,
                      bf16_bits(x[2]) | bf16_bits(x[3]) << 16));
  } else {
    __stcs(reinterpret_cast<unsigned short*>(dst),
           (unsigned short)bf16_bits(x[0]));
  }
}

// VEC fp32 values of an input that no block writes (Vt): the read-only path.
template <int VEC>
__device__ __forceinline__ void load_input(const float* p, float* x) {
  if constexpr (VEC == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  } else {
    x[0] = __ldg(p);
  }
}

// VEC fp32 values that blocks of this launch wrote (Ut): an ordinary load,
// made after the acquire of the slice's ready flag.
template <int VEC>
__device__ __forceinline__ void load_written(const float* p, float* x) {
  if constexpr (VEC == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  } else {
    x[0] = *p;
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Adds v with release semantics; the old value is read only when used.
__device__ __forceinline__ unsigned atom_add_release(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Sums N fp32 values (N a power of 2, at most 32) over the 32 lanes of a
// warp in N - 1 + 5 - log2(N) shuffles: each step hands half of the values
// a lane still holds to its partner and keeps the other half.  On return
// v[0] of lane l holds the warp's sum of value l * N / 32.
template <int N, int H>
__device__ __forceinline__ void warp_sum(float* v, int lane) {
  if constexpr (H > 0) {
    if constexpr (N > 1) {
      const bool upper = (lane & H) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = upper ? v[i] : v[i + N / 2];
        const float keep = upper ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
      }
      warp_sum<N / 2, H / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], H);
      warp_sum<1, H / 2>(v, lane);
    }
  }
}

struct Args {
  const void* j;           // (batch, d, d) bf16, fp32 or int8 codes
  const float* vt;         // (batch, R, d)
  const float* gm;         // (batch,) or null: gm_all for every slice
  const float* scale;      // (batch,) int8 scales or null
  void* out;               // (batch, d, d) in j's type, fp32 for int8
  float* ut;               // (batch, R, dp) scratch: U transposed
  float* spart;            // (batch, runs, R * R) scratch: S partials
  float* m;                // (batch, R * R) scratch: M, scaled
  float* piv;              // (batch,) or null
  unsigned* sync;          // [ticket, arrivals (batch), ready flags (batch)]
  float gm_all, vweight;
  int d, dp, batch, rows, tiles, run, runs, lag, r_real, variant;
  int groups;              // row groups a tile's threads split into
};

// One tile as a block works it: its pass, slice and tile, and its run's
// first tile and length (phase -1: no more work).
struct Step {
  int phase, slice, tile, tile0, ntiles;
};

template <int R>
struct Smem {
  float red[kWarps][32];
  float urow[kMaxTileRows][R];     // pass 1: the tile's rows of U
  float vrow[kMaxTileRows][R];     // pass 1: Vt at the run's rows
  float wrow[kMaxTileRows][R];     // the write: W = U M at the run's rows
  float sacc[R * R];               // pass 1: the run's partial of S
  float mmat[R * R];               // the write: M of slice ready_slice
  float sub[kThreads];
  float a[R][R], m[R][R], col[R];
  uint64_t bars[2];                // the bulk copies' mbarriers
  Step steps[3];                   // tiles in work and on their way
  int mid, mid_wait;               // a slice whose M this block forms now
  int ready_slice;                 // the slice whose flag it acquired last
};

// Thread 0's record of its block's last two arrivals on a slice's counter
// (slice -1: none): the older one, made a tile ago, and the newer one.  A
// block learns that it finished a slice's pass 1 (the old count is
// runs - 1) a tile later, so the atomic's round trip stalls no tile; it
// settles the older arrival at the end of each tile and before it waits on
// any ready flag, so no block waits while it owes a slice its M.
struct Arrivals {
  int slice[2];
  unsigned old[2];
};

// A(gm, S) from the slice's S partials, summed in a fixed order, and its
// inverse; publishes M and releases the slice's ready flag.  Run by every
// thread of the block that finished the slice's last pass-1 run.
template <int R>
__device__ void form_mid(const Args& a, int b, Smem<R>& sm) {
  constexpr int RR = R * R;
  constexpr int NSUB = kThreads / RR;
  const int tid = threadIdx.x;
  const float* sp = a.spart + (long long)b * a.runs * RR;
  {
    const int e = tid % RR, p0 = tid / RR;
    float s = 0.0f;
    for (int p = p0; p < a.runs; p += NSUB)
      s += __ldcg(sp + (long long)p * RR + e);
    sm.sub[tid] = s;
  }
  __syncthreads();
  const float gm = a.gm != nullptr ? a.gm[b] : a.gm_all;
  if (tid < RR) {
    float s = 0.0f;
    for (int p0 = 0; p0 < NSUB; ++p0) s += sm.sub[p0 * RR + tid];
    s *= a.vweight;
    const int i = tid / R, k = tid % R;
    const float eye = i == k ? 1.0f : 0.0f;
    sm.a[i][k] = a.variant == 0 ? gm * gm * eye + gm * gm * gm * s
                                : gm * eye + s;
    sm.m[i][k] = eye;
  }
  __syncthreads();
  float pmin = INFINITY;
  for (int kk = 0; kk < R; ++kk) {
    const float piv = sm.a[kk][kk];
    // NaN-propagating min over the real rows, only when it is asked for:
    // a pivot that is not positive (the mid matrix is not positive
    // definite, where the reference's Cholesky fails) or not finite
    // surfaces as NaN
    if (a.piv != nullptr && kk < a.r_real) {
      const float ap = piv > 0.0f ? piv : NAN;
      if (isnan(ap) || ap < pmin) pmin = isnan(pmin) ? pmin : ap;
    }
    if (tid < R) sm.col[tid] = tid == kk ? 0.0f : sm.a[tid][kk];
    __syncthreads();
    if (tid < R) {
      sm.a[kk][tid] /= piv;
      sm.m[kk][tid] /= piv;
    }
    __syncthreads();
    if (tid < RR) {
      const int i = tid / R, k = tid % R;
      if (i != kk) {
        sm.a[i][k] -= sm.col[i] * sm.a[kk][k];
        sm.m[i][k] -= sm.col[i] * sm.m[kk][k];
      }
    }
    __syncthreads();
  }
  // paper: + w U M U^T; exact_smw: - w U M U^T / gm
  const float beta = (a.variant == 0 ? 1.0f : -1.0f / gm) * a.vweight;
  if (tid < RR) a.m[(long long)b * RR + tid] = beta * sm.m[tid / R][tid % R];
  if (a.piv != nullptr && tid == 0) a.piv[b] = pmin;
  __threadfence();
  __syncthreads();
  if (tid == 0) st_release(a.sync + 1 + a.batch + b, 1u);
}

// Settles thread 0's older arrival (see Arrivals), makes the newer one the
// older, and forms M of the slice whose pass 1 the block finished, if any.
// Every thread calls it; it starts with a barrier.
// (sm.mid_wait: the end of a tile uses sm.mid, and thread 0 may reach a
// settle before every thread has read sm.mid.)
template <int R>
__device__ void settle(const Args& a, Smem<R>& sm, Arrivals& arr) {
  if (threadIdx.x == 0) {
    sm.mid_wait = arr.slice[0] >= 0 && arr.old[0] == (unsigned)a.runs - 1u
                      ? arr.slice[0] : -1;
    arr.slice[0] = arr.slice[1];
    arr.old[0] = arr.old[1];
    arr.slice[1] = -1;
  }
  __syncthreads();
  if (sm.mid_wait >= 0) {
    __threadfence();
    form_mid<R>(a, sm.mid_wait, sm);
  }
}

// ---- the bulk path: a tile's rows of J are one contiguous range, copied
// into shared memory by one cp.async.bulk that completes an mbarrier ----
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                  "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Rows [row0, row0 + nrow) of its slice that tile `tile` holds.
__device__ __forceinline__ void tile_rows(const Args& a, int tile, int& row0,
                                          int& nrow) {
  row0 = tile * a.rows;
  nrow = a.d - row0 < a.rows ? a.d - row0 : a.rows;
}

// The step of ticket t's k-th tile (phase -1 past the last ticket).
__device__ __forceinline__ Step step_of(const Args& a, int t, int k,
                                        int n_tickets) {
  if (t >= n_tickets) return Step{-1, 0, 0, 0, 0};
  const Run r = decode_ticket(t, a.batch, a.runs, a.lag);
  const int tile0 = r.run * a.run;
  const int ntiles = a.tiles - tile0 < a.run ? a.tiles - tile0 : a.run;
  return Step{r.phase, r.slice, tile0 + k, tile0, ntiles};
}

// Starts the copy of a step's rows of J into buf (BULK only).
template <typename T>
__device__ __forceinline__ void fetch_tile(const Args& a, const Step& st,
                                           unsigned char* buf,
                                           uint64_t* bar) {
  int row0, nrow;
  tile_rows(a, st.tile, row0, nrow);
  const T* src = static_cast<const T*>(a.j) +
                 ((long long)st.slice * a.d + row0) * a.d;
  bulk_load(buf, src, (unsigned)(nrow * a.d * sizeof(T)), bar);
}

// VEC elements of J at row rr of the tile, column c, in fp32: from the
// tile's copy in shared memory (BULK), or from device memory (pass 1 with
// .cg, the write, J's last use, with .cs).
template <typename T, bool BULK>
__device__ __forceinline__ void load_j(const unsigned char* buf,
                                       const T* jt, int d, int rr, int c,
                                       float sc, bool last_use, float* x) {
  constexpr int VEC = BULK ? 4 : 1;
  using RawT = typename Raw<T, VEC>::type;
  RawT raw;
  if constexpr (BULK) {
    raw = *reinterpret_cast<const RawT*>(
        buf + ((long long)rr * d + c) * sizeof(T));
  } else {
    const RawT* p = reinterpret_cast<const RawT*>(jt + (long long)rr * d + c);
    raw = last_use ? __ldcs(p) : __ldcg(p);
  }
  decode<T, VEC>(raw, sc, x);
}

// How a thread covers a tile: row group g0 / RM (rows g0 .. g0 + RM - 1 of
// the tile) and the column chunks c = (ch * ct_n + ct) * VEC, ch < nch.
// The fp32 operand beside J (Vt in pass 1, Ut in the write) is the same for
// every tile of a run, so a thread loads its chunks of it once a run into
// the registers `opd`, for the first MAXCH chunks (at most 16 / R, so at
// most 64 floats; the rest are loaded with each tile).
template <int R, bool BULK>
struct Lanes {
  static constexpr int RM = Rows<R>::MAX;
  static constexpr int VEC = BULK ? 4 : 1;
  static constexpr int MAXCH = mkor_smw::max_chunks(R);
  int ct_n, g0, ct, nch;
  __device__ __forceinline__ Lanes(const Args& a) {
    ct_n = kThreads / a.groups;
    g0 = (int)threadIdx.x / ct_n * RM;
    ct = (int)threadIdx.x % ct_n;
    nch = (a.d + ct_n * VEC - 1) / (ct_n * VEC);
  }
  __device__ __forceinline__ int col(int ch) const {
    return (ch * ct_n + ct) * VEC;
  }
};

// Loads a run's operand chunks: rows 0 .. R-1 of `base` (row stride ld),
// an input (Vt, the read-only path) or scratch this launch wrote (Ut).
template <int R, bool BULK, bool INPUT>
__device__ __forceinline__ void load_operands(
    const Lanes<R, BULK>& ln, int d, const float* base, long long ld,
    float (&opd)[Lanes<R, BULK>::MAXCH][R][Lanes<R, BULK>::VEC]) {
  constexpr int VEC = Lanes<R, BULK>::VEC;
#pragma unroll
  for (int ch = 0; ch < Lanes<R, BULK>::MAXCH; ++ch) {
    const int c = ln.col(ch);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (ch < ln.nch && c < d) {
        if constexpr (INPUT)
          load_input<VEC>(base + i * ld + c, opd[ch][i]);
        else
          load_written<VEC>(base + i * ld + c, opd[ch][i]);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) opd[ch][i][q] = 0.0f;
      }
    }
  }
}

// The sums of one chunk of pass 1: acc[rr][i] += J[g0 + rr, c..] . Vt[i, c..]
template <typename T, int R, bool BULK>
__device__ __forceinline__ void pass1_chunk(
    const Lanes<R, BULK>& ln, const unsigned char* buf, const T* jt, int d,
    int nrow, int c, float sc, const float (&vv)[R][Lanes<R, BULK>::VEC],
    float* acc) {
  constexpr int RM = Lanes<R, BULK>::RM, VEC = Lanes<R, BULK>::VEC;
#pragma unroll
  for (int rr = 0; rr < RM; ++rr) {
    if (ln.g0 + rr < nrow) {
      float x[VEC];
      load_j<T, BULK>(buf, jt, d, ln.g0 + rr, c, sc, false, x);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[rr * R + i] += x[q] * vv[i][q];
    }
  }
}

// Pass 1 over the rows [row0, row0 + nrow) of a step's tile: U = J Vt^T
// for those rows, stored transposed, and its share of the run's partial of
// S = Vt U, stored with the run's last tile.
template <typename T, int R, bool BULK>
__device__ __forceinline__ void pass1_tile(
    const Args& a, const Step& st, const unsigned char* buf, Smem<R>& sm,
    Arrivals& arr,
    float (&opd)[Lanes<R, BULK>::MAXCH][R][Lanes<R, BULK>::VEC]) {
  using L = Lanes<R, BULK>;
  constexpr int RM = L::RM, VEC = L::VEC;
  const L ln(a);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d = a.d, b = st.slice;
  int row0, nrow;
  tile_rows(a, st.tile, row0, nrow);
  const T* jt = static_cast<const T*>(a.j) + ((long long)b * d + row0) * d;
  const float* vb = a.vt + (long long)b * R * d;
  const float sc = a.scale != nullptr ? a.scale[b] : 1.0f;
  const int lt0 = (st.tile - st.tile0) * a.rows;   // row of the run
  if (st.tile == st.tile0) {
    // the run's operands, and Vt at its rows for the S partial (read after
    // the barrier below)
    load_operands<R, BULK, true>(ln, d, vb, d, opd);
    int rrow0, rn;
    tile_rows(a, st.tile0, rrow0, rn);
    const int run_rows = d - rrow0 < st.ntiles * a.rows ? d - rrow0
                                                        : st.ntiles * a.rows;
    for (int e = tid; e < R * run_rows; e += kThreads)
      sm.vrow[e % run_rows][e / run_rows] =
          __ldg(vb + (long long)(e / run_rows) * d + rrow0 + e % run_rows);
  }

  float acc[RM * R];
#pragma unroll
  for (int i = 0; i < RM * R; ++i) acc[i] = 0.0f;
  // the same trip counts on every thread: the warp stays converged for the
  // shuffles below
#pragma unroll
  for (int ch = 0; ch < L::MAXCH; ++ch) {
    const int c = ln.col(ch);
    if (ch < ln.nch && c < d)
      pass1_chunk<T, R, BULK>(ln, buf, jt, d, nrow, c, sc, opd[ch], acc);
  }
  for (int ch = L::MAXCH; ch < ln.nch; ++ch) {
    const int c = ln.col(ch);
    if (c < d) {
      float vv[R][VEC];
#pragma unroll
      for (int i = 0; i < R; ++i) load_input<VEC>(vb + (long long)i * d + c,
                                                  vv[i]);
      pass1_chunk<T, R, BULK>(ln, buf, jt, d, nrow, c, sc, vv, acc);
    }
  }
  warp_sum<RM * R, 16>(acc, lane);
  if (lane % (32 / (RM * R)) == 0) sm.red[warp][lane * RM * R / 32] = acc[0];
  __syncthreads();
  if (warp == 0) {
    // row rr of the tile: its group's warps, summed in order
    const int wpg = ln.ct_n / 32;
    for (int e = lane; e < nrow * R; e += 32) {
      const int rr = e / R, k = e % R, g = rr / RM;
      float s = 0.0f;
      for (int w = g * wpg; w < (g + 1) * wpg; ++w)
        s += sm.red[w][(rr % RM) * R + k];
      sm.urow[rr][k] = s;
      a.ut[((long long)b * R + k) * a.dp + row0 + rr] = s;
    }
    __syncwarp();
    const bool last = st.tile == st.tile0 + st.ntiles - 1;
    for (int e = lane; e < R * R; e += 32) {
      const int i = e / R, k = e % R;
      float s = st.tile == st.tile0 ? 0.0f : sm.sacc[e];
      for (int rr = 0; rr < nrow; ++rr)
        s += sm.vrow[lt0 + rr][i] * sm.urow[rr][k];
      sm.sacc[e] = s;
      if (last)
        a.spart[((long long)b * a.runs + st.tile0 / a.run) * R * R + e] = s;
    }
    __syncwarp();                // the lanes' stores, then lane 0's release
    if (last && lane == 0) {     // thread 0
      arr.old[1] = atom_add_release(a.sync + 1 + b, 1u);
      arr.slice[1] = b;
    }
  }
}

// The write over the rows [row0, row0 + nrow) of a step's tile:
// out = alpha J + W U^T with W = U M for those rows.
template <typename T, typename TO, int R, bool BULK>
__device__ __forceinline__ void write_tile(
    const Args& a, const Step& st, const unsigned char* buf, Smem<R>& sm,
    Arrivals& arr,
    float (&opd)[Lanes<R, BULK>::MAXCH][R][Lanes<R, BULK>::VEC]) {
  using L = Lanes<R, BULK>;
  constexpr int RM = L::RM, VEC = L::VEC;
  const L ln(a);
  const int tid = threadIdx.x;
  const int d = a.d, b = st.slice;
  int row0, nrow;
  tile_rows(a, st.tile, row0, nrow);
  const float* ub = a.ut + (long long)b * R * a.dp;
  if (st.tile == st.tile0) {
    if (sm.ready_slice != b) {
      // the first write run of slice b in this block: settle what it owes,
      // acquire the flag and keep M (a wait lasts microseconds, the header
      // says why it ends; one of seconds is a fault, reported as one
      // instead of hanging the card)
      settle<R>(a, sm, arr);
      if (tid == 0) {
        const unsigned* ready = a.sync + 1 + a.batch + b;
        for (unsigned spins = 0; ld_acquire(ready) == 0u; ++spins) {
          if (spins == kMaxSpins) __trap();
          __nanosleep(128);
        }
      }
      __syncthreads();
      if (tid < R * R) sm.mmat[tid] = a.m[(long long)b * R * R + tid];
      if (tid == 0) sm.ready_slice = b;
      __syncthreads();
    }
    // W = U M at the run's rows, and the run's operands, loaded together
    load_operands<R, BULK, false>(ln, d, ub, a.dp, opd);
    const int run_rows = d - row0 < st.ntiles * a.rows ? d - row0
                                                       : st.ntiles * a.rows;
    for (int e = tid; e < run_rows * R; e += kThreads) {
      const int rr = e / R, k = e % R;
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < R; ++i)
        s += ub[(long long)i * a.dp + row0 + rr] * sm.mmat[i * R + k];
      sm.wrow[rr][k] = s;
    }
    __syncthreads();
  }
  const int lt0 = (st.tile - st.tile0) * a.rows;   // row of the run
  float w[RM][R];
#pragma unroll
  for (int rr = 0; rr < RM; ++rr)
#pragma unroll
    for (int k = 0; k < R; ++k)
      w[rr][k] = ln.g0 + rr < nrow ? sm.wrow[lt0 + ln.g0 + rr][k] : 0.0f;
  const float gm = a.gm != nullptr ? a.gm[b] : a.gm_all;
  const float alpha = a.variant == 0 ? gm : 1.0f / gm;
  const float sc = a.scale != nullptr ? a.scale[b] : 1.0f;
  const long long base = ((long long)b * d + row0) * d;
  const T* jt = static_cast<const T*>(a.j) + base;
  TO* ot = static_cast<TO*>(a.out) + base;
  auto chunk = [&](int c, const float (&uc)[R][VEC]) {
#pragma unroll
    for (int rr = 0; rr < RM; ++rr) {
      if (ln.g0 + rr < nrow) {
        float x[VEC];
        load_j<T, BULK>(buf, jt, d, ln.g0 + rr, c, sc, true, x);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          float t = 0.0f;
#pragma unroll
          for (int k = 0; k < R; ++k) t += w[rr][k] * uc[k][q];
          x[q] = alpha * x[q] + t;
        }
        store_out<TO, VEC>(x, ot + (long long)(ln.g0 + rr) * d + c);
      }
    }
  };
#pragma unroll
  for (int ch = 0; ch < L::MAXCH; ++ch) {
    const int c = ln.col(ch);
    if (ch < ln.nch && c < d) chunk(c, opd[ch]);
  }
  for (int ch = L::MAXCH; ch < ln.nch; ++ch) {
    const int c = ln.col(ch);
    if (c < d) {
      float uc[R][VEC];
#pragma unroll
      for (int k = 0; k < R; ++k)
        load_written<VEC>(ub + (long long)k * a.dp + c, uc[k]);
      chunk(c, uc);
    }
  }
}

// Thread 0: the step after the last one produced (tile pk of ticket pt),
// written to *slot, its copy started into buf (BULK); at a run's last tile
// the next ticket is taken into `next`, and used at the following step.
template <typename T, bool BULK>
__device__ __forceinline__ void produce(const Args& a, int n_tickets,
                                        unsigned char* buf, uint64_t* bar,
                                        Step* slot, int& pt, int& pk,
                                        int& next) {
  Step st = step_of(a, pt, pk, n_tickets);
  if (st.phase >= 0 && pk == st.ntiles) {     // the run is done
    pt = next;
    pk = 0;
    st = step_of(a, pt, pk, n_tickets);
  }
  *slot = st;
  if (st.phase < 0) return;
  if constexpr (BULK) fetch_tile<T>(a, st, buf, bar);
  if (pk == st.ntiles - 1) next = (int)atomicAdd(a.sync, 1u);
  ++pk;
}

// T: the bank's type; TO: the output's (T itself, or fp32 for int8).
// BULK: each tile's J arrives in shared memory by a bulk copy issued one
// tile ahead (16-byte rows); otherwise every element is loaded on its own.
template <typename T, typename TO, int R, bool BULK>
__global__ void __launch_bounds__(kThreads, 2)
block_smw_kernel(const Args a) {
  using L = Lanes<R, BULK>;
  __shared__ Smem<R> sm;
  extern __shared__ __align__(128) unsigned char tiles[];   // 2 x kTileBytes
  const int tid = threadIdx.x;
  const int n_tickets = 2 * a.batch * a.runs;
  // Thread 0 walks the tiles two steps ahead of the block: it writes each
  // step to the ring sm.steps and starts its copy.  It takes the next
  // ticket when it reaches the last tile of a run, a step before it needs
  // it, so that no atomic's latency stalls a tile and a block holds as few
  // tickets as it can (the tickets held past the end of the work decide
  // how ragged the end is).
  int pt = 0, pk = 0, next = 0;
  Arrivals arr{{-1, -1}, {0u, 0u}};
  if (tid == 0) {
    if constexpr (BULK) {
      mbar_init(&sm.bars[0]);
      mbar_init(&sm.bars[1]);
      fence_mbar_init();
    }
    sm.ready_slice = -1;
    pt = (int)atomicAdd(a.sync, 1u);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      produce<T, BULK>(a, n_tickets, tiles + k * kTileBytes, &sm.bars[k],
                       &sm.steps[k], pt, pk, next);
  }
  __syncthreads();
  float opd[L::MAXCH][R][L::VEC] = {};   // a run's operands (Lanes)
  for (int i = 0;; ++i) {
    const Step st = sm.steps[i % 3];
    if (st.phase < 0) break;
    const int cur = i & 1;
    unsigned char* buf = tiles + cur * kTileBytes;
    // buffer cur is filled at iterations cur, cur + 2, ...: parity i / 2
    if constexpr (BULK) mbar_wait(&sm.bars[cur], (unsigned)(i >> 1) & 1u);
    if (st.phase == 0)
      pass1_tile<T, R, BULK>(a, st, buf, sm, arr, opd);
    else
      write_tile<T, TO, R, BULK>(a, st, buf, sm, arr, opd);
    if (tid == 0) {
      sm.mid = arr.slice[0] >= 0 && arr.old[0] == (unsigned)a.runs - 1u
                   ? arr.slice[0] : -1;
      arr.slice[0] = arr.slice[1];
      arr.old[0] = arr.old[1];
      arr.slice[1] = -1;
    }
    __syncthreads();          // buf and sm are free; sm.steps[i % 3] read
    if (tid == 0)
      produce<T, BULK>(a, n_tickets, buf, &sm.bars[cur],
                       &sm.steps[(i + 2) % 3], pt, pk, next);
    if (sm.mid >= 0) {
      __threadfence();
      form_mid<R>(a, sm.mid, sm);
    }
  }
  settle<R>(a, sm, arr);      // the last pass-1 run's arrival
}

// Launches the kernel over the bank of `a`, its lag reckoned from the
// blocks the card holds at once; with `resident` non-null it only writes
// that number there (mkor_block_smw_resident).
template <typename T, typename TO, int R, bool BULK>
int launch(Args a, cudaStream_t stream, long long* resident) {
  constexpr int kDevices = 64;
  // blocks an SM holds, per device (the shared-memory attribute is set on
  // each device the kernel first runs on)
  static int per_sm[kDevices] = {};
  const int smem = BULK ? 2 * kTileBytes : 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int held = dev < kDevices ? per_sm[dev] : 0;
  if (held == 0) {
    err = cudaFuncSetAttribute(block_smw_kernel<T, TO, R, BULK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &held, block_smw_kernel<T, TO, R, BULK>, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (held < 1) return (int)cudaErrorInvalidConfiguration;
    if (dev < kDevices) per_sm[dev] = held;
  }
  const long long blocks = (long long)sms * held;
  if (resident) {
    *resident = blocks;
    return (int)cudaSuccess;
  }
  a.lag = mkor_smw::plan_lag(a.batch, a.runs, blocks);
  const long long tickets = 2LL * a.batch * a.runs;
  const int grid = (int)(tickets < blocks ? tickets : blocks);
  block_smw_kernel<T, TO, R, BULK><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename TO, int R>
int dispatch_path(const Args& a, int vec, cudaStream_t stream,
                  long long* resident, int* path) {
  Args b = a;
  b.groups = 1;                     // 1, 2, 4 or 8 row groups
  while (b.groups * Rows<R>::MAX < b.rows) b.groups *= 2;
  // the bulk path needs 16-byte rows and a tile that fits its buffer
  const bool bulk = mkor_smw::bulk_tiles(a.rows, a.d, (int)sizeof(T), vec);
  if (path) *path = bulk ? 1 : 0;
  return bulk ? launch<T, TO, R, true>(b, stream, resident)
              : launch<T, TO, R, false>(b, stream, resident);
}

template <typename T, typename TO>
int dispatch(int rank, const Args& a, int vec, cudaStream_t stream,
             long long* resident, int* path) {
  switch (rank) {
    case 1: return dispatch_path<T, TO, 1>(a, vec, stream, resident, path);
    case 2: return dispatch_path<T, TO, 2>(a, vec, stream, resident, path);
    case 4: return dispatch_path<T, TO, 4>(a, vec, stream, resident, path);
    case 8: return dispatch_path<T, TO, 8>(a, vec, stream, resident, path);
    case 16:
      return dispatch_path<T, TO, 16>(a, vec, stream, resident, path);
    default: return (int)cudaErrorInvalidValue;
  }
}

long long padded(int d) { return mkor_smw::padded_cols(d); }

// Plans the launch over the bank and launches the kernel on `stream` or,
// with `resident` non-null, writes there the blocks the card holds at once.
// `path`, where non-null, receives the tile path taken: 1 bulk, 0 element.
int plan_and_launch(const void* j, const float* vt, const float* gm,
                    float gm_all, float vweight, const float* scale,
                    void* out, float* work, int* sync, float* piv, int d,
                    int batch, int rank, int r_real, int j_type, int vec,
                    int variant, void* stream, long long* resident,
                    int* path) {
  static const int kItemsize[3] = {2, 4, 1};
  if (d < 1 || batch < 1 || rank < 1 || j_type < 0 || j_type > 2)
    return (int)cudaErrorInvalidValue;
  const mkor_smw::Plan p = mkor_smw::make_plan(d, rank, kItemsize[j_type]);
  Args a;
  a.j = j; a.vt = vt; a.gm = gm; a.scale = scale; a.out = out;
  a.ut = work;
  a.spart = a.ut + (long long)batch * rank * padded(d);
  a.m = a.spart + (long long)batch * p.runs * rank * rank;
  a.piv = piv;
  a.sync = reinterpret_cast<unsigned*>(sync);
  a.gm_all = gm_all; a.vweight = vweight;
  a.d = d; a.dp = (int)padded(d); a.batch = batch; a.rows = p.rows;
  a.tiles = p.tiles; a.run = p.run; a.runs = p.runs; a.lag = 0;
  a.r_real = r_real; a.variant = variant;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (j_type) {
    case 0:
      return dispatch<__nv_bfloat16, __nv_bfloat16>(rank, a, vec, s,
                                                    resident, path);
    case 1: return dispatch<float, float>(rank, a, vec, s, resident, path);
    default:
      return dispatch<int8_t, float>(rank, a, vec, s, resident, path);
  }
}

}  // namespace

// j: (batch, d, d) of type j_type (0 bf16, 1 fp32, 2 int8); out: the same
// shape in j's type, or fp32 for int8 (then scale is the (batch,) fp32
// per-slice scale, else null).  vt: (batch, rank, d) fp32 (rows beyond
// r_real zero); gm: (batch,) fp32, or null for gm_all on every slice;
// vweight: w above; work: mkor_block_smw_work(d, batch, rank, itemsize of
// j_type) fp32; sync: 1 + 2 * batch int32, zero; piv: (batch,) fp32 or
// null (then no pivot is written).  out may equal j when the types agree.
// rank is 1, 2, 4, 8 or 16.  vec: 1 when J's and out's rows are 16-byte
// multiples on 16-byte bases and vt is 16-byte aligned.  variant: 0 =
// paper, 1 = exact_smw.  The tiles and runs come from mkor_smw::make_plan,
// the lag from mkor_smw::plan_lag and the blocks the card holds at once.
// *path receives the tile path the launch took: 1 when J's tiles arrive by
// bulk copies, 0 when they are loaded element by element
// (mkor_smw::bulk_tiles).
extern "C" int mkor_fused_block_smw(const void* j, const float* vt,
                                    const float* gm, float gm_all,
                                    float vweight, const float* scale,
                                    void* out, float* work, int* sync,
                                    float* piv, int d, int batch, int rank,
                                    int r_real, int j_type, int vec,
                                    int variant, void* stream, int* path) {
  return plan_and_launch(j, vt, gm, gm_all, vweight, scale, out, work, sync,
                         piv, d, batch, rank, r_real, j_type, vec, variant,
                         stream, nullptr, path);
}

// The blocks of a launch of mkor_fused_block_smw with these arguments that
// the current device holds at once, into *out (the `resident` of
// mkor_block_smw_plan); returns a CUDA error code.
extern "C" int mkor_block_smw_resident(int d, int batch, int rank,
                                       int j_type, int vec, long long* out) {
  return plan_and_launch(nullptr, nullptr, nullptr, 1.0f, 1.0f, nullptr,
                         nullptr, nullptr, nullptr, nullptr, d, batch, rank,
                         rank, j_type, vec, 0, nullptr, out, nullptr);
}
