// The launch plan of the persistent SMW kernel (block_smw.cu): how a bank
// is cut into tiles, runs and tickets, how far the writes trail pass 1, and
// the order in which the tickets name the runs.  It is plain C++ (host and
// device code under nvcc), so a host compiler builds it too: with
// MKOR_SMW_PLAN_ENTRIES defined it also defines the C entries
// mkor_block_smw_plan, mkor_block_smw_ticket, mkor_block_smw_work and
// mkor_block_smw_bulk, which block_smw.cu's library exports and the CPU
// tests (and the kernel plans of kernels/ops.py) build from this file alone
// (g++ -x c++ -shared -fPIC -DMKOR_SMW_PLAN_ENTRIES smw_plan.cuh).
#ifndef MKOR_SMW_PLAN_CUH
#define MKOR_SMW_PLAN_CUH

#ifdef __CUDACC__
#define MKOR_HD __host__ __device__
#else
#define MKOR_HD
#endif

namespace mkor_smw {

constexpr int kThreads = 256;              // threads a block
constexpr int kTileBytes = 32 * 1024;      // J a tile holds on the bulk path
constexpr int kMaxTileRows = 32;           // rows a run covers at most
// Tickets a resident block holds at once, at most: the run it works on,
// the next run, and the one after it while a run's last tile is copied;
// one more gives the slice's last arrival the time to form M.
constexpr int kTicketsHeld = 4;

// The most rows a thread covers at rank R: it keeps R fp32 sums for each,
// at most 16 of them (and at most 8 rows), which keeps the kernel within
// the 128 registers that two blocks an SM leave a thread.  A tile of more
// rows splits its threads into row groups of that many rows.
MKOR_HD constexpr int max_rows(int rank) {
  return 16 / rank < 8 ? (16 / rank > 0 ? 16 / rank : 1) : 8;
}

// The 4-column chunks of a run's fp32 operand a thread keeps in registers
// at rank R: at most 16 / R (64 floats), at most 4.
MKOR_HD constexpr int max_chunks(int rank) {
  return 16 / rank < 1 ? 1 : (16 / rank > 4 ? 4 : 16 / rank);
}

// rows of J a tile (one bulk copy), tiles a slice, tiles a run (a ticket),
// runs a slice.
struct Plan {
  int rows, tiles, run, runs;
};

// A tile holds whole rows, at most kTileBytes of J, and at most as many as
// 8 row groups cover while each thread's columns fit max_chunks(rank)
// chunks; a run covers up to kMaxTileRows rows, whose operands a block
// loads once.
inline Plan make_plan(int d, int rank, int itemsize) {
  int groups = 8;
  while (groups > 1 && (kThreads / groups) * 4 * max_chunks(rank) < d)
    groups /= 2;
  long long rows = groups * max_rows(rank);
  if (rows > kMaxTileRows) rows = kMaxTileRows;
  const long long fit = kTileBytes / ((long long)d * itemsize);
  if (fit < rows) rows = fit < 1 ? 1 : fit;
  Plan p;
  p.rows = (int)rows;
  p.tiles = (int)((d + rows - 1) / rows);
  p.run = kMaxTileRows / p.rows;
  p.runs = (p.tiles + p.run - 1) / p.run;
  return p;
}

// Columns of a slice's rows of Ut in the scratch: d rounded up to 32, so
// that each slice's rows start on a 128-byte line.
inline long long padded_cols(int d) { return (d + 31) / 32 * 32; }

// Floats of scratch one launch needs: Ut (batch, rank, dp), the S partials
// (batch, runs, rank^2) and M (batch, rank^2).
inline long long work_floats(int d, int batch, int rank, int itemsize) {
  const long long runs = make_plan(d, rank, itemsize).runs;
  return (long long)batch * rank * (padded_cols(d) + runs * rank + rank);
}

// A tile arrives by one bulk copy when J's rows are 16-byte multiples on
// 16-byte bases (vec) and the tile fits its buffer; otherwise the kernel
// loads J element by element (a bf16 row wider than 16384 elements alone
// overfills the buffer).
inline bool bulk_tiles(int rows, int d, int itemsize, int vec) {
  return vec && (long long)rows * d * itemsize <= kTileBytes;
}

// Pass-1 runs before the first write run, for `resident` blocks on the
// card: a slice's writes come more tickets after its pass 1 than the
// blocks hold at once, so that its M is formed before they are taken and
// no write waits (never fewer than a slice's runs, so a slice's pass 1
// always comes before its writes).
inline int plan_lag(int batch, int runs, long long resident) {
  const long long n = (long long)batch * runs;
  const long long lag = runs + kTicketsHeld * resident;
  return (int)(lag < n ? lag : n);
}

// A ticket names a run: up to `run` consecutive tiles of one slice, for
// pass 1 (phase 0: U, S) or for the write (phase 1).  Of the n = batch *
// runs runs of each pass (slice by slice, rows in order), the first `lag`
// pass-1 runs come alone; then write and pass-1 runs alternate; the writes
// left over come last.  So the write of a run comes at least lag - runs + 1
// tickets after the last pass-1 run of its slice.
struct Run {
  int phase, slice, run;
};

MKOR_HD inline Run decode_ticket(int t, int batch, int runs, int lag) {
  const int n = batch * runs;
  int phase = 0, k = t;
  if (t >= lag) {
    const int u = t - lag;
    if (u < 2 * (n - lag)) {
      phase = u % 2 == 0;
      k = phase ? u / 2 : lag + u / 2;
    } else {
      phase = 1;
      k = u - (n - lag);
    }
  }
  return Run{phase, k / runs, k % runs};
}

}  // namespace mkor_smw

#ifdef MKOR_SMW_PLAN_ENTRIES
// The plan of a (batch, d, d) bank of itemsize-byte elements at kernel
// rank `rank` with `resident` blocks on the card: out[0..4] = rows, tiles,
// run, runs, lag.
extern "C" void mkor_block_smw_plan(int d, int batch, int rank, int itemsize,
                                    long long resident, int* out) {
  const mkor_smw::Plan p = mkor_smw::make_plan(d, rank, itemsize);
  out[0] = p.rows; out[1] = p.tiles; out[2] = p.run; out[3] = p.runs;
  out[4] = mkor_smw::plan_lag(batch, p.runs, resident);
}

// Floats of scratch a launch of mkor_fused_block_smw needs (work_floats).
extern "C" long long mkor_block_smw_work(int d, int batch, int rank,
                                         int itemsize) {
  if (d < 1 || rank < 1 || itemsize < 1) return 0;
  return mkor_smw::work_floats(d, batch, rank, itemsize);
}

// 1 when a launch on a (d, d) bank of itemsize-byte elements at kernel rank
// `rank` copies its tiles in bulk, 0 when it loads J element by element.
extern "C" int mkor_block_smw_bulk(int d, int rank, int itemsize, int vec) {
  const mkor_smw::Plan p = mkor_smw::make_plan(d, rank, itemsize);
  return mkor_smw::bulk_tiles(p.rows, d, itemsize, vec) ? 1 : 0;
}

// The run ticket t names, as the kernel decodes it: out[0..2] = pass,
// slice, run.
extern "C" void mkor_block_smw_ticket(int t, int batch, int runs, int lag,
                                      int* out) {
  const mkor_smw::Run r = mkor_smw::decode_ticket(t, batch, runs, lag);
  out[0] = r.phase; out[1] = r.slice; out[2] = r.run;
}
#endif

#endif  // MKOR_SMW_PLAN_CUH
