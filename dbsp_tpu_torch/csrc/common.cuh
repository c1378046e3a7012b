// Shared pieces of the port's hand-written Hopper kernels: the argument
// block every launch takes, the lexicographic searches of sorted levels
// that replace the Pallas `_lex_search` (dbsp_tpu/zset/pallas_kernels.py:102)
// (a lower bound, then a gallop over the run of rows equal to the query),
// a block-wide scan, and the run-wise fold of the aggregate vocabulary
// that segment reduce and the fused aggregate chain (agg_ladder.cu) share.
//
// Every kernel reads (and writes) each column at its own width, with its
// `ColKind` in the argument block; it widens every value to int64 as it
// loads it, so its compares and sums are the same int64 ones.
// Pointers and small integers travel in one argument block
// of int64 slots; each wrapper documents its own slot layout. Kernels are
// templates over where the block lives:
//   * `Args`: BY VALUE as a kernel parameter, for up to ARGS_MAX slots (no
//     host-to-device copy and no sync per launch);
//   * `ArgTable`: a device-resident copy of any number of slots, for wider
//     ladders (the wrapper uploads it asynchronously from pinned memory).
// A launcher takes the host slots, their count and an optional device
// table, and instantiates the kernel for the one that is given.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

typedef long long i64;
typedef unsigned long long u64;

// 448 slots = 3,584 bytes, under the 4,096-byte kernel-parameter limit
// together with the scalar parameters. A launch with more slots takes the
// device table instead.
#define ARGS_MAX 448
// widest row a search compares (key columns, or all columns of a merge)
#define MAX_COLS 16

struct Args {
  i64 v[ARGS_MAX];
  __device__ __forceinline__ i64 operator[](int i) const { return v[i]; }
};

struct ArgTable {
  const i64* v;
  __device__ __forceinline__ i64 operator[](int i) const { return v[i]; }
};

// The by-value block of `n` host slots (n <= ARGS_MAX, which the wrapper
// guarantees by passing a device table above it).
static inline Args args_by_value(const i64* host, int n) {
  Args a;
  std::memcpy(a.v, host, static_cast<size_t>(n) * sizeof(i64));
  return a;
}

template <class A>
__device__ __forceinline__ const void* col_ptr(const A& a, int slot) {
  return reinterpret_cast<const void*>(a[slot]);
}

template <class A>
__device__ __forceinline__ i64* out_col(const A& a, int slot) {
  return reinterpret_cast<i64*>(a[slot]);
}

// Element type of a column read or written at its own width (the
// wrapper's `_KINDS`). Bool and uint8 load unsigned; a bool store writes
// v != 0, as a cast to bool does; the others truncate, as an integer
// cast does.
enum ColKind {
  KIND_I64 = 0,
  KIND_I32 = 1,
  KIND_I16 = 2,
  KIND_I8 = 3,
  KIND_U8 = 4,
  KIND_BOOL = 5
};

// int64 first, by one compare: the loads of a search are a dependent chain
__device__ __forceinline__ i64 load_widened(const void* p, int kind,
                                            i64 i) {
  if (kind == KIND_I64) return static_cast<const i64*>(p)[i];
  switch (kind) {
    case KIND_I32: return static_cast<const int*>(p)[i];
    case KIND_I16: return static_cast<const short*>(p)[i];
    case KIND_I8: return static_cast<const signed char*>(p)[i];
    default: return static_cast<const unsigned char*>(p)[i];  // U8, BOOL
  }
}

__device__ __forceinline__ void store_narrowed(void* p, int kind, i64 i,
                                               i64 v) {
  if (kind == KIND_I64) {
    static_cast<i64*>(p)[i] = v;
    return;
  }
  switch (kind) {
    case KIND_I32: static_cast<int*>(p)[i] = static_cast<int>(v); break;
    case KIND_I16: static_cast<short*>(p)[i] = static_cast<short>(v); break;
    case KIND_I8:
      static_cast<signed char*>(p)[i] = static_cast<signed char>(v);
      break;
    case KIND_U8:
      static_cast<unsigned char*>(p)[i] = static_cast<unsigned char>(v);
      break;
    default: static_cast<unsigned char*>(p)[i] = v != 0;  // BOOL
  }
}

template <class A>
__device__ __forceinline__ i64 col_at(const A& a, int slot, int kind_slot,
                                      i64 row) {
  return load_widened(col_ptr(a, slot), static_cast<int>(a[kind_slot]),
                      row);
}

// Sign of table row `row` minus the query `q`, lexicographic over `ncols`
// columns: table column c in slot t0 + c * ts, its ColKind in slot tk + c.
template <class A>
__device__ __forceinline__ int cmp_row(const A& a, int t0, int ts, int tk,
                                       int ncols, i64 row, const i64* q) {
  for (int c = 0; c < ncols; ++c) {
    const i64 v = col_at(a, t0 + c * ts, tk + c, row);
    if (v != q[c]) return v < q[c] ? -1 : 1;
  }
  return 0;
}

// Insertion point of `q` into the sorted table rows [lo, hi) (table as for
// cmp_row): STRICT counts the rows < q (side "left"), otherwise the rows
// <= q (side "right"). On [0, n) it equals the fixed-step search of the
// reference bit for bit; on [lo, hi) it is the full search's answer
// clamped into [lo, hi].
template <bool STRICT, class A>
__device__ i64 search_rows(const A& a, int t0, int ts, int tk, int ncols,
                           i64 lo, i64 hi, const i64* q) {
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    const int cmp = cmp_row(a, t0, ts, tk, ncols, mid, q);
    if (STRICT ? cmp < 0 : cmp <= 0) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The rows [*lo_out, *lo_out + count) of a sorted table of n rows equal to
// the key `q`; returns count. A lower-bound search, then, since every row
// from there on is >= q (so <= q iff equal), a gallop over the run of
// equal rows and a search of its last gap: one load where no row equals
// q, two where one does (a consolidated level), and exact for any run.
template <class A>
__device__ i64 equal_range(const A& a, int t0, int ts, int tk, int ncols,
                           i64 n, const i64* q, i64* lo_out) {
  const i64 lo = search_rows<true>(a, t0, ts, tk, ncols, 0, n, q);
  *lo_out = lo;
  if (lo >= n || cmp_row(a, t0, ts, tk, ncols, lo, q) != 0) return 0;
  i64 b = lo + 1, e = n;  // the run's end lies in [b, e]
  for (i64 step = 1; b < e; step <<= 1) {
    const i64 probe = min(b + step - 1, e - 1);
    if (cmp_row(a, t0, ts, tk, ncols, probe, q) != 0) {
      e = probe;
      break;
    }
    b = probe + 1;
  }
  while (b < e) {  // rows before b equal q, rows from e on do not
    const i64 mid = (b + e) >> 1;
    if (cmp_row(a, t0, ts, tk, ncols, mid, q) == 0) b = mid + 1;
    else e = mid;
  }
  return b - lo;
}

// Exclusive block-wide scan of one int64 per thread of a THREADS-thread
// block; `*total` gets the block's sum. Every thread of the block calls
// it (it syncs twice); `warp_sums` is THREADS / 32 shared slots.
template <int THREADS>
__device__ __forceinline__ i64 block_scan(i64 x, i64* warp_sums,
                                          i64* total) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  i64 incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const i64 y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  __syncthreads();  // the last call has read warp_sums
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  i64 before = 0, all = 0;
#pragma unroll
  for (int v = 0; v < WARPS; ++v) {
    const i64 s = warp_sums[v];
    if (v < warp) before += s;
    all += s;
  }
  *total = all;
  return before + incl - x;
}

// Walks the elements e = c * n + r of an [nc][n] block that one thread of
// the block visits, e = threadIdx.x, + blockDim.x, ..., keeping (c, r)
// without a division per element.
struct BlockWalk {
  int n, c, r, dc, dr;
  __device__ __forceinline__ explicit BlockWalk(int n_) : n(n_) {
    c = threadIdx.x / n;
    r = threadIdx.x - c * n;
    dc = blockDim.x / n;
    dr = blockDim.x - dc * n;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    r += dr;
    if (r >= n) {
      r -= n;
      ++c;
    }
  }
};

// dst[c * n + r] = value(c, r) for c < nc, r < n, by the whole block:
// each thread issues BATCH loads before it stores any of them, so it keeps
// BATCH loads in flight rather than waiting on each in turn.
template <int BATCH, class F>
__device__ __forceinline__ void stage_batched(i64* dst, int nc, int n,
                                              F value) {
  const int total = nc * n, step = blockDim.x;
  BlockWalk w(n);
  for (int base = threadIdx.x; base < total; base += step * BATCH) {
    i64 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (base + u * step < total) v[u] = value(w.c, w.r);
      w.next();
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (base + u * step < total) dst[base + u * step] = v[u];
  }
}

// int64 products and sums wrap in the reference (two's complement); signed
// overflow is undefined in C++, so they are done in unsigned arithmetic.
__device__ __forceinline__ i64 wrap_mul(i64 x, i64 y) {
  return static_cast<i64>(static_cast<u64>(x) * static_cast<u64>(y));
}

__device__ __forceinline__ i64 wrap_add(i64 x, i64 y) {
  return static_cast<i64>(static_cast<u64>(x) + static_cast<u64>(y));
}

__device__ __forceinline__ i64 wrap_neg(i64 x) {
  return static_cast<i64>(0ull - static_cast<u64>(x));
}

// Python's floor division (what `//` on int64 is in the reference)
__device__ __forceinline__ i64 floor_div(i64 x, i64 y) {
  i64 q = x / y;
  if ((x % y != 0) && ((x < 0) != (y < 0))) --q;
  return q;
}

// avg's finish: where(s >= 0, s // c, -((-s) // c)) for c >= 1, truncation
// toward zero, with the reference's wrap at s == INT64_MIN kept exact
__device__ __forceinline__ i64 avg_div(i64 sum, i64 c) {
  return sum >= 0 ? sum / c : wrap_neg(floor_div(wrap_neg(sum), c));
}

static inline unsigned int blocks_for(i64 n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

// ---------------------------------------------------------------------------
// The aggregate vocabulary and its run-wise fold
// ---------------------------------------------------------------------------
//
// Per segment: count = sum max(w, 0); sum = sum v * max(w, 0); min/max over
// the rows with w > 0, the op's identity where there are none; avg = sum /
// max(count, 1) truncated toward zero; present = max over every row of
// (w > 0), int64-min where the segment is empty.

// the spec's opcodes (SEG_OPS in zset/cuda_kernels.py); WSUM is avg's
// weight sum and NOP fills a pass's unused op
enum Op { COUNT = 0, SUM = 1, MIN = 2, MAX = 3, AVG = 4, PRESENT = 5,
          WSUM = 6, NOP = 7 };

// One op of a pass: its code, source column, identity (the partial that
// makes no atomic) and int64 output.
struct OpRef {
  int code;
  int col;
  i64 ident;
  i64* out;
};

__device__ __forceinline__ bool reads_value(int code) {
  return code == SUM || code == AVG || code == MIN || code == MAX;
}

// what one row adds to its run's partial
__device__ __forceinline__ i64 contrib(const OpRef& op, i64 v, i64 w) {
  const i64 wpos = w > 0 ? w : 0;
  switch (op.code) {
    case SUM:
    case AVG:  // the sum now; the finish divides
      return wrap_mul(v, wpos);
    case MIN:
    case MAX:
      return w > 0 ? v : op.ident;
    case PRESENT:
      return w > 0;
    case NOP:
      return 0;
    default:  // COUNT, WSUM
      return wpos;
  }
}

__device__ __forceinline__ i64 combine(int code, i64 x, i64 y) {
  if (code == MIN) return x < y ? x : y;
  if (code == MAX || code == PRESENT) return x > y ? x : y;
  return wrap_add(x, y);
}

// fold one run's partial into its segment's output
__device__ __forceinline__ void flush(const OpRef& op, i64 s, i64 x) {
  if (x == op.ident) return;  // the atomic would change nothing
  i64* p = op.out + s;
  if (op.code == MIN)
    atomicMin(p, x);
  else if (op.code == MAX || op.code == PRESENT)
    atomicMax(p, x);
  else
    atomicAdd(reinterpret_cast<u64*>(p), static_cast<u64>(x));
}

// consecutive rows a thread of the run-wise fold holds
constexpr int RUN_ITEMS = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr i64 DROPPED = -1;  // the id of a dropped row, and of rows past n
constexpr i64 NO_ROW = -2;   // the id beside a tile's edge

// rows r0 .. r0 + RUN_ITEMS - 1 of a column at its own width, widened;
// rows at or past n read as 0. A whole stretch of int64 or int32 at a
// 16-byte aligned address is one or two vector loads.
__device__ __forceinline__ void load_rows(const void* p, int kind, i64 r0,
                                          i64 n, i64 (&out)[RUN_ITEMS]) {
  static_assert(RUN_ITEMS == 4, "the vector loads take four rows");
  if (r0 + RUN_ITEMS <= n) {
    if (kind == KIND_I64) {
      const i64* q = static_cast<const i64*>(p) + r0;
      if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
        const longlong2 x = reinterpret_cast<const longlong2*>(q)[0];
        const longlong2 y = reinterpret_cast<const longlong2*>(q)[1];
        out[0] = x.x, out[1] = x.y, out[2] = y.x, out[3] = y.y;
        return;
      }
    } else if (kind == KIND_I32) {
      const int* q = static_cast<const int*>(p) + r0;
      if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
        const int4 x = reinterpret_cast<const int4*>(q)[0];
        out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
        return;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RUN_ITEMS; ++i)
    out[i] = r0 + i < n ? load_widened(p, kind, r0 + i) : 0;
}

// Shared memory of one fold_runs pass.
template <int G, int THREADS>
struct RunScan {
  i64 warp_sum[G][THREADS / 32];
  int warp_flag[THREADS / 32];
};

// One pass of the run-wise segmented reduction over a tile of
// THREADS x RUN_ITEMS consecutive rows, for G ops at once. Each thread
// holds the ids `id` of its RUN_ITEMS rows (DROPPED: the row is dropped;
// a dropped row breaks a run) and the rows' contributions `c`, and knows
// the ids of the rows just before and just after its stretch in the tile
// (`before_id`, `after_id`; NO_ROW at the tile's edges). A thread folds
// its rows run by run (a run: consecutive rows with one id) and flushes
// the runs it holds whole at once. Its last run's partial goes through a
// segmented scan, across the warp with __shfl_up_sync and across the
// block's warps through shared memory, so that every thread learns the
// partial of the run its stretch continues; the thread that holds a
// run's last row of the tile flushes the run: one atomic per op per run
// in a tile, not one per row, and a run cut by a tile edge makes one
// atomic in each tile. Every thread of the block calls it (it syncs).
template <int G, int THREADS>
__device__ __forceinline__ void fold_runs(const i64 (&id)[RUN_ITEMS],
                                          i64 before_id, i64 after_id,
                                          const OpRef (&op)[G],
                                          const i64 (&c)[G][RUN_ITEMS],
                                          RunScan<G, THREADS>& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool multi = false;  // the stretch holds more than one run
#pragma unroll
  for (int i = 1; i < RUN_ITEMS; ++i) multi |= id[i] != id[i - 1];
  // the stretch's first run continues the run before it
  const bool cont = id[0] == before_id;
  const i64 tail_id = id[RUN_ITEMS - 1];
  // fold the stretch run by run: `head` is its first run's partial, `s`
  // the current run's; runs held whole are written at once
  i64 head[G], s[G];
  bool broke = false;
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = head[g] = c[g][0];
#pragma unroll
  for (int i = 1; i < RUN_ITEMS; ++i) {
    if (id[i] == id[i - 1]) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = combine(op[g].code, s[g], c[g][i]);
      continue;
    }
    if (!broke) {
#pragma unroll
      for (int g = 0; g < G; ++g) head[g] = s[g];
      broke = true;
    } else if (id[i - 1] >= 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) flush(op[g], id[i - 1], s[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = c[g][i];
  }
  // segmented inclusive scan of the last runs' partials over the warp: a
  // flagged lane (a scan segment starts at its last run) starts anew
  int flag = multi || !cont;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int f = __shfl_up_sync(FULL_MASK, flag, d);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const i64 x = __shfl_up_sync(FULL_MASK, s[g], d);
      if (lane >= d && !flag) s[g] = combine(op[g].code, x, s[g]);
    }
    if (lane >= d) flag |= f;
  }
  // ... and over the block's warps: `carry` is the scan's value at the
  // last lane of the warp before
  __syncthreads();  // the previous pass has read warp_sum
  if (lane == 31) {
    sm.warp_flag[warp] = flag;
#pragma unroll
    for (int g = 0; g < G; ++g) sm.warp_sum[g][warp] = s[g];
  }
  __syncthreads();
  i64 carry[G];
#pragma unroll
  for (int g = 0; g < G; ++g) carry[g] = op[g].ident;
  for (int v = warp - 1; v >= 0; --v) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      carry[g] = combine(op[g].code, sm.warp_sum[g][v], carry[g]);
    if (sm.warp_flag[v]) break;
  }
  // `before`: the partial of the run that holds the row before this
  // stretch, up to that row
  i64 before[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (!flag) s[g] = combine(op[g].code, carry[g], s[g]);
    const i64 x = __shfl_up_sync(FULL_MASK, s[g], 1);
    before[g] = lane == 0 ? carry[g] : x;
  }
  // the first run ends in this stretch when it holds another run
  if (multi && id[0] >= 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      flush(op[g], id[0],
            cont ? combine(op[g].code, before[g], head[g]) : head[g]);
  }
  // the last run ends here when the next row is another id
  if (after_id != tail_id && tail_id >= 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) flush(op[g], tail_id, s[g]);
  }
}
