// Segment reduction over the aggregate vocabulary: count, sum, min, max,
// avg and present, the whole spec in one call.
//
// Replaces the Pallas `_segment_reduce_kernel` behind
// `segment_reduce_pallas` (dbsp_tpu/zset/pallas_kernels.py:392-462).
// Per segment id: count = sum max(w, 0); sum = sum v * max(w, 0); min/max
// over the rows with w > 0, the identity where there are none; avg =
// sum / max(count, 1) truncated toward zero; present = max over EVERY row
// of the segment of (w > 0), int64-min where the segment is empty. Ids
// outside [0, num_segments) are dropped.
//
// What bounds it on an H100: bytes. It reads n rows once (the segment ids,
// the weights and the value columns the spec names, each at its own
// width) and writes nseg values per op. The second limit is the atomics:
// on the main path the ids arrive sorted or nearly so (a gathered part's
// query rows, a consolidated delta's run ids, one trash segment for every
// dead row), so one atomic per row would put a warp's 32 lanes on one
// address and serialise them in L2.
//
// Design: a run-wise segmented reduction. A block takes a tile of TILE
// consecutive rows, each thread a stretch of ITEMS of them (vector loads
// where the stretch is aligned), every value widened once in registers.
// A thread folds its rows run by run (a run: consecutive rows with one
// id); the runs it holds whole are written at once. Its last run's
// partial goes through a segmented scan, across the warp with
// __shfl_up_sync and across the block's warps through shared memory, so
// that every thread learns the partial of the run its stretch continues.
// The thread that holds a run's last row of the tile makes the run's
// atomic: one per op per run in a tile, not one per row. A run cut by a
// tile edge makes one atomic in each tile, and with random ids every run
// has one row, so the result is exact on any order of ids. Sums and counts
// add in u64 (atomicAdd on unsigned long long wraps exactly like the
// reference's int64 sums); min and max take only rows with w > 0; a
// partial equal to the op's identity makes no atomic. An out-of-range id
// breaks a run and is dropped. The ops are reduced G at a time, one pass
// over the tile's rows per G ops (the main path's Max + present, or
// Count + present, in one pass); avg's weight sum is one more op.
// Launches: fill each output with its op's identity, the rows kernel, and
// only when the spec has an avg, one thread per segment to finish it.
//
// Argument block (nv value columns, nops ops):
//   [c] value column c (c < nv); [nv] weights; [nv + 1] segment ids
//   [nv + 2 + 3*o + {0,1,2}] op o: opcode, source column, identity
//   [nv + 2 + 3*nops + o] output of op o (int64)
//   [nv + 2 + 4*nops + c] ColKind of column c (c <= nv + 1: the value
//                         columns, then the weights, then the ids)
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;  // consecutive rows per thread
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr int G = 2;  // ops reduced per pass over a tile
// blocks per SM the register budget must allow (85 registers a thread)
constexpr int MIN_BLOCKS = 3;
constexpr unsigned FULL = 0xffffffffu;
// the spec's opcodes (SEG_OPS in zset/cuda_kernels.py); WSUM is avg's
// weight sum and NOP fills the last pass's unused op
enum Op { COUNT = 0, SUM = 1, MIN = 2, MAX = 3, AVG = 4, PRESENT = 5,
          WSUM = 6, NOP = 7 };
constexpr i64 DROPPED = -1;  // the id of a dropped row, and of rows past n
constexpr i64 NO_ROW = -2;   // the id beside a tile's edge

struct Layout {
  int nv, nops;
  __host__ __device__ int op(int o) const { return nv + 2 + 3 * o; }
  __host__ __device__ int out(int o) const { return nv + 2 + 3 * nops + o; }
  __host__ __device__ int kind(int c) const { return nv + 2 + 4 * nops + c; }
};

// One op of a pass: its code, source column, identity (the partial that
// makes no atomic) and output.
struct OpRef {
  int code;
  int col;
  i64 ident;
  i64* out;
};

template <class A>
__device__ __forceinline__ OpRef op_ref(const A& a, const Layout& L, int o,
                                        i64* wsum) {
  if (o >= L.nops)  // avg's weight sum, where there is an avg
    return o == L.nops && wsum ? OpRef{WSUM, 0, 0, wsum}
                               : OpRef{NOP, 0, 0, nullptr};
  return {static_cast<int>(a[L.op(o)]), static_cast<int>(a[L.op(o) + 1]),
          a[L.op(o) + 2], out_col(a, L.out(o))};
}

__device__ __forceinline__ bool reads_value(int code) {
  return code == SUM || code == AVG || code == MIN || code == MAX;
}

// what one row adds to its run's partial
__device__ __forceinline__ i64 contrib(const OpRef& op, i64 v, i64 w) {
  const i64 wpos = w > 0 ? w : 0;
  switch (op.code) {
    case SUM:
    case AVG:  // the sum now; fin_avg_kernel divides
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
  return static_cast<i64>(static_cast<u64>(x) + static_cast<u64>(y));
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

// rows r0 .. r0 + ITEMS - 1 of a column at its own width, widened; rows at
// or past n read as 0. A whole stretch of int64 or int32 at a 16-byte
// aligned address is one or two vector loads.
static_assert(ITEMS == 4, "the vector loads take four rows");
__device__ __forceinline__ void load_rows(const void* p, int kind, i64 r0,
                                          i64 n, i64 (&out)[ITEMS]) {
  if (r0 + ITEMS <= n) {
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
  for (int i = 0; i < ITEMS; ++i)
    out[i] = r0 + i < n ? load_widened(p, kind, r0 + i) : 0;
}

__device__ __forceinline__ i64 seg_id(i64 raw, i64 r, i64 n, i64 nseg) {
  return r < n && raw >= 0 && raw < nseg ? raw : DROPPED;
}

template <class A>
__global__ void fill_kernel(A a, Layout L, i64 nseg, i64* wsum) {
  const i64 s = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  for (int o = 0; o < L.nops; ++o) out_col(a, L.out(o))[s] = a[L.op(o) + 2];
  if (wsum) wsum[s] = 0;
}

template <class A>
__launch_bounds__(THREADS, MIN_BLOCKS) __global__
void rows_kernel(A a, Layout L, i64 n, i64 nseg, int nvirt, i64* wsum) {
  __shared__ i64 warp_sum[G][WARPS];
  __shared__ int warp_flag[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const i64 r0 = static_cast<i64>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  const void* ids = col_ptr(a, L.nv + 1);
  const int id_kind = static_cast<int>(a[L.kind(L.nv + 1)]);
  i64 id[ITEMS], w[ITEMS];
  load_rows(ids, id_kind, r0, n, id);
  load_rows(col_ptr(a, L.nv), static_cast<int>(a[L.kind(L.nv)]), r0, n, w);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) id[i] = seg_id(id[i], r0 + i, n, nseg);
  // the ids of the rows just before and just after this stretch, in the
  // tile
  const i64 before_id =
      threadIdx.x == 0 || r0 - 1 >= n
          ? NO_ROW
          : seg_id(load_widened(ids, id_kind, r0 - 1), r0 - 1, n, nseg);
  const i64 after_id =
      threadIdx.x == THREADS - 1 || r0 + ITEMS >= n
          ? NO_ROW
          : seg_id(load_widened(ids, id_kind, r0 + ITEMS), r0 + ITEMS, n,
                   nseg);
  bool multi = false;  // the stretch holds more than one run
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) multi |= id[i] != id[i - 1];
  // the stretch's first run continues the run before it
  const bool cont = id[0] == before_id;
  // a scan segment starts here: at this stretch's last run
  const int head_flag = multi || !cont;
  const i64 tail_id = id[ITEMS - 1];

  for (int g0 = 0; g0 < nvirt; g0 += G) {
    OpRef op[G];
    i64 c[G][ITEMS];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      op[g] = op_ref(a, L, g0 + g, wsum);
      i64 v[ITEMS] = {0, 0, 0, 0};
      if (reads_value(op[g].code))
        load_rows(col_ptr(a, op[g].col),
                  static_cast<int>(a[L.kind(op[g].col)]), r0, n, v);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) c[g][i] = contrib(op[g], v[i], w[i]);
    }
    // fold the stretch run by run: `head` is its first run's partial,
    // `s` the current run's; runs held whole are written at once
    i64 head[G], s[G];
    bool broke = false;
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = head[g] = c[g][0];
#pragma unroll
    for (int i = 1; i < ITEMS; ++i) {
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
    // segmented inclusive scan of the last runs' partials over the warp:
    // a flagged lane starts a new segment
    int flag = head_flag;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int f = __shfl_up_sync(FULL, flag, d);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const i64 x = __shfl_up_sync(FULL, s[g], d);
        if (lane >= d && !flag) s[g] = combine(op[g].code, x, s[g]);
      }
      if (lane >= d) flag |= f;
    }
    // ... and over the block's warps: `carry` is the scan's value at the
    // last lane of the warp before
    __syncthreads();  // the previous pass has read warp_sum
    if (lane == 31) {
      warp_flag[warp] = flag;
#pragma unroll
      for (int g = 0; g < G; ++g) warp_sum[g][warp] = s[g];
    }
    __syncthreads();
    i64 carry[G];
#pragma unroll
    for (int g = 0; g < G; ++g) carry[g] = op[g].ident;
    for (int v = warp - 1; v >= 0; --v) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        carry[g] = combine(op[g].code, warp_sum[g][v], carry[g]);
      if (warp_flag[v]) break;
    }
    // `before`: the partial of the run that holds the row before this
    // stretch, up to that row
    i64 before[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (!flag) s[g] = combine(op[g].code, carry[g], s[g]);
      const i64 x = __shfl_up_sync(FULL, s[g], 1);
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
}

// Python's floor division (what `//` on int64 is in the reference)
__device__ __forceinline__ i64 floor_div(i64 x, i64 y) {
  i64 q = x / y;
  if ((x % y != 0) && ((x < 0) != (y < 0))) --q;
  return q;
}

template <class A>
__global__ void fin_avg_kernel(A a, Layout L, i64 nseg, const i64* wsum) {
  const i64 s = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  const i64 c = wsum[s] > 1 ? wsum[s] : 1;
  for (int o = 0; o < L.nops; ++o) {
    if (a[L.op(o)] != AVG) continue;
    i64* out = out_col(a, L.out(o)) + s;
    const i64 sum = *out;
    // where(s >= 0, s // c, -((-s) // c)): truncation toward zero, with
    // the reference's wrap at s == INT64_MIN kept exact
    *out = sum >= 0 ? sum / c : wrap_neg(floor_div(wrap_neg(sum), c));
  }
}

template <class A>
void launch(const A& a, const Layout& L, i64 n, i64 nseg, i64* wsum,
            cudaStream_t stream) {
  fill_kernel<<<blocks_for(nseg, THREADS), THREADS, 0, stream>>>(a, L, nseg,
                                                                 wsum);
  if (n > 0)
    rows_kernel<<<blocks_for(n, TILE), THREADS, 0, stream>>>(
        a, L, n, nseg, L.nops + (wsum != nullptr), wsum);
  if (wsum)
    fin_avg_kernel<<<blocks_for(nseg, THREADS), THREADS, 0, stream>>>(
        a, L, nseg, wsum);
}

}  // namespace

extern "C" {

// `args` holds the `n_args` host slots; `table`, when not null, is their
// device copy and is what the kernels read. Returns cudaGetLastError()
// after the launches (0 on success). `wsum` is int64 scratch of nseg
// elements when the spec has an avg, else null.
int segment_reduce(const i64* args, int n_args, const i64* table, int nv,
                   int nops, i64 n, i64 nseg, i64* wsum,
                   cudaStream_t stream) {
  const Layout L{nv, nops};
  if (table)
    launch(ArgTable{table}, L, n, nseg, wsum, stream);
  else
    launch(args_by_value(args, n_args), L, n, nseg, wsum, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
