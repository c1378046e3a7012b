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
// Design: a run-wise segmented reduction (its pass is common.cuh's
// `fold_runs`, which the fused aggregate chain shares). A block takes a
// tile of TILE consecutive rows, each thread a stretch of ITEMS of them
// (vector loads where the stretch is aligned), every value widened once
// in registers.
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
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;  // consecutive rows per thread
constexpr int TILE = THREADS * ITEMS;
constexpr int G = 2;  // ops reduced per pass over a tile
// blocks per SM the register budget must allow (85 registers a thread)
constexpr int MIN_BLOCKS = 3;
static_assert(ITEMS == RUN_ITEMS, "fold_runs folds RUN_ITEMS rows a thread");
// the opcodes (enum Op), the fold (fold_runs) and its helpers are
// common.cuh's

struct Layout {
  int nv, nops;
  __host__ __device__ int op(int o) const { return nv + 2 + 3 * o; }
  __host__ __device__ int out(int o) const { return nv + 2 + 3 * nops + o; }
  __host__ __device__ int kind(int c) const { return nv + 2 + 4 * nops + c; }
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
  __shared__ RunScan<G, THREADS> scan;
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
    fold_runs<G, THREADS>(id, before_id, after_id, op, c, scan);
  }
}

template <class A>
__global__ void fin_avg_kernel(A a, Layout L, i64 nseg, const i64* wsum) {
  const i64 s = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  const i64 c = wsum[s] > 1 ? wsum[s] : 1;
  for (int o = 0; o < L.nops; ++o) {
    if (a[L.op(o)] != AVG) continue;
    i64* out = out_col(a, L.out(o)) + s;
    *out = avg_div(*out, c);
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
