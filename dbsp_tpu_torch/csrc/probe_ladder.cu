// Ladder-wide lexicographic probe: lex_probe_ladder.
//
// Replaces the Pallas kernel `_probe_ladder_kernel` behind
// `lex_probe_ladder_pallas` (dbsp_tpu/zset/pallas_kernels.py:136-190). For
// m query rows and K sorted trace levels it writes, in one launch, the
// [K, m] int32 insertion points of side left (rows < query) and side right
// (rows <= query), each search bounded by its own level's cap. Incremental
// distinct asks for both, to find each delta row in every level; a caller
// that wants one side reads one of the two outputs.
//
// What bounds it on an H100: each lane is a chain of dependent loads,
// log2(level cap) deep (about 21 at 2M rows), most of them misses in L2
// for a deep level; there is no arithmetic to speak of. The byte bound
// (queries read once, the probed bytes of each level at most once, the
// outputs written once) is far below what the load latency allows.
//
// Design. The grid is (ceil(m / THREADS), K): a block serves THREADS
// queries of ONE level. Each lane searches its level over [0, cap) for
// the left side; the rows at the top of that search are the same for
// every lane, and the L1 serves them. (A stage of every stride-th row in
// shared memory, bracketing each query before the global search, measured
// 3% slower on the H100 and was taken out.) The right search starts from
// the left answer L (right >= left on any sorted table, duplicate rows
// included): every row from L on is >= the query, so a row there is
// <= the query iff it equals it. The lane gallops over the run of rows
// equal to the query from L on and searches only the run's last gap: one
// load where no row equals the query, two where one does (a consolidated
// level), and still exact for longer runs (common.cuh `equal_range`,
// which the ladder consumer and agg_ladder share). A cap-0 level answers
// 0. No
// lane is zeroed: every query, sentinel and dead ones included, gets its
// raw insertion point, as the Pallas kernel gives it; the caller masks
// dead rows. Columns are read at their own width (`ColKind`), so the
// wrapper widens nothing.
//
// Argument block (K levels, ncols columns):
//   [c*K + k]            column c of level k
//   Q = ncols*K:         [Q + c] query column c
//   C = Q + ncols:       [C + k] cap of level k (an integer, not a pointer)
//   D = C + K:           [D + c] ColKind of table column c (every level),
//                        [D + ncols + c] ColKind of query column c
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
// blocks per SM the register budget must allow: a full SM of lanes, since
// each lane waits on a chain of dependent loads
constexpr int MIN_BLOCKS = 2048 / THREADS;

template <class A>
__launch_bounds__(THREADS, MIN_BLOCKS) __global__
void probe_ladder_kernel(A a, int K, int ncols, i64 m, int* left,
                         int* right) {
  const int k = blockIdx.y;
  const int Q = ncols * K, C = Q + ncols, D = C + K;
  const i64 i = static_cast<i64>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= m) return;
  const i64 cap = a[C + k];
  const i64 out = static_cast<i64>(k) * m + i;
  i64 q[MAX_COLS];
  for (int c = 0; c < ncols; ++c) q[c] = col_at(a, Q + c, D + ncols + c, i);
  i64 found;
  const i64 run = equal_range(a, k, K, D, ncols, cap, q, &found);
  left[out] = static_cast<int>(found);
  right[out] = static_cast<int>(found + run);
}

template <class A>
void launch(const A& a, int K, int ncols, i64 m, int* left, int* right,
            cudaStream_t stream) {
  const dim3 grid(blocks_for(m, THREADS), static_cast<unsigned int>(K));
  probe_ladder_kernel<<<grid, THREADS, 0, stream>>>(a, K, ncols, m, left,
                                                    right);
}

}  // namespace

extern "C" {

// `args` holds the `n_args` host slots; `table`, when not null, is their
// device copy and is what the kernel reads. `left` and `right` are the
// [K, m] outputs of side left and side right. Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for arguments
// the kernel does not take.
int lex_probe_ladder(const i64* args, int n_args, const i64* table, int K,
                     int ncols, i64 m, int* left, int* right,
                     cudaStream_t stream) {
  if (!left || !right || K < 1 || K > 65535 || ncols < 1 ||
      ncols > MAX_COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0) {
    if (table)
      launch(ArgTable{table}, K, ncols, m, left, right, stream);
    else
      launch(args_by_value(args, n_args), K, ncols, m, left, right, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
