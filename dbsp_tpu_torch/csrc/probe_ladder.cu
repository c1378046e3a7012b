// Ladder-wide lexicographic probe: lex_probe_ladder.
//
// Replaces the Pallas kernel `_probe_ladder_kernel` behind
// `lex_probe_ladder_pallas` (dbsp_tpu/zset/pallas_kernels.py:136-190). For
// m query rows and K sorted trace levels it writes the [K, m] int32
// insertion points, side left (rows < query) or right (rows <= query),
// each search bounded by its own level's cap. Incremental distinct calls
// it twice, left then right, to find each delta row in every level.
//
// What bounds it on an H100: each lane is a chain of dependent loads,
// log2(level cap) deep (about 21 at 2M rows), most of them misses in L2
// for a deep level; there is no arithmetic to speak of. The byte bound
// (queries read once, the probed key bytes of each level at most once,
// the output written once) is far below what the load latency allows.
//
// Design. One thread per (level k, query i), K*m threads in level-major
// order, each running the shared `lex_search` over level k with `hi`
// starting at that level's own cap. The TPU version stacks every level
// into a sentinel-padded [K, maxcap] block per column; here each thread
// reads only its own level through the pointer in the argument block, so
// nothing is stacked, padded or copied, and an empty level (cap 0) gives 0
// for every query. Unlike the ladder consumer's probe pass, no lane is
// zeroed: every query, sentinel and dead ones included, gets its raw
// insertion point, as the Pallas kernel gives it; the caller masks dead
// rows.
//
// Argument block (K levels, ncols columns):
//   [c*K + k]            column c of level k
//   Q = ncols*K:         [Q + c] query column c
//   C = Q + ncols:       [C + k] cap of level k (an integer, not a pointer)
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <bool STRICT, class A>
__global__ void probe_ladder_kernel(A a, int K, int ncols, i64 m,
                                    int* out) {
  const i64 t = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<i64>(K) * m) return;
  const int k = static_cast<int>(t / m);
  const i64 i = t - static_cast<i64>(k) * m;
  const int q = ncols * K;
  const i64 cap = a[q + ncols + k];
  out[t] = static_cast<int>(lex_search<STRICT>(a, k, K, q, ncols, cap, i));
}

template <class A>
void launch(const A& a, int K, int ncols, i64 m, int strict, int* out,
            cudaStream_t stream) {
  const i64 n = static_cast<i64>(K) * m;
  if (strict)
    probe_ladder_kernel<true><<<blocks_for(n, THREADS), THREADS, 0,
                                stream>>>(a, K, ncols, m, out);
  else
    probe_ladder_kernel<false><<<blocks_for(n, THREADS), THREADS, 0,
                                 stream>>>(a, K, ncols, m, out);
}

}  // namespace

extern "C" {

// `args` holds the `n_args` host slots; `table`, when not null, is their
// device copy and is what the kernel reads. Returns cudaGetLastError()
// after the launch (0 on success).
int lex_probe_ladder(const i64* args, int n_args, const i64* table, int K,
                     int ncols, i64 m, int strict, int* out,
                     cudaStream_t stream) {
  if (static_cast<i64>(K) * m > 0) {
    if (table)
      launch(ArgTable{table}, K, ncols, m, strict, out, stream);
    else
      launch(args_by_value(args, n_args), K, ncols, m, strict, out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
