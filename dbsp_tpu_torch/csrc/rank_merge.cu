// Rank-merge scatter: the inner loop of the sorted merge of two
// consolidated row sets.
//
// Replaces the Pallas `_rank_merge_kernel` behind `rank_merge_scatter`
// (dbsp_tpu/zset/pallas_kernels.py:495-548). Row i of a lands at i plus
// the b-rows strictly less than it, row j of b at j plus the a-rows less
// than or equal to it: the merge of the two sorted runs with an a-row
// before every equal b-row, weights included, in one na + nb buffer. The
// netting and compaction tail stays in plain torch, as it stays XLA in
// the reference.
//
// What bounds it on an H100: bytes. Every row is read once and written
// once, at its columns' own widths; the compares are few next to that.
// A binary search per row would make every row a chain of ~21 dependent
// loads from the other side, most of them misses at 2M rows.
//
// Design: a merge path. The na + nb outputs are cut into tiles of `tile`
// rows (a multiple of THREADS; the wrapper picks it from the column count
// so that the stage takes 64 KB: three blocks to an SM). Each block finds
// where its tile starts and ends in a and in b with one search per tile
// edge along the merge's diagonal, run by a whole warp as a 32-way search
// (five rounds of loads at 2M rows, not 21). It loads its rows of a and
// of b, every column and the weights, into dynamic shared memory with
// coalesced loads, LOAD_BATCH in flight per thread, widening each value
// once; each thread then merges a run of tile / THREADS outputs out of
// shared memory (its own start found by a diagonal search there), and the
// block writes the tile back with coalesced stores, each column at the
// output's own width. No thread searches the other side in device memory,
// and the wrapper neither widens the inputs nor narrows the outputs.
// What is left between it and the byte bound: a block's phases run in
// turn (search, load, merge, store), so an SM moves bytes only while one
// of its three blocks is loading or storing.
//
// Argument block (ncols columns, nc = ncols + 1 with the weights last):
//   [c] a column c, [ncols] a weights;
//   [nc + c] b column c, [nc + ncols] b weights;
//   [2*nc + c] output column c, [2*nc + ncols] output weights;
//   [3*nc + c] ColKind of a's column c (the weights at c == ncols), which
//              is the output's too; [4*nc + c] ColKind of b's column c
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LOAD_BATCH = 16;  // loads in flight per thread while staging
// blocks per SM the register budget must allow (64 registers a thread):
// one more than the 64 KB stage lets in (MERGE_STAGE_BYTES in
// zset/cuda_kernels.py), which measured faster than room for three
constexpr int MIN_BLOCKS = 4;
// dynamic shared memory a block may take: 227 KB less the static `split`
constexpr size_t SMEM_MAX = 227 * 1024 - 2 * sizeof(i64);

// a-row i <= b-row j, lexicographic over the ncols key columns
template <class A>
__device__ bool a_le_b(const A& a, int ncols, int nc, i64 i, i64 j) {
  for (int c = 0; c < ncols; ++c) {
    const i64 x =
        load_widened(col_ptr(a, c), static_cast<int>(a[3 * nc + c]), i);
    const i64 y = load_widened(col_ptr(a, nc + c),
                               static_cast<int>(a[4 * nc + c]), j);
    if (x != y) return x < y;
  }
  return true;
}

// How many of the merge's first d rows come from a. P(i) = a[i] <= b[d-1-i]
// holds for i below the answer and fails from it on; each round the warp's
// 32 lanes test 32 evenly spaced candidates and the ballot narrows the
// range to one gap between them. Every lane returns the answer. (Half a
// block per edge, 128-way, three rounds at 2M rows, measured slower on
// the H100: it holds every warp of the block at three barriers a round.)
template <class A>
__device__ i64 diagonal_split(const A& a, int ncols, int nc, i64 na, i64 nb,
                              i64 d, int lane) {
  i64 lo = max(d - nb, static_cast<i64>(0)), hi = min(d, na);
  while (lo < hi) {  // the same for every lane
    const i64 step = (hi - lo + 31) >> 5;
    const i64 c = lo + lane * step;
    const bool p = c < hi && a_le_b(a, ncols, nc, c, d - 1 - c);
    const int k = __popc(__ballot_sync(0xffffffffu, p));
    hi = min(lo + k * step, hi);  // candidate k failed (or lies past hi)
    if (k > 0) lo += (k - 1) * step + 1;  // candidate k - 1 held
  }
  return lo;
}

// staged row x <= staged row y (the tile's n rows, column-major)
__device__ __forceinline__ bool row_le(const i64* sh, int n, int ncols,
                                       int x, int y) {
  for (int c = 0; c < ncols; ++c) {
    const i64 vx = sh[c * n + x], vy = sh[c * n + y];
    if (vx != vy) return vx < vy;
  }
  return true;
}

template <class A>
__launch_bounds__(THREADS, MIN_BLOCKS) __global__
void rank_merge_kernel(A a, int ncols, i64 na, i64 nb, int tile) {
  // [nc][n] staged values (the tile's a-rows, then its b-rows), then
  // [tile] the staged row each output takes
  extern __shared__ i64 sh[];
  __shared__ i64 split[2];
  const int nc = ncols + 1;
  int* src = reinterpret_cast<int*>(sh + static_cast<size_t>(nc) * tile);
  const i64 d0 = static_cast<i64>(blockIdx.x) * tile;
  const int n = static_cast<int>(min(static_cast<i64>(tile), na + nb - d0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const i64 s =
        diagonal_split(a, ncols, nc, na, nb, d0 + (warp ? n : 0), lane);
    if (lane == 0) split[warp] = s;
  }
  __syncthreads();
  const i64 i0 = split[0];
  // monotone on sorted runs; the clamp keeps any input inside the tile
  const i64 i1 = min(max(split[1], i0), i0 + n);
  const int n_a = static_cast<int>(i1 - i0), n_b = n - n_a;
  const i64 j0 = d0 - i0;
  stage_batched<LOAD_BATCH>(sh, nc, n, [&](int c, int r) {
    return r < n_a ? load_widened(col_ptr(a, c),
                                  static_cast<int>(a[3 * nc + c]), i0 + r)
                   : load_widened(col_ptr(a, nc + c),
                                  static_cast<int>(a[4 * nc + c]),
                                  j0 + (r - n_a));
  });
  __syncthreads();
  const int per = tile / THREADS;
  const int o0 = threadIdx.x * per;
  if (o0 < n) {
    int lo = max(0, o0 - n_b), hi = min(o0, n_a);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row_le(sh, n, ncols, mid, n_a + o0 - 1 - mid)) lo = mid + 1;
      else hi = mid;
    }
    int ia = lo, ib = o0 - lo;
    const int o1 = min(o0 + per, n);
    for (int o = o0; o < o1; ++o) {
      const bool take_a =
          ib >= n_b || (ia < n_a && row_le(sh, n, ncols, ia, n_a + ib));
      src[o] = take_a ? ia++ : n_a + ib++;
    }
  }
  __syncthreads();
  BlockWalk w(n);
  for (int e = threadIdx.x; e < nc * n; e += THREADS, w.next())
    store_narrowed(reinterpret_cast<void*>(a[2 * nc + w.c]),
                   static_cast<int>(a[3 * nc + w.c]), d0 + w.r,
                   sh[e - w.r + src[w.r]]);
}

size_t stage_bytes(int ncols, int tile) {
  return (static_cast<size_t>(ncols) + 1) * tile * sizeof(i64) +
         static_cast<size_t>(tile) * sizeof(int);
}

template <class A>
int launch(const A& a, int ncols, i64 na, i64 nb, int tile,
           cudaStream_t stream) {
  const size_t smem = stage_bytes(ncols, tile);
  const cudaError_t e = cudaFuncSetAttribute(
      rank_merge_kernel<A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  rank_merge_kernel<A><<<blocks_for(na + nb, tile), THREADS, smem, stream>>>(
      a, ncols, na, nb, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// `args` holds the `n_args` host slots; `table`, when not null, is their
// device copy and is what the kernel reads. `tile` is the rows per block.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int rank_merge(const i64* args, int n_args, const i64* table, int ncols,
               i64 na, i64 nb, int tile, cudaStream_t stream) {
  if (ncols < 1 || ncols > MAX_COLS || tile < THREADS ||
      tile % THREADS != 0 || stage_bytes(ncols, tile) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (na + nb == 0) return static_cast<int>(cudaGetLastError());
  if (table) return launch(ArgTable{table}, ncols, na, nb, tile, stream);
  return launch(args_by_value(args, n_args), ncols, na, nb, tile, stream);
}

}  // extern "C"
