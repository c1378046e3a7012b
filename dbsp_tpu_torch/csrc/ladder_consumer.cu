// Fused trace-ladder consumer: join_ladder and gather_ladder.
//
// Replaces the Pallas megakernel `_ladder_consumer_kernel` behind
// `join_ladder_pallas` and `gather_ladder_pallas`
// (dbsp_tpu/zset/pallas_kernels.py:198-381). For m query rows and K sorted
// trace levels it finds every matching level row, allocates the matches
// level-major into one `out_cap` buffer, and gathers each match's level
// values and weight (times the delta weight, for a join). The unclamped
// match total comes back so the caller can grow `out_cap` and relaunch.
//
// What bounds it on an H100: the searches are chains of dependent loads,
// log2(level cap) deep (about 21 at 2M rows), each a likely miss in L2 for
// a deep level; the expansion and gather move out_cap x (ng + 1) int64
// reads and writes. Both are latency- and bandwidth-bound integer work;
// there is no arithmetic to speak of.
//
// Design. The TPU kernel carries the running cross-level offset in an
// output block across a SEQUENTIAL grid (program k reads what programs
// 0..k-1 left). CUDA blocks run in no order, so the work is split into
// passes on one stream:
//   1. probe: one thread per (level, query) runs both binary searches, each
//      clamped to its own level's cap, zeroes dead queries, and writes the
//      range start and count in level-major order;
//   2. an exclusive int64 scan of the K*m counts, written here (block scan
//      with warp shuffles, recursive over block sums); total = last offset
//      + last count, unclamped;
//   3. expand + gather: one thread per output slot j finds its (level,
//      query) by an upper-bound search of j in the offsets and copies the
//      source row. Slots at j >= total get zeros, as the Pallas init leaves
//      them.
// No host sync happens inside: `total` stays on the device.
//
// Argument block (K levels, nk key columns, ng gathered columns):
//   [c*K + k]            key column c of level k          (c < nk)
//   [(nk + c)*K + k]     gathered column c of level k     (c < ng)
//   [(nk + ng)*K + k]    weights of level k
//   Q = (nk + ng + 1)*K: [Q + c] lower query column c, [Q + nk + c] upper
//                        query column c, [Q + 2nk] query weights (join) or
//                        0/1 live mask (gather)
//   C = Q + 2nk + 1:     [C + k] cap of level k (an integer, not a pointer)
//   O = C + K:           [O + c] output column c          (c < ng)
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_T = 1024;  // one scan tile = one block of 32 warps

struct Layout {
  int K, nk, ng;
  __host__ __device__ int weights(int k) const { return (nk + ng) * K + k; }
  __host__ __device__ int gathered(int c, int k) const {
    return (nk + c) * K + k;
  }
  __host__ __device__ int q() const { return (nk + ng + 1) * K; }
  __host__ __device__ int caps() const { return q() + 2 * nk + 1; }
  __host__ __device__ int out() const { return caps() + K; }
};

template <class A>
__global__ void probe_kernel(A a, Layout L, i64 m, i64* lo_out,
                             i64* cnt_out) {
  const i64 t = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<i64>(L.K) * m) return;
  const int k = static_cast<int>(t / m);
  const i64 i = t - static_cast<i64>(k) * m;
  const i64 cap = a[L.caps() + k];
  const int q = L.q();
  i64 lo = lex_search<true>(a, k, L.K, q, L.nk, cap, i);
  i64 hi = lex_search<false>(a, k, L.K, q + L.nk, L.nk, cap, i);
  if (in_col(a, q + 2 * L.nk)[i] != 0) {
    // distinct upper bounds may give an empty range (qhi < qlo)
    if (hi < lo) hi = lo;
  } else {
    lo = 0;  // dead rows carry sentinel keys that match every dead tail
    hi = 0;
  }
  lo_out[t] = lo;
  cnt_out[t] = hi - lo;
}

__device__ i64 block_exclusive_scan(i64 x, i64* block_total) {
  __shared__ i64 warp_tot[SCAN_T / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  i64 v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const i64 y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_tot[wid] = v;
  __syncthreads();
  if (wid == 0) {
    i64 s = warp_tot[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const i64 y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_tot[lane] = s;
  }
  __syncthreads();
  *block_total = warp_tot[SCAN_T / 32 - 1];
  return (wid > 0 ? warp_tot[wid - 1] : 0) + v - x;
}

__global__ void scan_tiles_kernel(const i64* in, i64* out, i64* tile_sums,
                                  i64 n) {
  const i64 i = static_cast<i64>(blockIdx.x) * SCAN_T + threadIdx.x;
  i64 tot;
  const i64 e = block_exclusive_scan(i < n ? in[i] : 0, &tot);
  if (i < n) out[i] = e;
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = tot;
}

__global__ void add_tile_offsets_kernel(i64* out, const i64* tile_offs,
                                        i64 n) {
  const i64 i = static_cast<i64>(blockIdx.x) * SCAN_T + threadIdx.x;
  if (i < n) out[i] += tile_offs[blockIdx.x];
}

i64 scan_scratch(i64 n) {
  const i64 tiles = (n + SCAN_T - 1) / SCAN_T;
  return tiles <= 1 ? 1 : 2 * tiles + scan_scratch(tiles);
}

// exclusive scan of in[0, n) into out; scratch holds scan_scratch(n)
void exclusive_scan(const i64* in, i64* out, i64 n, i64* scratch,
                    cudaStream_t stream) {
  const i64 tiles = (n + SCAN_T - 1) / SCAN_T;
  scan_tiles_kernel<<<static_cast<unsigned int>(tiles), SCAN_T, 0, stream>>>(
      in, out, scratch, n);
  if (tiles > 1) {
    i64* tile_offs = scratch + tiles;
    exclusive_scan(scratch, tile_offs, tiles, scratch + 2 * tiles, stream);
    add_tile_offsets_kernel<<<static_cast<unsigned int>(tiles), SCAN_T, 0,
                              stream>>>(out, tile_offs, n);
  }
}

__global__ void total_kernel(const i64* off, const i64* cnt, i64 n,
                             i64* total) {
  *total = off[n - 1] + cnt[n - 1];
}

template <class A>
__global__ void gather_kernel(A a, Layout L, i64 m, i64 out_cap, int join,
                              const i64* lo, const i64* off,
                              const i64* total_p, int* qrow, i64* w) {
  const i64 j = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= out_cap) return;
  const int O = L.out();
  if (j >= *total_p) {
    qrow[j] = 0;
    for (int c = 0; c < L.ng; ++c) out_col(a, O + c)[j] = 0;
    w[j] = 0;
    return;
  }
  // last (level, query) whose range starts at or before j: ranges tile
  // [0, total) in order, and empty ranges share their successor's start
  i64 l = 0, h = static_cast<i64>(L.K) * m;
  while (l < h) {
    const i64 mid = (l + h) >> 1;
    if (off[mid] <= j) l = mid + 1; else h = mid;
  }
  const i64 t = l - 1;
  const int k = static_cast<int>(t / m);
  const i64 i = t - static_cast<i64>(k) * m;
  const i64 src = lo[t] + (j - off[t]);
  qrow[j] = static_cast<int>(i);
  for (int c = 0; c < L.ng; ++c)
    out_col(a, O + c)[j] = in_col(a, L.gathered(c, k))[src];
  const i64 lw = in_col(a, L.weights(k))[src];
  w[j] = join ? wrap_mul(in_col(a, L.q() + 2 * L.nk)[i], lw) : lw;
}

template <class A>
void launch(const A& a, const Layout& L, i64 m, i64 out_cap, int join,
            int* qrow, i64* w, i64* total, i64* scratch,
            cudaStream_t stream) {
  const i64 n = static_cast<i64>(L.K) * m;
  i64* lo = scratch;
  i64* cnt = scratch + n;
  i64* off = scratch + 2 * n;
  probe_kernel<<<blocks_for(n, THREADS), THREADS, 0, stream>>>(a, L, m, lo,
                                                               cnt);
  exclusive_scan(cnt, off, n, scratch + 3 * n, stream);
  total_kernel<<<1, 1, 0, stream>>>(off, cnt, n, total);
  gather_kernel<<<blocks_for(out_cap, THREADS), THREADS, 0, stream>>>(
      a, L, m, out_cap, join, lo, off, total, qrow, w);
}

}  // namespace

extern "C" {

// int64 scratch elements `ladder_consumer` needs for K levels x m queries
i64 ladder_scratch_elems(int K, i64 m) {
  const i64 n = static_cast<i64>(K) * m;
  return 3 * n + scan_scratch(n);
}

// `args` holds the `n_args` host slots; `table`, when not null, is their
// device copy and is what the kernels read. Returns cudaGetLastError()
// after the launches (0 on success).
int ladder_consumer(const i64* args, int n_args, const i64* table, int K,
                    int nk, int ng, i64 m, i64 out_cap, int join, int* qrow,
                    i64* w, i64* total, i64* scratch, cudaStream_t stream) {
  const Layout L{K, nk, ng};
  if (table)
    launch(ArgTable{table}, L, m, out_cap, join, qrow, w, total, scratch,
           stream);
  else
    launch(args_by_value(args, n_args), L, m, out_cap, join, qrow, w, total,
           scratch, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
