// Fused trace-ladder consumer: join_ladder and gather_ladder.
//
// Replaces the Pallas megakernel `_ladder_consumer_kernel` behind
// `join_ladder_pallas` and `gather_ladder_pallas`
// (dbsp_tpu/zset/pallas_kernels.py:198-381). For m query rows and K sorted
// trace levels it finds every matching level row, allocates the matches
// level-major into one `out_cap` buffer (level 0's matches in query order,
// then level 1's, ...), and gathers each match's level values and weight
// (times the query's weight, for a join). Slots past the unclamped match
// total hold the dead-slot values (join: query row 0, values 0, weight 0;
// gather: query row m, each column's sentinel, weight 0); the join also
// writes `valid` (slot < total). The total comes back unclamped so the
// caller can grow `out_cap` and relaunch.
//
// What bounds it on an H100: bytes. It must read the queries once, the
// top of a search of every level per query, the matched rows once, and
// write out_cap slots. On the main path that is 5-70 MB (PERF.md §6).
// The searches are chains of dependent loads, log2(level cap) deep, most
// of them misses in L2 for a deep level: with few queries (a join's delta
// of a few thousand rows) their latency, not the bytes, sets the time.
//
// Design: two ordinary launches on the caller's stream. The pairs
// t = k * m + i (level k, query i) are cut into one contiguous chunk per
// block of the first.
//   consumer_probe_kernel. Per pair of the block's chunk, in rounds of
//      THREADS: a lower-bound search of the query in the level, then the
//      right side from that answer (common.cuh `equal_range`: a gallop
//      over the run of rows equal to the query; with distinct upper
//      queries, a search of the upper query over [left answer, cap)). A
//      dead query (weight 0 for a join, live 0 for a gather) gets an empty
//      range without a search. A block scan gives each pair its range's
//      offset within the chunk; the chunk's sum goes to scratch. Nothing
//      crosses blocks, so the launch needs no grid barrier and runs at the
//      probe's own occupancy (30 registers: a full SM of lanes).
//   consumer_expand_kernel. Each block scans the chunks' sums (at most
//      MAX_CHUNKS) into shared memory: a pair's level-major offset is its
//      chunk's base plus its offset in the chunk; the total is their sum
//      (block 0 writes it). Then a load-balanced expansion, a merge path
//      of the range starts against the output slots: the pairs' range
//      starts and the slots below nb = min(total, out_cap) form one merged
//      sequence in which a range start precedes the slots it covers; pair
//      t sits at position t + off(t). The sequence is cut into warp tiles
//      of WARP_TILE items, dealt to the grid's warps in turn; a warp tile
//      needs no block barrier. Its two half-warps find the pair counts
//      before its two edges at once: a search of the chunks' bases in
//      shared memory, then a 16-way search inside the chunk (one load per
//      lane a step). The warp stages the tile's pairs (positions, row
//      bases, query rows, levels) in its slice of shared memory; each lane
//      finds its ITEMS consecutive items there by a binary search and
//      walks them: a range start moves it to the next pair, a slot is
//      gathered from the pair before, at each column's own width. So a
//      hot key's range spreads over as many tiles as its rows fill, a run
//      of empty ranges costs a tile no more than its items, and no slot
//      searches global memory. A grid-stride loop writes the dead slots
//      [nb, out_cap) and the join's `valid`.
//   One cooperative launch with a grid barrier in place of the kernel
//   boundary measured 1.5x slower on the gather (PERF.md §6, PR 12): its
//   registers, the most any phase needs, held both phases to 3 blocks an
//   SM.
// No value goes to the host; columns are read and written at their own
// width (`ColKind`); outputs and scratch are views of one buffer the
// wrapper allocates.
//
// Argument block (K levels, nk key columns, ng gathered columns):
//   [c*K + k]            key column c of level k          (c < nk)
//   [(nk + c)*K + k]     gathered column c of level k     (c < ng)
//   [(nk + ng)*K + k]    weights of level k
//   Q = (nk + ng + 1)*K: [Q + c] lower query column c, [Q + nk + c] upper
//                        query column c, [Q + 2nk] query weights (join) or
//                        live flags (gather)
//   C = Q + 2nk + 1:     [C + k] row count of level k
//   KD = C + K:          ColKinds: [KD + c] key column c (every level),
//                        [KD + nk + c] gathered column c, [KD + nk + ng]
//                        the weights, [KD + nk + ng + 1 + c] query column
//                        c in the order above (2nk + 1 of them)
//   O = KD + 3nk + ng + 2: outputs: [O + c] gathered column c (at that
//                        column's kind), [O + ng] w (at the query weights'
//                        kind for a join, the levels' for a gather),
//                        [O + ng + 1] qrow (int32), [O + ng + 2] valid
//                        (bool; join only), [O + ng + 3] total (int64)
//   DV = O + ng + 4:     [DV + c] gathered column c's dead-slot value
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;  // merged items a lane of a warp tile walks
constexpr int WARP_TILE = 32 * ITEMS;
// most chunks of the probe (their bases live in the expansion's shared
// memory)
constexpr int MAX_CHUNKS = 1024;
// most blocks of the expansion's grid (its loops stride over the rest)
constexpr int MAX_EXPAND_BLOCKS = 8192;

struct Dims {
  int K, nk, ng, join, same_hi, chunks;
  i64 m, out_cap, n, chunk;  // n = K * m pairs, chunk pairs per chunk
};

struct Layout {
  int K, nk, ng;
  __host__ __device__ int gathered(int c, int k) const {
    return (nk + c) * K + k;
  }
  __host__ __device__ int weights(int k) const { return (nk + ng) * K + k; }
  __host__ __device__ int q() const { return (nk + ng + 1) * K; }
  __host__ __device__ int mask() const { return q() + 2 * nk; }
  __host__ __device__ int caps() const { return mask() + 1; }
  __host__ __device__ int kinds() const { return caps() + K; }
  __host__ __device__ int gathered_kind(int c) const {
    return kinds() + nk + c;
  }
  __host__ __device__ int weights_kind() const { return kinds() + nk + ng; }
  __host__ __device__ int q_kind(int c) const {  // c < 2nk + 1
    return kinds() + nk + ng + 1 + c;
  }
  __host__ __device__ int out() const { return kinds() + 3 * nk + ng + 2; }
  __host__ __device__ int dead() const { return out() + ng + 4; }
  __host__ __device__ int n_slots() const { return dead() + ng; }
};

// A warp tile's staged pairs.
struct Staged {
  i64 pos[WARP_TILE + 1];   // merged position t + off(t)
  i64 row0[WARP_TILE + 1];  // lo(t) - off(t): slot j reads row row0 + j
  int qrow[WARP_TILE + 1], level[WARP_TILE + 1];
};

struct Shared {
  i64 base[MAX_CHUNKS];  // per chunk: the level-major offset of its first pair
  Staged tile[WARPS];
  i64 warp_sums[WARPS];
};

// The range [*lo, *lo + count) of level k's rows that query i matches;
// returns count.
template <class A>
__device__ i64 probe(const A& a, const Layout& L, const Dims& d, int k,
                     i64 i, i64* lo) {
  *lo = 0;
  if (col_at(a, L.mask(), L.q_kind(2 * L.nk), i) == 0) return 0;
  const i64 cap = a[L.caps() + k];
  i64 q[MAX_COLS];
  for (int c = 0; c < L.nk; ++c) q[c] = col_at(a, L.q() + c, L.q_kind(c), i);
  if (d.same_hi) return equal_range(a, k, L.K, L.kinds(), L.nk, cap, q, lo);
  *lo = search_rows<true>(a, k, L.K, L.kinds(), L.nk, 0, cap, q);
  for (int c = 0; c < L.nk; ++c)
    q[c] = col_at(a, L.q() + L.nk + c, L.q_kind(L.nk + c), i);
  // an upper query below the lower one answers *lo: an empty range
  return search_rows<false>(a, k, L.K, L.kinds(), L.nk, *lo, cap, q) - *lo;
}

template <class A>
__launch_bounds__(THREADS) __global__
void consumer_probe_kernel(A a, Dims d, i64* scratch) {
  __shared__ i64 warp_sums[WARPS];
  const Layout L{d.K, d.nk, d.ng};
  const int b = blockIdx.x, x = threadIdx.x;
  i64* lo_of = scratch;         // per pair: its range's first row
  i64* local = scratch + d.n;   // per pair: its offset within its chunk
  i64* sums = scratch + 2 * d.n;  // per chunk: its matches
  const i64 c0 = min(d.n, b * d.chunk), c1 = min(d.n, c0 + d.chunk);
  i64 run = 0, total;
  for (i64 t0 = c0; t0 < c1; t0 += THREADS) {
    const i64 t = t0 + x;
    i64 lo = 0, cnt = 0;
    if (t < c1) {
      const int k = static_cast<int>(static_cast<unsigned>(t) /
                                     static_cast<unsigned>(d.m));
      cnt = probe(a, L, d, k, t - k * d.m, &lo);
    }
    const i64 off = run + block_scan<THREADS>(cnt, warp_sums, &total);
    run += total;
    if (t < c1) {
      lo_of[t] = lo;
      local[t] = off;
    }
  }
  if (x == 0) sums[b] = run;
}

// Pairs t < n whose merged position t + off(t) is below `edge`, by a
// half-warp (every lane of the warp calls it, each half with its own
// edge, and every lane gets its half's answer): the last chunk whose first
// pair lies below the edge, from the chunks' bases in shared memory, then
// a 16-way search of that chunk's offsets. n < 2^31 (the launcher checks).
__device__ i64 pairs_before(const Dims& d, const i64* local,
                            const i64* base, i64 edge) {
  const int lane = threadIdx.x & 31, h = lane & 15, half = lane & 16;
  const unsigned chunk = static_cast<unsigned>(d.chunk);
  const int chunks = static_cast<int>((d.n + d.chunk - 1) / d.chunk);
  int cl = 0, ch = chunks;
  while (cl < ch) {
    const int mid = (cl + ch) >> 1;
    if (static_cast<i64>(mid) * chunk + base[mid] < edge) cl = mid + 1;
    else ch = mid;
  }
  // the answer lies in [lo, hi]: pair c * chunk lies below the edge, the
  // next chunk's first does not
  i64 lo = 0, hi = 0, b = 0;
  if (cl > 0) {
    const i64 c = cl - 1;
    lo = c * chunk + 1;
    hi = min(d.n, (c + 1) * chunk);
    b = base[c];
  }
  for (;;) {
    const bool busy = hi - lo > 16;
    if (!__any_sync(FULL_MASK, busy)) break;
    const i64 step = (hi - lo + 15) >> 4;
    const i64 t = lo + (h + 1) * step - 1;
    const bool below = busy && t < hi && t + b + local[t] < edge;
    const int n = __popc((__ballot_sync(FULL_MASK, below) >> half) & 0xffff);
    if (busy) {
      const i64 nlo = lo + n * step;
      hi = min(hi, lo + (n + 1) * step - 1);
      lo = nlo;
    }
  }
  const i64 t = lo + h;
  const bool below = t < hi && t + b + local[t] < edge;
  return lo + __popc((__ballot_sync(FULL_MASK, below) >> half) & 0xffff);
}

template <class A>
__device__ __forceinline__ void store_out(const A& a, int slot, int kind,
                                          i64 j, i64 v) {
  store_narrowed(reinterpret_cast<void*>(a[slot]), kind, j, v);
}

template <class A>
__launch_bounds__(THREADS) __global__
void consumer_expand_kernel(A a, Dims d, const i64* scratch) {
  __shared__ Shared s;
  const Layout L{d.K, d.nk, d.ng};
  const int b = blockIdx.x, x = threadIdx.x, warp = x >> 5, lane = x & 31;
  const i64* lo_of = scratch;
  const i64* local = scratch + d.n;
  const i64* sums = scratch + 2 * d.n;
  const int O = L.out();
  const int w_kind = static_cast<int>(
      a[d.join ? L.q_kind(2 * L.nk) : L.weights_kind()]);

  // the chunks' bases; the total
  i64 total;
  {
    const int per = (d.chunks + THREADS - 1) / THREADS;
    const int e0 = min(d.chunks, x * per), e1 = min(d.chunks, e0 + per);
    i64 mine = 0;
    for (int e = e0; e < e1; ++e) mine += sums[e];
    i64 acc = block_scan<THREADS>(mine, s.warp_sums, &total);
    for (int e = e0; e < e1; ++e) {
      s.base[e] = acc;
      acc += sums[e];
    }
  }
  if (b == 0 && x == 0) reinterpret_cast<i64*>(a[O + L.ng + 3])[0] = total;
  const i64 nb = min(total, d.out_cap);  // slots that hold a match
  __syncthreads();

  // dead slots, and the join's valid
  {
    const i64 gstride = static_cast<i64>(gridDim.x) * THREADS;
    const int dead_qrow = d.join ? 0 : static_cast<int>(d.m);
    unsigned char* valid = reinterpret_cast<unsigned char*>(a[O + L.ng + 2]);
    int* qrow = reinterpret_cast<int*>(a[O + L.ng + 1]);
    for (i64 j = (d.join ? 0 : nb) + static_cast<i64>(b) * THREADS + x;
         j < d.out_cap; j += gstride) {
      if (d.join) valid[j] = j < total;
      if (j < nb) continue;
      qrow[j] = dead_qrow;
      for (int c = 0; c < L.ng; ++c)
        store_out(a, O + c, static_cast<int>(a[L.gathered_kind(c)]), j,
                  a[L.dead() + c]);
      store_out(a, O + L.ng, w_kind, j, 0);
    }
  }

  // the load-balanced expansion over warp tiles of the merged sequence
  const i64 len = d.n + nb;
  const i64 ntiles = (len + WARP_TILE - 1) / WARP_TILE;
  const unsigned chunk = static_cast<unsigned>(d.chunk);
  const unsigned m = static_cast<unsigned>(d.m);
  Staged& st = s.tile[warp];
  int* qrow_out = reinterpret_cast<int*>(a[O + L.ng + 1]);
  const void* qw = col_ptr(a, L.mask());
  const int qw_kind = static_cast<int>(a[L.q_kind(2 * L.nk)]);
  const int lw_kind = static_cast<int>(a[L.weights_kind()]);
  for (i64 wt = static_cast<i64>(b) * WARPS + warp; wt < ntiles;
       wt += static_cast<i64>(gridDim.x) * WARPS) {
    const i64 d0 = wt * WARP_TILE, d1 = min(len, d0 + WARP_TILE);
    // the pairs before each edge: the low half-warp's d0, the high's d1
    const i64 e = pairs_before(d, local, s.base, lane < 16 ? d0 : d1);
    const i64 p0 = __shfl_sync(FULL_MASK, e, 0);
    const i64 p1 = __shfl_sync(FULL_MASK, e, 16);
    // the slots at the tile's head may belong to the pair before p0
    const i64 ts = p0 > 0 ? p0 - 1 : 0;
    const int ne = static_cast<int>(p1 - ts);
    for (int u = lane; u < ne; u += 32) {
      const unsigned t = static_cast<unsigned>(ts + u);
      const i64 off = s.base[t / chunk] + local[t];
      const unsigned k = t / m;
      st.pos[u] = t + off;
      st.row0[u] = lo_of[t] - off;
      st.level[u] = static_cast<int>(k);
      st.qrow[u] = static_cast<int>(t - k * m);
    }
    __syncwarp();
    // this lane's items [dx, dx + ITEMS): slot slot[v] of the staged pair
    // e_of[v], or none (-1)
    const i64 dx = d0 + static_cast<i64>(lane) * ITEMS;
    i64 slot[ITEMS];
    int e_of[ITEMS];
    {
      int l = static_cast<int>(p0 - ts), h = ne;
      while (l < h) {  // the first staged pair at or past dx
        const int mid = (l + h) >> 1;
        if (st.pos[mid] < dx) l = mid + 1; else h = mid;
      }
#pragma unroll
      for (int v = 0; v < ITEMS; ++v) {
        const i64 p = dx + v;
        slot[v] = -1;
        e_of[v] = 0;
        if (p >= d1) continue;
        if (l < ne && st.pos[l] == p) {  // a range start
          ++l;
          continue;
        }
        const i64 j = p - (ts + l);  // items before p that are slots
        if (j < nb) {
          slot[v] = j;
          e_of[v] = l - 1;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < ITEMS; ++v)
      if (slot[v] >= 0) qrow_out[slot[v]] = st.qrow[e_of[v]];
    for (int c = 0; c < L.ng; ++c) {
      const int kind = static_cast<int>(a[L.gathered_kind(c)]);
      i64 val[ITEMS] = {};
#pragma unroll
      for (int v = 0; v < ITEMS; ++v)
        if (slot[v] >= 0)
          val[v] = load_widened(
              col_ptr(a, L.gathered(c, st.level[e_of[v]])), kind,
              st.row0[e_of[v]] + slot[v]);
#pragma unroll
      for (int v = 0; v < ITEMS; ++v)
        if (slot[v] >= 0) store_out(a, O + c, kind, slot[v], val[v]);
    }
    i64 w[ITEMS] = {};
#pragma unroll
    for (int v = 0; v < ITEMS; ++v)
      if (slot[v] >= 0)
        w[v] = load_widened(col_ptr(a, L.weights(st.level[e_of[v]])),
                            lw_kind, st.row0[e_of[v]] + slot[v]);
#pragma unroll
    for (int v = 0; v < ITEMS; ++v)
      if (slot[v] >= 0)
        store_out(a, O + L.ng, w_kind, slot[v],
                  d.join ? wrap_mul(load_widened(qw, qw_kind,
                                                 st.qrow[e_of[v]]),
                                    w[v])
                         : w[v]);
    __syncwarp();  // the next tile restages
  }
}

// the expansion's grid: a block per WARPS warp tiles of the largest merged
// sequence (every pair and out_cap slots), at most MAX_EXPAND_BLOCKS
unsigned int expand_grid(i64 n, i64 out_cap) {
  const i64 want = (n + out_cap + WARPS * WARP_TILE - 1) /
                   (WARPS * WARP_TILE);
  return static_cast<unsigned int>(want < MAX_EXPAND_BLOCKS
                                       ? want : MAX_EXPAND_BLOCKS);
}

// the probe's chunks: one per THREADS pairs, at most MAX_CHUNKS
int probe_chunks(i64 n) {
  const i64 want = (n + THREADS - 1) / THREADS;
  return static_cast<int>(want < MAX_CHUNKS ? want : MAX_CHUNKS);
}

template <class A>
int launch(const A& a, const Dims& d, i64* scratch, cudaStream_t stream) {
  consumer_probe_kernel<A><<<d.chunks, THREADS, 0, stream>>>(a, d, scratch);
  consumer_expand_kernel<A>
      <<<expand_grid(d.n, d.out_cap), THREADS, 0, stream>>>(a, d, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// slots of the argument block for K levels, nk key and ng gathered columns
int ladder_slots(int K, int nk, int ng) {
  return Layout{K, nk, ng}.n_slots();
}

// int64 scratch elements a call needs for K levels x m queries: per pair
// its range's first row and offset, per chunk its sum
i64 ladder_scratch_elems(int K, i64 m) {
  const i64 n = static_cast<i64>(K) * m;
  return 2 * n + probe_chunks(n);
}

// `args` holds the `n_args` host slots; `table`, when not null, is their
// device copy and is what the kernels read. `same_hi`: the upper queries
// are the lower ones. Returns cudaGetLastError() after the launches (0 on
// success), or cudaErrorInvalidValue for arguments the kernels do not
// take.
int ladder_consumer(const i64* args, int n_args, const i64* table, int K,
                    int nk, int ng, i64 m, i64 out_cap, int join,
                    int same_hi, i64* scratch, cudaStream_t stream) {
  const i64 n = static_cast<i64>(K) * m;
  if (K < 1 || nk < 1 || nk > MAX_COLS || ng < 0 || m < 1 || out_cap < 1 ||
      n > 0x7fffffffLL || !scratch ||
      n_args != Layout{K, nk, ng}.n_slots())
    return static_cast<int>(cudaErrorInvalidValue);
  Dims d{K, nk, ng, join, same_hi, probe_chunks(n), m, out_cap, n, 0};
  d.chunk = (n + d.chunks - 1) / d.chunks;
  if (table) return launch(ArgTable{table}, d, scratch, stream);
  return launch(args_by_value(args, n_args), d, scratch, stream);
}

}  // extern "C"
