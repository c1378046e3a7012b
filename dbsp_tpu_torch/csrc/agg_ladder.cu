// The compiled aggregate's whole chain in one launch: agg_ladder.
//
// Replaces `agg_ladder_pallas` (dbsp_tpu/zset/pallas_kernels.py:472), the
// chain the reference composes from its gather and segment-reduce
// kernels, and computes what the reference's `cursor.agg_ladder`
// (dbsp_tpu/zset/cursor.py:377-491) returns: (qkeys, qlive, nq, old_vals,
// old_present, lad_vals, lad_present, d_vals, d_present, gather_total)
// for one consolidated delta, the operator's out trace and the input
// trace's ladder of sorted levels:
//   * the delta's distinct live keys (a row heads a group when its weight
//     is non-zero and its keys differ from the row before's, whatever
//     that row's weight), packed in order; `nq` is their unclamped count,
//     slots from nq on hold the key sentinel;
//   * the previous outputs: per live query the out trace's rows of its
//     key, per column the max over rows with w > 0, present if any row
//     has w > 0 (the `_TupleMax` contract); raw rows are counted in query
//     order and stop at q_cap, as the one-level gather clamps them;
//   * the ladder history, only when the runtime gate `flag` is on: per
//     (level, query) the level's rows of the query's key, clamped at
//     gather_cap in level-major order (the ladder gather's expansion
//     order), `gather_total` the unclamped count; per query the rows of
//     all levels netted by value row (a consolidation of the gathered
//     rows; one level is not netted) and folded into the spec's ops;
//   * on the fast path, the delta's own reduction per group, the group of
//     a row being its head's query index (groups past q_cap dropped).
// Ops: count and sum take max(w, 0); min and max only rows with w > 0;
// avg is the truncating quotient of wrapping int64 sums by max(count, 1);
// present is the max of (w > 0). An empty output holds its op's identity
// of its source dtype; every output is stored at its own dtype.
//
// What bounds it on an H100: bytes. It must read the delta once (keys,
// weights, the spec's value columns), per live query the top of a binary
// search of the out trace (and, with the gate on, of each level) and the
// matched rows, and write q_cap-wide outputs. On the main path (q4's
// compiled aggregate, gate off) that is about 19 MB: some 0.006 ms.
//
// Design: ONE cooperative launch of a persistent grid (no more blocks
// than fit on the card at once, from the occupancy API), with a grid-wide
// barrier between four phases, so the chain's 135 device ops of tensor
// code become one. Every block owns a contiguous chunk of the delta's
// 1,024-row tiles and a contiguous range of the q_cap query slots.
//   A. Fill the fast path's int64 accumulators with their identities;
//      count the group heads of the block's chunk.
//   B. The block's first query index is the sum of the counts of the
//      blocks before it (the scan's look-back, done after the barrier).
//      Per tile, a block scan of the heads gives every row its group j:
//      a head writes its key to qkeys[j] and its row to a scratch list;
//      on the fast path the rows fold into the accumulators with
//      segment reduce's run-wise fold (common.cuh `fold_runs`): the delta
//      is sorted by group, so a tile makes one atomic per op per run of
//      one group, and a large group costs no thread more than its rows
//      in the tile.
//   C. A thread per query probes the out trace (and, with the gate on,
//      every level): a lower-bound search, then a gallop over the run of
//      rows equal to the key; the block sums each level's counts.
//   D. Per level, the block's offset in level-major order comes from the
//      sums of the blocks before it and of the levels before; a block
//      scan per level over its queries clamps every range at its cap.
//      Then a thread per query folds its previous outputs, K-way merges
//      its levels' clamped ranges by value row, netting equal rows as it
//      walks (one level is folded row by row), and finishes the fast
//      path's accumulators; every output slot is written, so nothing is
//      filled beforehand.
// The gate is read on the device; no value goes to the host. Columns are
// read at their own width (`ColKind`). Outputs and scratch are views of
// one int64 buffer the wrapper allocates.
//
// Argument block (K levels, nk key columns, nv value columns in the delta
// and in every level, nops spec ops; nd = nl = nk + nv + 1 columns with
// the weights last, no = nk + nops + 1 for the out trace):
//   [c]               delta column c (c < nd)
//   O0 = nd:          [O0 + c] out-trace column c (c < no)
//   L0 = O0 + no:     [L0 + c*K + k] column c of level k (c < nl)
//   C0 = L0 + nl*K:   [C0 + k] row count of level k
//   KD = C0 + K:      [KD + c] ColKind of delta column c
//   KO = KD + nd:     [KO + c] ColKind of out-trace column c
//   KL = KO + no:     [KL + c] ColKind of level column c (every level)
//   OP = KL + nl:     [OP + 4*o + {0,1,2,3}] op o: opcode, source column,
//                     identity over the delta's column, over the levels'
//   SN = OP + 4*nops: [SN + c] key column c's sentinel
//   OI = SN + nk:     [OI + c] identity of old output c (its dtype's min)
//   R0 = OI + nops:   outputs, in the order of the 10-tuple: qkeys (nk),
//                     qlive, nq, old (nops), old_present, lad (nops),
//                     lad_present, d (nops), d_present, gather_total
//   RK = R0 + nout:   [RK + x] ColKind of output x (nout = nk + 6 + 3*nops)
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = RUN_ITEMS;  // consecutive delta rows per thread
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr int G = 2;  // delta ops folded per pass over a tile
// blocks per SM the register budget must allow
constexpr int MIN_BLOCKS = 2;
// most spec ops a call takes (AGG_MAX_OPS in zset/cuda_kernels.py)
constexpr int MAX_OPS = 16;
// fewest query slots worth a block of their own
constexpr int QUERIES_PER_BLOCK = 64;
// present's identity: int64's min
constexpr i64 PRESENT_IDENT = -9223372036854775807LL - 1;

struct Dims {
  int K, nk, nv, nops, fast, avg, grid;
  i64 m, ocap, q_cap, qn, gcap;
};

struct Layout {
  int K, nk, nv, nops, nd, no, nl;
  int O0, L0, C0, KD, KO, KL, OP, SN, OI, R0, nout, RK;
  __host__ __device__ explicit Layout(const Dims& d)
      : K(d.K), nk(d.nk), nv(d.nv), nops(d.nops), nd(d.nk + d.nv + 1),
        no(d.nk + d.nops + 1), nl(d.nk + d.nv + 1) {
    O0 = nd;
    L0 = O0 + no;
    C0 = L0 + nl * K;
    KD = C0 + K;
    KO = KD + nd;
    KL = KO + no;
    OP = KL + nl;
    SN = OP + 4 * nops;
    OI = SN + nk;
    R0 = OI + nops;
    nout = nk + 6 + 3 * nops;
    RK = R0 + nout;
  }
  // outputs, relative to R0 (their pointers) and RK (their kinds)
  __host__ __device__ int qkey(int c) const { return c; }
  __host__ __device__ int qlive() const { return nk; }
  __host__ __device__ int nq() const { return nk + 1; }
  __host__ __device__ int old(int c) const { return nk + 2 + c; }
  __host__ __device__ int old_present() const { return nk + 2 + nops; }
  __host__ __device__ int lad(int o) const { return nk + 3 + nops + o; }
  __host__ __device__ int lad_present() const { return nk + 3 + 2 * nops; }
  __host__ __device__ int dv(int o) const { return nk + 4 + 2 * nops + o; }
  __host__ __device__ int d_present() const { return nk + 4 + 3 * nops; }
  __host__ __device__ int gtot() const { return nk + 5 + 3 * nops; }
};

// The int64 scratch: per block its head count; per (table, block) the
// probe counts' sum; per (block, table) its offset and the tables' totals
// (phase D); per query slot its head's delta row; per (table, query) the
// matched range (table 0: the out trace; table 1 + k: level k); the fast
// path's accumulators, one row of q_cap per op, then present, then avg's
// weight sum.
struct Scratch {
  i64 *heads, *sums, *pre, *tot, *urow, *lo, *end, *dacc;
  __host__ __device__ Scratch(i64* base, const Dims& d) {
    const i64 K1 = d.K + 1;
    heads = base;
    sums = heads + d.grid;
    pre = sums + d.grid * K1;
    tot = pre + d.grid * K1;
    urow = tot + d.grid * K1;
    lo = urow + d.q_cap;
    end = lo + K1 * d.q_cap;
    dacc = end + K1 * d.q_cap;
  }
  static i64 elems(const Dims& d) {
    const i64 K1 = d.K + 1;
    return d.grid * (1 + 3 * K1) + d.q_cap * (1 + 2 * K1) +
           (d.fast ? (d.nops + 2) * d.q_cap : 0);
  }
};

// delta row r heads a group
template <class A>
__device__ bool is_head(const A& a, const Layout& L, i64 r, i64 w) {
  if (w == 0) return false;
  if (r == 0) return true;
  for (int c = 0; c < L.nk; ++c)
    if (col_at(a, c, L.KD + c, r) != col_at(a, c, L.KD + c, r - 1))
      return true;
  return false;
}

// op o of the fast path's reduction: the spec's ops, then present, then
// avg's weight sum where the spec has an avg; NOP past them
template <class A>
__device__ __forceinline__ OpRef d_op(const A& a, const Layout& L,
                                      const Dims& d, const Scratch& S,
                                      int o) {
  i64* out = S.dacc + static_cast<i64>(o) * d.q_cap;
  if (o < L.nops)
    return {static_cast<int>(a[L.OP + 4 * o]),
            static_cast<int>(a[L.OP + 4 * o + 1]), a[L.OP + 4 * o + 2], out};
  if (o == L.nops) return {PRESENT, 0, PRESENT_IDENT, out};
  if (o == L.nops + 1 && d.avg) return {WSUM, 0, 0, out};
  return {NOP, 0, 0, nullptr};
}

// a value as its kind stores it (a weight sum netted at the weights'
// width wraps there, as the consolidation's sum does)
__device__ __forceinline__ i64 as_kind(int kind, i64 v) {
  switch (kind) {
    case KIND_I32: return static_cast<int>(v);
    case KIND_I16: return static_cast<short>(v);
    case KIND_I8: return static_cast<signed char>(v);
    case KIND_U8: return static_cast<unsigned char>(v);
    case KIND_BOOL: return v != 0;
    default: return v;
  }
}

// The ladder's ops over the netted rows of one query: per op its partial,
// avg's count, and whether any row had w > 0.
struct LadderFold {
  i64 acc[MAX_OPS];
  i64 count = 0;
  bool any = false;

  template <class A>
  __device__ void init(const A& a, const Layout& L) {
    for (int o = 0; o < L.nops; ++o) acc[o] = a[L.OP + 4 * o + 3];
  }

  // one row of values `v` (its columns) with net weight w
  template <class A>
  __device__ void add(const A& a, const Layout& L, const i64* v, i64 w) {
    const i64 wpos = w > 0 ? w : 0;
    any |= w > 0;
    count = wrap_add(count, wpos);
    for (int o = 0; o < L.nops; ++o) {
      const int code = static_cast<int>(a[L.OP + 4 * o]);
      const i64 x = reads_value(code) ? v[a[L.OP + 4 * o + 1]] : 0;
      const OpRef op{code, 0, a[L.OP + 4 * o + 3], nullptr};
      if ((code != MIN && code != MAX) || w > 0)
        acc[o] = combine(code, acc[o], contrib(op, x, w));
    }
  }
};

template <class A>
__device__ __forceinline__ void store_out(const A& a, const Layout& L,
                                          int x, i64 j, i64 v) {
  store_narrowed(reinterpret_cast<void*>(a[L.R0 + x]),
                 static_cast<int>(a[L.RK + x]), j, v);
}

template <class A>
__launch_bounds__(THREADS, MIN_BLOCKS) __global__
void agg_ladder_kernel(A a, Dims d, const unsigned char* flag,
                       i64* scratch) {
  __shared__ RunScan<G, THREADS> scan;
  __shared__ i64 warp_sums[WARPS];
  __shared__ i64 edge_first[THREADS], edge_last[THREADS];
  cg::grid_group grid = cg::this_grid();
  const Layout L(d);
  const Scratch S(scratch, d);
  const int b = blockIdx.x, t = threadIdx.x, K1 = d.K + 1;
  const i64 gtid = static_cast<i64>(b) * THREADS + t;
  const i64 gstride = static_cast<i64>(d.grid) * THREADS;
  const i64 ntiles = (d.m + TILE - 1) / TILE;
  const i64 per_block = (ntiles + d.grid - 1) / d.grid;
  const i64 tile0 = min(ntiles, b * per_block);
  const i64 tile1 = min(ntiles, tile0 + per_block);
  const void* dw = col_ptr(a, L.nd - 1);
  const int dw_kind = static_cast<int>(a[L.KD + L.nd - 1]);
  i64 total;

  // -- A: the accumulators' identities; the chunk's group heads ----------
  const int nd_ops = L.nops + 1 + d.avg;
  if (d.fast)
    for (i64 e = gtid; e < static_cast<i64>(nd_ops) * d.q_cap; e += gstride)
      S.dacc[e] = d_op(a, L, d, S, static_cast<int>(e / d.q_cap)).ident;
  i64 heads = 0;
  for (i64 tile = tile0; tile < tile1; ++tile) {
    const i64 r0 = tile * TILE + t * ITEMS;
    i64 w[ITEMS];
    load_rows(dw, dw_kind, r0, d.m, w);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      heads += r0 + i < d.m && is_head(a, L, r0 + i, w[i]);
  }
  block_scan<THREADS>(heads, warp_sums, &total);
  if (t == 0) S.heads[b] = total;
  grid.sync();

  // -- B: every row's group; qkeys; the fast path's fold -------------------
  i64 base = 0, nq = 0;
  for (int i = t; i < d.grid; i += THREADS) {
    const i64 h = S.heads[i];
    base += i < b ? h : 0;
    nq += h;
  }
  block_scan<THREADS>(base, warp_sums, &base);
  block_scan<THREADS>(nq, warp_sums, &nq);
  if (b == 0 && t == 0) store_out(a, L, L.nq(), 0, nq);
  for (i64 tile = tile0; tile < tile1; ++tile) {
    const i64 r0 = tile * TILE + t * ITEMS;
    i64 w[ITEMS], id[ITEMS];
    bool head[ITEMS];
    load_rows(dw, dw_kind, r0, d.m, w);
    int n_heads = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      head[i] = r0 + i < d.m && is_head(a, L, r0 + i, w[i]);
      n_heads += head[i];
    }
    i64 j = base + block_scan<THREADS>(n_heads, warp_sums, &total) - 1;
    base += total;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      j += head[i];
      if (head[i] && j < d.q_cap) {  // a group past q_cap is not kept
        S.urow[j] = r0 + i;
        for (int c = 0; c < L.nk; ++c)
          store_out(a, L, L.qkey(c), j, col_at(a, c, L.KD + c, r0 + i));
      }
      id[i] = r0 + i < d.m && j >= 0 && j < d.q_cap ? j : DROPPED;
    }
    if (!d.fast) continue;
    edge_first[t] = id[0];
    edge_last[t] = id[ITEMS - 1];
    __syncthreads();
    const i64 before_id = t == 0 ? NO_ROW : edge_last[t - 1];
    const i64 after_id = t == THREADS - 1 ? NO_ROW : edge_first[t + 1];
    for (int g0 = 0; g0 < nd_ops; g0 += G) {
      OpRef op[G];
      i64 c[G][ITEMS];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        op[g] = d_op(a, L, d, S, g0 + g);
        i64 v[ITEMS] = {0, 0, 0, 0};
        if (reads_value(op[g].code))
          load_rows(col_ptr(a, L.nk + op[g].col),
                    static_cast<int>(a[L.KD + L.nk + op[g].col]), r0, d.m,
                    v);
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) c[g][i] = contrib(op[g], v[i], w[i]);
      }
      fold_runs<G, THREADS>(id, before_id, after_id, op, c, scan);
    }
  }
  grid.sync();

  // -- C: each live query's range in the out trace and in every level -----
  const i64 nq_live = min(nq, d.qn);
  const bool gate = flag[0] != 0;
  const i64 q_per_block = (d.q_cap + d.grid - 1) / d.grid;
  const i64 q0 = min(d.q_cap, b * q_per_block);
  const i64 q1 = min(d.q_cap, q0 + q_per_block);
  for (int k = 0; k < K1; ++k) {
    const bool probe = k == 0 || gate;
    // table k: the out trace, or level k - 1
    const int t0 = k == 0 ? L.O0 : L.L0 + (k - 1);
    const int ts = k == 0 ? 1 : d.K;
    const int tk = k == 0 ? L.KO : L.KL;
    const i64 n = k == 0 ? d.ocap : a[L.C0 + k - 1];
    i64 sum = 0;
    for (i64 j = q0 + t; j < q1; j += THREADS) {
      i64 lo = 0, cnt = 0;
      if (probe && j < nq_live) {
        i64 q[MAX_COLS];
        const i64 r = S.urow[j];
        for (int c = 0; c < L.nk; ++c) q[c] = col_at(a, c, L.KD + c, r);
        cnt = equal_range(a, t0, ts, tk, L.nk, n, q, &lo);
      }
      S.lo[k * d.q_cap + j] = lo;
      S.end[k * d.q_cap + j] = cnt;
      sum += cnt;
    }
    block_scan<THREADS>(sum, warp_sums, &total);
    if (t == 0) S.sums[static_cast<i64>(k) * d.grid + b] = total;
  }
  grid.sync();

  // -- D: clamp, fold, finish ---------------------------------------------
  i64* pre = S.pre + static_cast<i64>(b) * K1;
  i64* tot = S.tot + static_cast<i64>(b) * K1;
  for (int k = 0; k < K1; ++k) {  // table k's total, and its blocks' before b
    const i64* sums = S.sums + static_cast<i64>(k) * d.grid;
    i64 all = 0, before = 0;
    for (int i = t; i < d.grid; i += THREADS) {
      all += sums[i];
      before += i < b ? sums[i] : 0;
    }
    block_scan<THREADS>(all, warp_sums, &all);
    block_scan<THREADS>(before, warp_sums, &before);
    if (t == 0) {
      tot[k] = all;
      pre[k] = before;
    }
  }
  __syncthreads();
  // level-major: a level's ranges start after every earlier level's
  for (int k = t + 1; k < K1; k += THREADS)
    for (int e = 1; e < k; ++e) pre[k] += tot[e];
  if (b == 0 && t == 0) {
    i64 gathered = 0;
    for (int k = 1; k < K1; ++k) gathered += tot[k];
    store_out(a, L, L.gtot(), 0, gathered);
  }
  __syncthreads();
  const int lw_slot = L.L0 + (L.nl - 1) * d.K;
  const int lw_kind = static_cast<int>(a[L.KL + L.nl - 1]);
  for (i64 jb = q0; jb < q1; jb += THREADS) {
    const i64 j = jb + t;
    const bool valid = j < q1;
    for (int k = 0; k < K1; ++k) {
      const i64 x = k * d.q_cap + j;
      const i64 cnt = valid ? S.end[x] : 0;
      const i64 start = pre[k];  // read before thread 0 moves it
      const i64 off = start + block_scan<THREADS>(cnt, warp_sums, &total);
      if (t == 0) pre[k] = start + total;
      const i64 room = (k == 0 ? d.q_cap : d.gcap) - off;
      const i64 take = room <= 0 ? 0 : (cnt < room ? cnt : room);
      if (valid) S.end[x] = S.lo[x] + take;
    }
    if (!valid) continue;
    if (j < d.qn) {
      store_out(a, L, L.qlive(), j, j < nq_live);
      if (j >= nq_live)
        for (int c = 0; c < L.nk; ++c)
          store_out(a, L, L.qkey(c), j, a[L.SN + c]);
    }
    // previous outputs: per column the max over rows with w > 0
    {
      i64 best[MAX_OPS];
      for (int c = 0; c < L.nops; ++c) best[c] = a[L.OI + c];
      bool present = false;
      const int ow = L.O0 + L.no - 1;
      for (i64 r = S.lo[j]; r < S.end[j]; ++r) {
        if (col_at(a, ow, L.KO + L.no - 1, r) <= 0) continue;
        present = true;
        for (int c = 0; c < L.nops; ++c) {
          const i64 v = col_at(a, L.O0 + L.nk + c, L.KO + L.nk + c, r);
          best[c] = v > best[c] ? v : best[c];
        }
      }
      for (int c = 0; c < L.nops; ++c) store_out(a, L, L.old(c), j, best[c]);
      store_out(a, L, L.old_present(), j, present);
    }
    // the ladder history: the levels' clamped ranges, netted by value row
    {
      LadderFold f;
      f.init(a, L);
      i64 v[MAX_COLS];
      auto load_vals = [&](int k, i64 r) {
        for (int c = 0; c < L.nv; ++c)
          v[c] = col_at(a, L.L0 + (L.nk + c) * d.K + k, L.KL + L.nk + c, r);
      };
      if (d.K == 1) {  // one level holds no duplicate to net
        for (i64 r = S.lo[d.q_cap + j]; r < S.end[d.q_cap + j]; ++r) {
          load_vals(0, r);
          f.add(a, L, v, load_widened(col_ptr(a, lw_slot), lw_kind, r));
        }
      } else {
        for (;;) {
          // the least value row any level's range is at
          int kmin = -1;
          for (int k = 0; k < d.K; ++k) {
            const i64 x = (k + 1) * d.q_cap + j, r = S.lo[x];
            if (r >= S.end[x]) continue;
            if (kmin < 0 || cmp_row(a, L.L0 + L.nk * d.K + k, d.K,
                                    L.KL + L.nk, L.nv, r, v) < 0) {
              load_vals(k, r);
              kmin = k;
            }
          }
          if (kmin < 0) break;
          // every level's rows equal to it, netted
          i64 w = 0;
          for (int k = 0; k < d.K; ++k) {
            const i64 x = (k + 1) * d.q_cap + j;
            i64 r = S.lo[x];
            const i64 e = S.end[x];
            for (; r < e && cmp_row(a, L.L0 + L.nk * d.K + k, d.K,
                                    L.KL + L.nk, L.nv, r, v) == 0; ++r)
              w = wrap_add(w, load_widened(col_ptr(a, lw_slot + k), lw_kind,
                                           r));
            S.lo[x] = r;
          }
          w = as_kind(lw_kind, w);
          if (w != 0) f.add(a, L, v, w);  // a zero-net row is dropped
        }
      }
      for (int o = 0; o < L.nops; ++o) {
        const bool avg = a[L.OP + 4 * o] == AVG;
        store_out(a, L, L.lad(o), j,
                  avg ? avg_div(f.acc[o], f.count > 1 ? f.count : 1)
                      : f.acc[o]);
      }
      store_out(a, L, L.lad_present(), j, f.any);
    }
    // the fast path's reduction, finished
    if (d.fast) {
      const i64 c = d.avg ? S.dacc[(L.nops + 1) * d.q_cap + j] : 1;
      for (int o = 0; o < L.nops; ++o) {
        const i64 x = S.dacc[o * d.q_cap + j];
        store_out(a, L, L.dv(o), j,
                  a[L.OP + 4 * o] == AVG ? avg_div(x, c > 1 ? c : 1) : x);
      }
      store_out(a, L, L.d_present(), j, S.dacc[L.nops * d.q_cap + j] > 0);
    }
  }
}

// blocks of the kernel that fit on the current device at once (the
// smaller of the two argument-block instances), cached per device
int coresident() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int sms = 0, by_value = 0, by_table = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &by_value, agg_ladder_kernel<Args>, THREADS, 0);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &by_table, agg_ladder_kernel<ArgTable>, THREADS, 0);
    cached[dev] = sms * (by_value < by_table ? by_value : by_table);
  }
  return cached[dev];
}

// the grid of a call: a block per tile of the delta or per
// QUERIES_PER_BLOCK query slots, whichever asks more, and no more than
// fit at once (0 when none fits)
int plan_grid(i64 m, i64 q_cap) {
  const i64 tiles = (m + TILE - 1) / TILE;
  const i64 slots = (q_cap + QUERIES_PER_BLOCK - 1) / QUERIES_PER_BLOCK;
  const i64 want = tiles > slots ? tiles : (slots > 1 ? slots : 1);
  const int fit = coresident();
  return static_cast<int>(want < fit ? want : fit);
}

template <class A>
int launch(A a, Dims d, const unsigned char* flag, i64* scratch,
           cudaStream_t stream) {
  void* params[] = {&a, &d, &flag, &scratch};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(agg_ladder_kernel<A>), dim3(d.grid),
      dim3(THREADS), params, 0, stream));
}

}  // namespace

extern "C" {

// int64 scratch elements a call needs (the kernel's grid depends on the
// delta's rows m and on q_cap); -1 when no block of the kernel fits on
// the current device.
i64 agg_ladder_scratch_elems(int K, int nops, i64 m, i64 q_cap, int fast) {
  Dims d{};
  d.K = K;
  d.nops = nops;
  d.q_cap = q_cap;
  d.fast = fast;
  d.grid = plan_grid(m, q_cap);
  return d.grid > 0 ? Scratch::elems(d) : -1;
}

// `args` holds the `n_args` host slots; `table`, when not null, is their
// device copy and is what the kernel reads. `flag` is the gate (one bool
// on the device), `scratch` agg_ladder_scratch_elems() int64 elements.
// Returns the launch's CUDA error (0 on success), or cudaErrorInvalidValue
// for arguments the kernel does not take.
int agg_ladder(const i64* args, int n_args, const i64* table, int K, int nk,
               int nv, int nops, i64 m, i64 ocap, i64 q_cap, i64 qn,
               i64 gcap, int fast, int avg, const unsigned char* flag,
               i64* scratch, cudaStream_t stream) {
  if (K < 1 || nk < 1 || nk > MAX_COLS || nv < 0 || nv > MAX_COLS ||
      nops < 1 || nops > MAX_OPS || m < 1 || q_cap < 1 || gcap < 1 ||
      qn < 1 || qn > q_cap || !flag || !scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{K, nk, nv, nops, fast, avg, plan_grid(m, q_cap),
               m, ocap, q_cap, qn, gcap};
  if (d.grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (table) return launch(ArgTable{table}, d, flag, scratch, stream);
  return launch(args_by_value(args, n_args), d, flag, scratch, stream);
}

}  // extern "C"
