// Shared pieces of the port's hand-written Hopper kernels: the argument
// block every launch takes, and the lexicographic binary search that
// replaces the Pallas `_lex_search` (dbsp_tpu/zset/pallas_kernels.py:102).
//
// A column reaches the ladder consumer as an int64 device pointer: its
// wrappers widen narrower integer and bool columns first, as the Pallas
// wrappers do. The lex probe, segment reduce and the rank merge read (and
// the merge writes) each column at its own width instead, with its
// `ColKind` in the argument block; they widen every value to int64 as
// they load it, so their compares and sums are the same int64 ones.
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
__device__ __forceinline__ const i64* in_col(const A& a, int slot) {
  return reinterpret_cast<const i64*>(a[slot]);
}

template <class A>
__device__ __forceinline__ const void* col_ptr(const A& a, int slot) {
  return reinterpret_cast<const void*>(a[slot]);
}

template <class A>
__device__ __forceinline__ i64* out_col(const A& a, int slot) {
  return reinterpret_cast<i64*>(a[slot]);
}

// Insertion point of query row `qi` into the sorted table rows [0, n):
// table column c lives in slot tab0 + c * tab_stride, query column c in
// slot q0 + c. STRICT counts the rows < query (side "left"); otherwise the
// rows <= query (side "right"). The loop runs to convergence, so the
// result equals the fixed-step search of the reference bit for bit.
template <bool STRICT, class A>
__device__ i64 lex_search(const A& a, int tab0, int tab_stride, int q0,
                          int ncols, i64 n, i64 qi) {
  i64 q[MAX_COLS];
  for (int c = 0; c < ncols; ++c) q[c] = in_col(a, q0 + c)[qi];
  i64 lo = 0, hi = n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    int cmp = 0;  // sign of table[mid] - query, lexicographic
    for (int c = 0; c < ncols; ++c) {
      const i64 t = in_col(a, tab0 + c * tab_stride)[mid];
      if (t != q[c]) {
        cmp = t < q[c] ? -1 : 1;
        break;
      }
    }
    const bool go_right = STRICT ? (cmp < 0) : (cmp <= 0);
    if (go_right) lo = mid + 1; else hi = mid;
  }
  return lo;
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

__device__ __forceinline__ i64 wrap_neg(i64 x) {
  return static_cast<i64>(0ull - static_cast<u64>(x));
}

static inline unsigned int blocks_for(i64 n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}
