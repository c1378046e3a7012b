// Shared pieces of the port's hand-written Hopper kernels: the argument
// block every launch takes, and the lexicographic binary search that
// replaces the Pallas `_lex_search` (dbsp_tpu/zset/pallas_kernels.py:102).
//
// Every column reaches a kernel as an int64 device pointer; the Python
// wrapper widens narrower integer and bool columns first, as the Pallas
// wrappers do. Pointers and small integers travel in one argument block
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
