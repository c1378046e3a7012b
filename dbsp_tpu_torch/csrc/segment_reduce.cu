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
// What bounds it on an H100: it reads n rows once (the value columns the
// spec names, weight and segment id: 8 bytes each) and writes nseg values
// per op — memory-bound, with atomic contention on hot segments as the
// second limit.
//
// Design. The TPU kernel compares every row with a block of 128 segment
// ids (O(segments x rows) work, to avoid scatters). Here each row updates
// its segment with 64-bit atomics instead: atomicAdd on unsigned long long
// (which wraps exactly like the int64 sums of the reference),
// atomicMin/atomicMax on long long. Integer atomics commute, so the result
// does not depend on their order and is exact. Three passes on one stream:
// fill each output with its op's identity, one thread per row, and one
// thread per segment to finish avg.
//
// Argument block (nv value columns, nops ops):
//   [c] value column c (c < nv); [nv] weights; [nv + 1] segment ids
//   [nv + 2 + 3*o + {0,1,2}] op o: opcode, source column, identity
//   [nv + 2 + 3*nops + o] output of op o
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
enum Op { COUNT = 0, SUM = 1, MIN = 2, MAX = 3, AVG = 4, PRESENT = 5 };

struct Layout {
  int nv, nops;
  __host__ __device__ int op(int o) const { return nv + 2 + 3 * o; }
  __host__ __device__ int out(int o) const { return nv + 2 + 3 * nops + o; }
};

template <class A>
__global__ void fill_kernel(A a, Layout L, i64 nseg, i64* wsum) {
  const i64 s = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  for (int o = 0; o < L.nops; ++o) out_col(a, L.out(o))[s] = a[L.op(o) + 2];
  wsum[s] = 0;
}

template <class A>
__global__ void rows_kernel(A a, Layout L, i64 n, i64 nseg, int any_avg,
                            i64* wsum) {
  const i64 r = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const i64 s = in_col(a, L.nv + 1)[r];
  if (s < 0 || s >= nseg) return;
  const i64 w = in_col(a, L.nv)[r];
  const i64 wpos = w > 0 ? w : 0;
  for (int o = 0; o < L.nops; ++o) {
    const int code = static_cast<int>(a[L.op(o)]);
    const int col = static_cast<int>(a[L.op(o) + 1]);
    i64* out = out_col(a, L.out(o)) + s;
    switch (code) {
      case COUNT:
        atomicAdd(reinterpret_cast<u64*>(out), static_cast<u64>(wpos));
        break;
      case SUM:
      case AVG:  // the sum now; fin_avg_kernel divides
        atomicAdd(reinterpret_cast<u64*>(out),
                  static_cast<u64>(wrap_mul(in_col(a, col)[r], wpos)));
        break;
      case MIN:
        if (w > 0) atomicMin(out, in_col(a, col)[r]);
        break;
      case MAX:
        if (w > 0) atomicMax(out, in_col(a, col)[r]);
        break;
      default:  // PRESENT
        atomicMax(out, static_cast<i64>(w > 0));
        break;
    }
  }
  if (any_avg) atomicAdd(reinterpret_cast<u64*>(wsum + s),
                         static_cast<u64>(wpos));
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
void launch(const A& a, const Layout& L, i64 n, i64 nseg, int any_avg,
            i64* wsum, cudaStream_t stream) {
  fill_kernel<<<blocks_for(nseg, THREADS), THREADS, 0, stream>>>(a, L, nseg,
                                                                 wsum);
  if (n > 0)
    rows_kernel<<<blocks_for(n, THREADS), THREADS, 0, stream>>>(
        a, L, n, nseg, any_avg, wsum);
  if (any_avg)
    fin_avg_kernel<<<blocks_for(nseg, THREADS), THREADS, 0, stream>>>(
        a, L, nseg, wsum);
}

}  // namespace

extern "C" {

// `args` holds the `n_args` host slots; `table`, when not null, is their
// device copy and is what the kernels read. Returns cudaGetLastError()
// after the launches (0 on success). `wsum` is int64 scratch of nseg
// elements.
int segment_reduce(const i64* args, int n_args, const i64* table, int nv,
                   int nops, i64 n, i64 nseg, int any_avg, i64* wsum,
                   cudaStream_t stream) {
  const Layout L{nv, nops};
  if (table)
    launch(ArgTable{table}, L, n, nseg, any_avg, wsum, stream);
  else
    launch(args_by_value(args, n_args), L, n, nseg, any_avg, wsum, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
