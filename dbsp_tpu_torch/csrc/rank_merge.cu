// Rank-merge scatter: the inner loop of the sorted merge of two
// consolidated row sets.
//
// Replaces the Pallas `_rank_merge_kernel` behind `rank_merge_scatter`
// (dbsp_tpu/zset/pallas_kernels.py:495-548). Cross-ranks by binary search
// — an a-row counts the b-rows strictly less than it, a b-row counts the
// a-rows less than or equal to it — then each row, weight included, is
// written to its index plus its rank in one na + nb buffer. The netting
// and compaction tail stays in plain torch, as it stays XLA in the
// reference.
//
// What bounds it on an H100: every row is read once and written once
// ((ncols + 1) x 8 bytes each way), plus a dependent search chain of
// log2(other side) loads per row — memory- and latency-bound.
//
// Design. One thread per row of a and of b. The positions are a bijection
// onto [0, na + nb) (equal rows land adjacent, a's block first), so there
// are no write conflicts and no slot is left unwritten: the sentinel fill
// of the Pallas version is not needed.
//
// Argument block (ncols columns):
//   [c] a column c; [ncols] a weights; [ncols + 1 + c] b column c;
//   [2*ncols + 1] b weights; [2*ncols + 2 + c] output column c;
//   [3*ncols + 2] output weights
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <class A>
__global__ void rank_merge_kernel(A a, int ncols, i64 na, i64 nb) {
  const i64 t = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= na + nb) return;
  const int b0 = ncols + 1;
  const int out0 = 2 * ncols + 2;
  int src0;
  i64 row, pos;
  if (t < na) {
    row = t;
    src0 = 0;
    pos = row + lex_search<true>(a, b0, 1, 0, ncols, nb, row);
  } else {
    row = t - na;
    src0 = b0;
    pos = row + lex_search<false>(a, 0, 1, b0, ncols, na, row);
  }
  for (int c = 0; c <= ncols; ++c)  // c == ncols: the weights
    out_col(a, out0 + c)[pos] = in_col(a, src0 + c)[row];
}

}  // namespace

extern "C" {

// `args` holds the `n_args` host slots; `table`, when not null, is their
// device copy and is what the kernel reads. Returns cudaGetLastError()
// after the launch (0 on success).
int rank_merge(const i64* args, int n_args, const i64* table, int ncols,
               i64 na, i64 nb, cudaStream_t stream) {
  if (na + nb > 0) {
    const unsigned int blocks = blocks_for(na + nb, THREADS);
    if (table)
      rank_merge_kernel<<<blocks, THREADS, 0, stream>>>(ArgTable{table},
                                                        ncols, na, nb);
    else
      rank_merge_kernel<<<blocks, THREADS, 0, stream>>>(
          args_by_value(args, n_args), ncols, na, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
