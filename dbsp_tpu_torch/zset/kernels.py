"""Low-level Z-set kernels over flat ``[cap]`` columns, in plain PyTorch.

Counterpart of ``dbsp_tpu/zset/kernels.py``. Row validity is carried by the
weight column (weight == 0 <=> dead row); dead rows hold per-dtype sentinel
keys (the dtype's max value, ``True`` for bool) so one ascending sort moves
them to the end.

Every function here works on tensors of any device. The rank-merge inner
loop is the one place a hand-written kernel takes over: on a CUDA tensor
:func:`merge_sorted_cols` launches the CUDA rank-merge scatter
(``cuda_kernels.rank_merge_scatter``), on a CPU tensor its plain version.
The netting and compaction tail stays plain torch on every device, as it
stays XLA in the reference.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

Cols = Tuple[torch.Tensor, ...]


# ---------------------------------------------------------------------------
# Sentinels
# ---------------------------------------------------------------------------


def sentinel_scalar(dtype: torch.dtype):
    """Largest representable value of ``dtype`` — the dead-row sentinel."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def sentinel_fill(shape, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.full(shape, sentinel_scalar(dtype), dtype=dtype,
                      device=device)


# ---------------------------------------------------------------------------
# Row-wise lexicographic sort
# ---------------------------------------------------------------------------


def sort_rows(cols: Sequence[torch.Tensor], payload: Sequence[torch.Tensor]
              ) -> Tuple[Cols, Cols]:
    """Stable ascending lexicographic sort by ``cols``; ``payload`` rides
    along. ``lax.sort(num_keys=k, is_stable=True)`` has no torch twin, so
    the order is built from successive stable sorts, last key first: each
    pass keeps the order of the later keys among equal earlier keys."""
    if not cols:
        return (), tuple(payload)
    perm = torch.arange(cols[0].shape[0], device=cols[0].device)
    for c in reversed(cols):
        key = c[perm]
        if key.dtype == torch.bool:
            key = key.to(torch.uint8)
        perm = perm[torch.sort(key, stable=True).indices]
    return tuple(c[perm] for c in cols), tuple(p[perm] for p in payload)


def _col_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element equality under the sort's total order: NaN == NaN."""
    eq = a == b
    if a.dtype.is_floating_point:
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    return eq


def rows_equal_prev(cols: Sequence[torch.Tensor], n: int,
                    device=None) -> torch.Tensor:
    """For sorted columns: mask[i] = row i equals row i-1 (mask[0] = False).
    With zero columns every row is the unit row, hence equal; ``device``
    places that mask (default: the columns' device). Built without a
    scalar write into a device tensor (a host-to-device copy, a sync on
    the card)."""
    if not cols:
        return torch.arange(n, device=device) > 0
    dev = cols[0].device
    rest = torch.ones((max(n - 1, 0),), dtype=torch.bool, device=dev)
    for c in cols:
        rest &= _col_eq(c[1:], c[:-1])
    return torch.cat([torch.zeros((min(n, 1),), dtype=torch.bool,
                                  device=dev), rest])


# ---------------------------------------------------------------------------
# Segment sums (jax.ops.segment_* semantics: out-of-range ids are dropped)
# ---------------------------------------------------------------------------


def _trash_ids(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    ok = (seg >= 0) & (seg < num_segments)
    return torch.where(ok, seg, num_segments).to(torch.int64)


def segment_sum(data: torch.Tensor, seg: torch.Tensor, num_segments: int
                ) -> torch.Tensor:
    out = torch.zeros(num_segments + 1, dtype=data.dtype, device=data.device)
    out.index_add_(0, _trash_ids(seg, num_segments), data)
    return out[:num_segments]


def segment_extreme(data: torch.Tensor, seg: torch.Tensor,
                    num_segments: int, largest: bool) -> torch.Tensor:
    """segment_max (``largest``) or segment_min; empty segments hold the
    identity (the dtype's min, resp. max)."""
    info = torch.iinfo(data.dtype)
    ident = info.min if largest else info.max
    out = torch.full((num_segments + 1,), ident, dtype=data.dtype,
                     device=data.device)
    out.scatter_reduce_(0, _trash_ids(seg, num_segments), data,
                        reduce="amax" if largest else "amin",
                        include_self=True)
    return out[:num_segments]


# ---------------------------------------------------------------------------
# Compaction: live rows to the front, sentinel-fill the rest
# ---------------------------------------------------------------------------


def compact(cols: Sequence[torch.Tensor], weights: torch.Tensor,
            keep: torch.Tensor) -> Tuple[Cols, torch.Tensor]:
    """Move rows with ``keep`` to the front (order preserved); rest is dead.
    Gather formulation: slot j reads the (j+1)-th kept row, found by one
    searchsorted over the inclusive keep-prefix-sums (no host sync)."""
    cap = weights.shape[0]
    csum = torch.cumsum(keep.to(torch.int64), 0)
    j = torch.arange(cap, device=weights.device)
    src = torch.clamp(torch.searchsorted(csum, j + 1), max=cap - 1)
    dead = j >= csum[-1]
    out_cols = tuple(c[src].masked_fill(dead, sentinel_scalar(c.dtype))
                     for c in cols)
    return out_cols, weights[src].masked_fill(dead, 0)


# ---------------------------------------------------------------------------
# Consolidation: sort + sum weights of identical rows + compact
# ---------------------------------------------------------------------------


def _net_sorted(cols: Sequence[torch.Tensor], weights: torch.Tensor
                ) -> Tuple[Cols, torch.Tensor]:
    """Sum the weights of equal adjacent rows onto the first of each run,
    drop zero-net rows, compact."""
    cap = weights.shape[0]
    dup = rows_equal_prev(cols, cap, weights.device)
    seg = torch.cumsum((~dup).to(torch.int64), 0) - 1
    sums = segment_sum(weights, seg, cap)
    w = torch.where(dup, 0, sums[seg]).to(weights.dtype)
    return compact(cols, w, w != 0)


def consolidate_cols(cols: Sequence[torch.Tensor], weights: torch.Tensor
                     ) -> Tuple[Cols, torch.Tensor]:
    """Canonicalize a weighted row set: sort lexicographically, sum weights
    of equal rows, drop zero-net rows, pack survivors to the front. Output
    capacity == input capacity; tail rows are dead."""
    cols, (weights,) = sort_rows(cols, (weights,))
    return _net_sorted(cols, weights)


def merge_sorted_cols(cols_a: Sequence[torch.Tensor], w_a: torch.Tensor,
                      cols_b: Sequence[torch.Tensor], w_b: torch.Tensor
                      ) -> Tuple[Cols, torch.Tensor]:
    """Merge two SORTED row sets into one consolidated set of capacity
    |a|+|b| by cross-ranks: row i of ``a`` lands at ``i + |{b < a_i}|``,
    row j of ``b`` at ``j + |{a <= b_j}|`` (a bijection, equal rows
    adjacent, a's first). The reference picks this rank path on every
    accelerator; the port takes it on every device."""
    if not cols_a:  # zero-column (unit-row) sets: nothing to order
        return consolidate_cols((), torch.cat([w_a, w_b]))
    from dbsp_tpu_torch.zset import cuda_kernels

    out_cols, w = cuda_kernels.rank_merge_scatter(cols_a, w_a, cols_b, w_b)
    return _net_sorted(out_cols, w)


# ---------------------------------------------------------------------------
# Lexicographic binary search over multi-column sorted tables
# ---------------------------------------------------------------------------


def searchsorted1(table: torch.Tensor, query: torch.Tensor,
                  side: str = "left") -> torch.Tensor:
    """Single-column searchsorted; both operands widen to their common
    dtype (casting a wider query down would truncate it)."""
    dt = torch.promote_types(table.dtype, query.dtype)
    return torch.searchsorted(table.to(dt).contiguous(),
                              query.to(dt).contiguous(),
                              side=side).to(torch.int32)


def _lex_le_rows(table_cols, idx, query_cols, strict: bool) -> torch.Tensor:
    """Per-query compare: table[idx] < query (strict) or <= query, both
    sides widened to their common dtype; NaN ranks greatest."""
    lt = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    all_eq = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    for t, q in zip(table_cols, query_cols):
        dt = torch.promote_types(t.dtype, q.dtype)
        tv = t[idx].to(dt)
        qv = q.to(dt)
        col_lt = tv < qv
        if dt.is_floating_point:
            col_lt = col_lt | (torch.isnan(qv) & ~torch.isnan(tv))
        lt = lt | (all_eq & col_lt)
        all_eq = all_eq & _col_eq(tv, qv)
    return lt if strict else lt | all_eq


def lex_probe(table_cols: Sequence[torch.Tensor],
              query_cols: Sequence[torch.Tensor],
              side: str = "left") -> torch.Tensor:
    """Insertion points of ``query`` rows into the lexicographically sorted
    ``table``: a vectorized binary search, O(m log n), int32 result."""
    assert table_cols, "lex_probe requires at least one key column"
    n = table_cols[0].shape[0]
    m = query_cols[0].shape[0]
    dev = query_cols[0].device
    lo = torch.zeros((m,), dtype=torch.int64, device=dev)
    hi = torch.full((m,), n, dtype=torch.int64, device=dev)
    strict = side == "left"
    for _ in range(n.bit_length()):  # n+1 candidate points => ceil(log2(n+1))
        active = lo < hi
        mid = (lo + hi) >> 1
        # inactive lanes may sit at mid == n: clamp their (unused) read
        go_right = _lex_le_rows(table_cols, torch.clamp(mid, max=n - 1),
                                query_cols, strict)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo.to(torch.int32)


# ---------------------------------------------------------------------------
# Range expansion: per-row [lo, hi) ranges into a flat gather index list
# ---------------------------------------------------------------------------


def expand_ranges(lo: torch.Tensor, hi: torch.Tensor, out_cap: int):
    """Flatten m ranges [lo_i, hi_i) into ``out_cap`` slots: for each slot
    j < total, ``(row, src, valid)`` with the range it belongs to and its
    source index, plus the UNCLAMPED int64 ``total`` — callers compare it
    with ``out_cap`` and re-run with a grown capacity (overflow contract of
    the reference's ``kernels.expand_ranges``)."""
    counts = torch.clamp(hi.to(torch.int64) - lo.to(torch.int64), min=0)
    csum = torch.cumsum(counts, 0)
    starts = csum - counts
    total = csum[-1]
    j = torch.arange(out_cap, dtype=torch.int64, device=lo.device)
    row = torch.searchsorted(starts, torch.minimum(j, total - 1),
                             right=True) - 1
    row = torch.clamp(row, 0, lo.shape[0] - 1)
    src = lo[row].to(torch.int64) + (j - starts[row])
    return row.to(torch.int32), src.to(torch.int32), j < total, total
