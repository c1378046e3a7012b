"""Hierarchical time-aggregate index: the radix tree. Counterpart of
``dbsp_tpu/timeseries/radix_tree.py`` (one worker).

Per partition key, aggregates over aligned time buckets at geometric
granularities, so that any time range decomposes into O(log(range))
precomputed buckets and stays cheap to maintain under out-of-order
inserts and retractions.

Tree level ``L`` (1-based) is a :class:`~dbsp_tpu_torch.trace.Spine`
keyed ``(partition, prefix)`` whose value column is the aggregate over the
aligned bucket ``[prefix * R^L, (prefix+1) * R^L)``, ``R = 1 <<
radix_bits``. Level 0 is the raw ``(partition, time)`` input trace itself.
The level count is fixed at construction from ``max_time_range``, so the
update and query loops are static.

Maintenance is bottom-up and proportional to the delta: the tick's delta
dirties level-1 prefixes; each dirty bucket is recomputed by a range
gather and a segment reduction from the level below and diffed against
the stored spine (retract the old row, insert the new); the dirty
prefixes shifted right by ``radix_bits`` seed the next level. Late
inserts and retractions need no special case.

Queries: ``query(qp, qlo, qhi, ...)`` returns, per query row, the
aggregate over partition ``qp``'s rows with time in ``[qlo, qhi]``. At
level L (one position = R^L time ticks), positions whose parent bucket
lies wholly inside the range are covered by the next level; this level
gathers only the left and right fringes (< R positions each side), so a
query gathers O(R * levels) rows, not O(range).

Every gather is one launch of the ladder-consumer kernel
(``cuda_kernels.gather_ladder``, range mode with the position key column
gathered back) on a CUDA tensor, and every reduction one launch of the
segment-reduce kernel.

Aggregator contract: ``leaf_agg`` turns raw rows into a bucket value;
``combine_agg`` combines bucket values into coarser buckets and query
answers, with ``combine(leaf(A), leaf(B)) == leaf(A ∪ B)``. Max, Min and
Sum combine with themselves; Count combines with Sum.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from dbsp_tpu_torch.operators.aggregate import (Aggregator,
                                                _reduce_groups_impl)
from dbsp_tpu_torch.trace.spine import Spine
from dbsp_tpu_torch.zset import cuda_kernels, kernels
from dbsp_tpu_torch.zset.batch import Batch, bucket_cap

# ---------------------------------------------------------------------------
# Range gather over (partition, position)-keyed spines
# ---------------------------------------------------------------------------


def _range_gather_impl(qp, qlo, qhi, qlive, level: Batch, out_cap: int):
    """Rows of a (p, pos)-keyed level with p == qp[i] and pos in [qlo,
    qhi]: ``(qrow, pos col, value col, weights, total)``, sorted by (qrow,
    pos). Dead slots carry qrow == len(qp) (the trash segment); an empty
    range (qhi < qlo) gathers nothing. One level of the ladder gather,
    with distinct lo/hi probe columns and the position column gathered
    back: the tree's consumers want per-level parts with per-level
    capacities."""
    tk = level.keys[1]
    (qrow, cols, w), total = cuda_kernels.gather_ladder(
        (qp, qlo.to(tk.dtype)), qlive, [level], out_cap,
        qhi_keys=(qp, qhi.to(tk.dtype)), gather_keys=1)
    return qrow, cols[0], cols[1], w, total


class RangeGather:
    """Grow-on-demand driver for [lo, hi] range gathers over a spine's
    levels, one launch a level with a capacity per level capacity and one
    read of the match totals per call. Counts the rows gathered (the
    O(log range) query cost is asserted on it)."""

    def __init__(self):
        self.caps: Dict[int, int] = {}
        self.rows_gathered = 0

    def __call__(self, qp, qlo, qhi, qlive, levels: Sequence[Batch],
                 q_cap: int):
        """One ``(qrow, (pos, value), w)`` part per level, or None for no
        levels."""
        parts, totals, caps = [], [], []
        for level in levels:
            cap = self.caps.get(level.cap, max(64, q_cap))
            out = _range_gather_impl(qp, qlo, qhi, qlive, level, cap)
            parts.append(out[:4])
            totals.append(out[4])
            caps.append(cap)
        if not parts:
            return None
        tvals = torch.stack([t.reshape(()) for t in totals]).tolist()
        for i, t in enumerate(tvals):
            if t > caps[i]:
                cap = bucket_cap(t)
                self.caps[levels[i].cap] = cap
                parts[i] = _range_gather_impl(qp, qlo, qhi, qlive,
                                              levels[i], cap)[:4]
        self.rows_gathered += int(sum(tvals))
        return [(qrow, (t, v), w) for qrow, t, v, w in parts]


def _reduce_parts(parts, agg: Aggregator, q_cap: int):
    """The reference's ``_reduce_groups`` over per-level parts: one part
    holds unique rows; several are concatenated and netted by one
    consolidation before the reduction."""
    if len(parts) == 1:
        return _reduce_groups_impl(parts[0], agg, q_cap, net=False)
    qrow = torch.cat([p[0] for p in parts])
    vals = tuple(torch.cat([p[1][i] for p in parts])
                 for i in range(len(parts[0][1])))
    w = torch.cat([p[2] for p in parts])
    return _reduce_groups_impl((qrow, vals, w), agg, q_cap, net=True)


# ---------------------------------------------------------------------------
# The tree
# ---------------------------------------------------------------------------


def _depth_for(max_time_range: int, radix_bits: int) -> int:
    """Levels so that the top bucket is at least the largest query
    range."""
    levels = 1
    while (1 << (radix_bits * levels)) <= max_time_range:
        levels += 1
    return levels


def combine_for(agg: Aggregator) -> Aggregator:
    """Default combine semigroup for a built-in leaf aggregator."""
    from dbsp_tpu_torch.operators.aggregate import Count, Max, Min, Sum

    if isinstance(agg, Count):
        return Sum(0)
    if isinstance(agg, (Max, Min, Sum)):
        return type(agg)(0)
    raise TypeError(
        f"no default combine semigroup for {agg.name}; pass combine_agg=")


class RadixTimeIndex:
    """Per-partition hierarchical time aggregates (see module doc)."""

    def __init__(self, leaf_agg: Aggregator, part_dtype, time_dtype,
                 max_time_range: int, radix_bits: int = 4,
                 combine_agg: Optional[Aggregator] = None, *, device):
        assert len(leaf_agg.out_dtypes) == 1, (
            "RadixTimeIndex needs a single-column aggregator")
        self.agg = leaf_agg
        self.combine = combine_agg if combine_agg is not None \
            else combine_for(leaf_agg)
        self.radix_bits = radix_bits
        self.nlevels = _depth_for(max_time_range, radix_bits)
        self.part_dtype = part_dtype
        self.time_dtype = time_dtype
        self.device = torch.device(device)
        # level L (1-based): (p, prefix) -> bucket aggregate
        self.levels: List[Spine] = [
            Spine((part_dtype, time_dtype), tuple(leaf_agg.out_dtypes),
                  device=device)
            for _ in range(self.nlevels)]
        self._child_gather = [RangeGather() for _ in range(self.nlevels)]
        self._old_gather = [RangeGather() for _ in range(self.nlevels)]
        self._query_gather = [RangeGather()
                              for _ in range(self.nlevels + 1)]

    @property
    def query_rows_gathered(self) -> int:
        return sum(g.rows_gathered for g in self._query_gather)

    # -- maintenance --------------------------------------------------------
    def update(self, delta: Batch, trace_levels: Sequence[Batch]) -> None:
        """Fold the tick's (p, t)-keyed delta into the tree.

        ``trace_levels``: the post-tick levels of the raw input trace
        (level 0, the ground truth level 1 is recomputed from)."""
        if int(delta.live_count()) == 0:
            return
        bits = self.radix_bits
        dp, dt = delta.keys[0], delta.keys[1]
        p, pref = _unique_prefixes(dp, dt >> bits, delta.weights != 0)
        p, pref = _trim(p, pref)
        for L in range(1, self.nlevels + 1):
            child = trace_levels if L == 1 else self.levels[L - 2].batches
            self._update_level(L, p, pref, child)
            if L < self.nlevels:
                p, pref = _unique_prefixes(
                    p, pref >> bits, p != kernels.sentinel_scalar(p.dtype))
                p, pref = _trim(p, pref)

    def _update_level(self, L: int, p, pref, child_levels) -> None:
        """Recompute the (p, pref) buckets of level L from the level below
        (for L == 1 the children are raw rows, whose positions are
        times); one bucket spans R child positions."""
        bits = self.radix_bits
        spine = self.levels[L - 1]
        q_cap = p.shape[-1]
        qlive = p != kernels.sentinel_scalar(p.dtype)
        vdt = self.agg.out_dtypes[0]
        clo = pref << bits
        chi = ((pref + 1) << bits) - 1
        gathered = self._child_gather[L - 1](p, clo, chi, qlive,
                                             child_levels, q_cap)
        if gathered is None:
            new_val = torch.zeros(p.shape, dtype=vdt, device=self.device)
            new_present = torch.zeros(p.shape, dtype=torch.bool,
                                      device=self.device)
        else:
            # level 1 aggregates raw rows (leaf), higher levels combine
            # bucket values; the position column rides along only to
            # keep rows distinct while netting
            red = self.agg if L == 1 else self.combine
            (new_val,), new_present = _reduce_parts(gathered, _OnCol1(red),
                                                    q_cap)
        old = self._old_gather[L - 1](p, pref, pref, qlive, spine.batches,
                                      q_cap)
        if old is None:
            old_val = kernels.sentinel_fill(p.shape, vdt, self.device)
            old_present = torch.zeros(p.shape, dtype=torch.bool,
                                      device=self.device)
        else:
            (old_val,), old_present = _reduce_parts(old, _KeepCol1(), q_cap)
        diff = _bucket_diff(p, pref, qlive, new_val, new_present, old_val,
                            old_present)
        spine.insert(diff.shrink_to_fit())

    # -- queries -------------------------------------------------------------
    def query(self, qp, qlo, qhi, qlive, trace_levels: Sequence[Batch],
              q_cap: int):
        """Aggregate over raw-time range [qlo, qhi] per query row.

        Returns (vals tuple, present mask) aligned with the queries;
        ``present`` means at least one raw row lies in the range."""
        B = 1 << self.radix_bits
        raw_parts: list = []     # level-0 rows -> leaf aggregation
        bucket_parts: list = []  # level>=1 bucket values -> combine

        lo = qlo.to(torch.int64)
        hi = qhi.to(torch.int64)
        active = qlive & (lo <= hi)
        for L in range(0, self.nlevels + 1):
            levels = trace_levels if L == 0 else self.levels[L - 1].batches
            sink = raw_parts if L == 0 else bucket_parts
            # floor division (torch's // on integers floors, as jnp's
            # does): lo is negative for windows that start before time 0
            nlo = (lo + B - 1) // B   # first next-level position inside
            nhi = (hi + 1) // B       # exclusive end of covered positions
            if L == self.nlevels:
                covered = torch.zeros_like(active)
            else:
                covered = nlo < nhi
            left_hi = torch.where(covered, nlo * B - 1, hi)
            right_lo = torch.where(covered, nhi * B, hi + 1)
            for g in (self._query_gather[L](qp, lo, left_hi, active, levels,
                                            q_cap),
                      self._query_gather[L](qp, right_lo, hi,
                                            active & covered, levels,
                                            q_cap)):
                if g:
                    sink.extend(g)
            lo, hi, active = nlo, nhi - 1, active & covered

        vdt = self.agg.out_dtypes[0]

        def reduce(parts, agg):
            if not parts:
                return (torch.zeros(qp.shape, dtype=vdt, device=self.device),
                        torch.zeros(qp.shape, dtype=torch.bool,
                                    device=self.device))
            (val,), present = _reduce_parts(parts, _OnCol1(agg), q_cap)
            return val, present

        raw_val, raw_present = reduce(raw_parts, self.agg)
        buck_val, buck_present = reduce(bucket_parts, self.combine)
        val, present = _combine_partials(raw_val, raw_present, buck_val,
                                         buck_present, self.combine, q_cap)
        return (val,), present

    # -- views ---------------------------------------------------------------
    def to_dicts(self):
        return [lvl.to_dict() for lvl in self.levels]


# ---------------------------------------------------------------------------
# Helper aggregators over (position, value) part columns
# ---------------------------------------------------------------------------


class _OnCol1(Aggregator):
    """The user aggregator on value column 1 of (pos, value) parts: its
    reduce spec with every source column moved past the position column
    (one segment-reduce launch), or its own reduction on the value
    columns."""

    def __init__(self, agg: Aggregator):
        self.agg = agg
        self.out_dtypes = agg.out_dtypes
        self.name = f"oncol1<{agg.name}>"

    def reduce_spec(self):
        spec = self.agg.reduce_spec()
        if spec is None:
            return None
        return tuple((op, col + 1) for op, col in spec)

    def reduce(self, val_cols, weights, seg, num_segments):
        return self.agg.reduce(val_cols[1:], weights, seg, num_segments)


class _KeepCol1(Aggregator):
    """The unique stored row's value per bucket (column 1 of the parts):
    a max over the rows of positive weight."""

    out_dtypes = (torch.int64,)
    name = "keep1"

    def reduce_spec(self):
        return (("max", 1),)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _combine_partials(raw_val, raw_present, buck_val, buck_present,
                      combine: Aggregator, q_cap: int):
    """Fold the raw-fringe partial and the bucket partial per query row
    with the combine semigroup (an absent partial has weight 0)."""
    dev = raw_val.device
    seg = torch.cat([torch.arange(q_cap, dtype=torch.int32, device=dev)] * 2)
    dt = torch.promote_types(raw_val.dtype, buck_val.dtype)
    vals = torch.cat([raw_val.to(dt), buck_val.to(dt)])
    w = torch.cat([raw_present, buck_present]).to(torch.int64)
    out = combine.reduce((vals,), w, seg, q_cap)
    return out[0], raw_present | buck_present


def _unique_prefixes(p, pref, live):
    """Distinct live (p, prefix) pairs, compacted to the front. Inputs are
    sorted by (p, t) and prefixing is monotone in t, so (p, pref) stays
    sorted and distinctness is an adjacent-equality check."""
    p = p.masked_fill(~live, kernels.sentinel_scalar(p.dtype))
    pref = pref.masked_fill(~live, kernels.sentinel_scalar(pref.dtype))
    dup = kernels.rows_equal_prev((p, pref), n=p.shape[0])
    keep = ~dup & live
    cols, _ = kernels.compact((p, pref), keep.to(torch.int32), keep)
    return cols[0], cols[1]


def _trim(p, pref):
    """Cut compacted (p, pref) columns to the bucket of their live count
    (one scalar read), so that every per-level step is sized by the
    touched prefixes."""
    n = int((p != kernels.sentinel_scalar(p.dtype)).sum())
    cap = bucket_cap(max(n, 1))
    if cap < p.shape[-1]:
        p, pref = p[:cap], pref[:cap]
    return p, pref


def _bucket_diff(p, pref, qlive, new_val, new_present, old_val,
                 old_present) -> Batch:
    """Retract/insert delta batch for the (p, prefix) bucket rows."""
    new_val = new_val.to(old_val.dtype)
    changed = (new_present != old_present) | \
        ~kernels._col_eq(new_val, old_val)
    ins = torch.where(qlive & new_present & changed, 1, 0)
    ret = torch.where(qlive & old_present & changed, -1, 0)
    keys = (torch.cat([p, p]), torch.cat([pref, pref]))
    w = torch.cat([ins, ret]).to(torch.int64)
    cols, w = kernels.consolidate_cols(
        (*keys, torch.cat([new_val, old_val])), w)
    return Batch(cols[:2], cols[2:], w, runs=(int(w.shape[0]),))
