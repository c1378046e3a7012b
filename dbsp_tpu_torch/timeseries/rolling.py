"""Partitioned rolling aggregates: per-key sliding-range aggregation.
Counterpart of ``dbsp_tpu/timeseries/rolling.py`` (one worker).

For every input row (p, t, v) the output holds (p, t) -> the aggregate of
p's rows with time in [t - range, t]. Per tick:

  1. a delta row (p, ts) dirties the output rows (p, t') with t' in
     [ts, ts + range]: one range gather over the post-tick trace's key
     columns, plus the delta's own rows;
  2. each dirty window [t' - range, t'] is answered by the radix tree
     (``radix_tree.RadixTimeIndex``, O(log range) gathered rows a
     window) when the aggregator has a combine semigroup, else recomputed
     from the trace: one range gather, one netting consolidation and the
     aggregator's segment reduction;
  3. the result is diffed against the operator's output spine
     (retract / insert), as the incremental aggregate does.

Every range gather here is one launch of the ladder-consumer kernel over
all the trace's levels (``cuda_kernels.gather_ladder`` in range mode with
the time key column gathered back) on a CUDA tensor.

The ``*_impl`` steps keep full capacity and read no device value on the
host: the compiled engine's ``CRolling`` calls them inside a tick.
"""

from __future__ import annotations

import torch

from dbsp_tpu_torch.circuit.builder import CircuitError, Stream
from dbsp_tpu_torch.circuit.operator import UnaryOperator
from dbsp_tpu_torch.operators.aggregate import (Aggregator, GroupGather,
                                                _diff_outputs_impl,
                                                _reduce_groups_impl,
                                                _TupleMax)
from dbsp_tpu_torch.operators.registry import require_schema, stream_method
from dbsp_tpu_torch.operators.trace_op import TraceView
from dbsp_tpu_torch.trace.spine import Spine
from dbsp_tpu_torch.zset import cuda_kernels, kernels
from dbsp_tpu_torch.zset.batch import Batch, bucket_cap


def _range_gather_ladder_impl(qp, qlo, qhi, qlive, levels, out_cap: int):
    """Rows of the (p, time)-keyed ladder with p == qp and time in [qlo,
    qhi], in one launch over all levels: ``((qrow, time col + val cols,
    w), total)``; dead slots carry qrow == q_cap (the trash segment) and
    sentinel columns, ``total`` is unclamped."""
    return cuda_kernels.gather_ladder((qp, qlo), qlive, list(levels),
                                      out_cap, qhi_keys=(qp, qhi),
                                      gather_keys=1)


class RangeGather:
    """Host driver for per-row [lo, hi] time-range gathers: the whole
    ladder in one launch with one monotone output capacity, and one read
    of the match total per call (a different contract from the tree's
    per-level ``radix_tree.RangeGather``)."""

    def __init__(self):
        self.out_cap = 0

    def __call__(self, qp, qlo, qhi, qlive, levels, q_cap):
        """``(qrow, time col, val cols, w)``, or None for no levels."""
        if not levels:
            return None
        if not self.out_cap:
            self.out_cap = bucket_cap(max(64, q_cap))
        part, total = _range_gather_ladder_impl(qp, qlo, qhi, qlive, levels,
                                                self.out_cap)
        t = int(total)
        if t > self.out_cap:  # overflow: grow and relaunch
            self.out_cap = bucket_cap(t)
            part, _ = _range_gather_ladder_impl(qp, qlo, qhi, qlive, levels,
                                                self.out_cap)
        qrow, cols, w = part
        return qrow, cols[0], cols[1:], w


def _rolling_reduce_impl(wrow, wt, wvals, ww, at, agg: Aggregator,
                         a_cap: int):
    """Net the gathered window rows (keeping the time column, so that
    distinct input rows never merge), reduce per dirty slot, and require
    a live row at the slot's own time for the output to exist. The
    presence is a segment max whose empty segments hold the dtype's
    minimum (``jax.ops.segment_max``'s identity), so ``> 0`` is false
    there."""
    cols, cw = kernels.consolidate_cols((wrow, wt, *wvals), ww)
    wrow, wt, wvals = cols[0], cols[1], cols[2:]
    seg = torch.where((wrow >= 0) & (wrow < a_cap), wrow,
                      a_cap).to(torch.int32)
    outs = agg.reduce(wvals, cw, seg, a_cap + 1)
    own_time = at[torch.clamp(wrow, 0, a_cap - 1).to(torch.int64)]
    self_live = (cw > 0) & (wt == own_time)
    present = kernels.segment_extreme(self_live.to(torch.int64), seg,
                                      a_cap + 1, largest=True)
    return tuple(o[:a_cap] for o in outs), present[:a_cap] > 0


def _dirty_rows_impl(dp, dt, dlive, qrow, t, w):
    """Dirty (p, t') slots: the delta's own rows plus the gathered
    affected rows, consolidated to distinct slots (presence weights)."""
    n = dp.shape[0]
    idx = torch.clamp(qrow, 0, n - 1).to(torch.int64)
    p_g = torch.where(qrow >= 0, dp[idx],
                      kernels.sentinel_scalar(dp.dtype))
    p_all = torch.cat([dp, p_g])
    t_all = torch.cat([dt, t])
    keep = torch.cat([dlive, (w != 0) & (qrow >= 0)])
    cols, cw = kernels.consolidate_cols((p_all, t_all),
                                        keep.to(torch.int64))
    return cols[0], cols[1], cw != 0


def _dirty_delta_only_impl(dp, dt, dlive):
    cols, cw = kernels.consolidate_cols((dp, dt), dlive.to(torch.int64))
    return cols[0], cols[1], cw != 0


class RollingAggregateOp(UnaryOperator):
    """Input: keys (partition, time), vals (value cols). Output: keys
    (partition, time), vals (the aggregate's outputs).

    An aggregator with a combine semigroup (Max, Min, Sum, Count) answers
    dirty windows from a :class:`RadixTimeIndex` in O(log range)
    gathered rows each (with ``use_tree``); any other recomputes each
    window from the trace in O(window rows)."""

    def __init__(self, agg: Aggregator, range_ms: int, schema, device,
                 name=None, use_tree: bool = True):
        from dbsp_tpu_torch.timeseries.radix_tree import (RadixTimeIndex,
                                                          combine_for)

        self.agg = agg
        self.range_ms = range_ms
        self.in_schema = schema
        self.device = device
        self.out_schema = (tuple(schema[0]), tuple(agg.out_dtypes))
        self.name = name or f"rolling<{agg.name},{range_ms}>"
        self.out_spine = Spine(*self.out_schema, device=device)
        self._affected = RangeGather()
        self._windows = RangeGather()
        self._old = GroupGather()
        self.tree = None
        if use_tree and len(agg.out_dtypes) == 1 \
                and getattr(agg, "col", 0) == 0:
            try:
                combine_for(agg)
            except TypeError:
                pass
            else:
                self.tree = RadixTimeIndex(agg, schema[0][0], schema[0][1],
                                           max_time_range=range_ms,
                                           device=device)

    def eval(self, view: TraceView) -> Batch:
        delta = view.delta
        dev = self.device
        if int(delta.live_count()) == 0:
            return Batch.empty(*self.out_schema, device=dev)
        q_cap = delta.cap
        dp, dt = delta.keys[0], delta.keys[1]
        dlive = delta.weights != 0

        # 1. dirty (p, t') rows: the trace rows in [ts, ts + range] of each
        #    delta row, plus the delta rows themselves; only keys and
        #    weights matter, so the levels go without their value columns
        key_only = [Batch(b.keys, (), b.weights) for b in view.spine.batches]
        gathered = self._affected(dp, dt, dt + self.range_ms, dlive,
                                  key_only, q_cap)
        if gathered is None:
            ap, at, alive = _dirty_delta_only_impl(dp, dt, dlive)
        else:
            qrow, t, _, w = gathered
            ap, at, alive = _dirty_rows_impl(dp, dt, dlive, qrow, t, w)
        a_cap = ap.shape[-1]

        # 2. each dirty window [t' - range, t']: from the radix tree when
        # there is one, else a whole-window gather. An output row (p, t')
        # exists only while an input row at exactly (p, t') is live: the
        # retraction of (p, t') retracts its output even though neighbours
        # still populate the window.
        if self.tree is not None:
            self.tree.update(delta, view.spine.batches)
            new_vals, _ = self.tree.query(
                ap, at - self.range_ms, at, alive, view.spine.batches, a_cap)
            own = self.tree.query(ap, at, at, alive, view.spine.batches,
                                  a_cap)
            new_present = own[1]
        else:
            win = self._windows(ap, at - self.range_ms, at, alive,
                                view.spine.batches, a_cap)
            if win is None:
                new_vals = tuple(torch.zeros(alive.shape, dtype=d, device=dev)
                                 for d in self.agg.out_dtypes)
                new_present = torch.zeros(alive.shape, dtype=torch.bool,
                                          device=dev)
            else:
                new_vals, new_present = _rolling_reduce_impl(
                    win[0], win[1], win[2], win[3], at, self.agg, a_cap)

        # 3. diff against the previous outputs of the dirty keys
        old_levels = self.out_spine.batches
        old = self._old((ap, at), alive, old_levels, a_cap)
        if old is None:
            old_vals = tuple(kernels.sentinel_fill(alive.shape, d, dev)
                             for d in self.agg.out_dtypes)
            old_present = torch.zeros(alive.shape, dtype=torch.bool,
                                      device=dev)
        else:
            old_vals, old_present = _reduce_groups_impl(
                old, _TupleMax(len(self.agg.out_dtypes)), a_cap,
                net=len(old_levels) > 1)

        cols, w = _diff_outputs_impl((ap, at), alive, new_vals, new_present,
                                     old_vals, old_present)
        out = Batch(cols[:2], cols[2:], w,
                    runs=(int(w.shape[-1]),)).shrink_to_fit()
        self.out_spine.insert(out)
        return out

    def metadata(self):
        meta = {"out_levels": len(self.out_spine.batches)}
        if self.tree is not None:
            meta["tree_levels"] = [len(s.batches) for s in self.tree.levels]
            meta["tree_query_rows"] = self.tree.query_rows_gathered
        return meta


@stream_method
def partitioned_rolling_aggregate(self: Stream, agg: Aggregator,
                                  range_ms: int, name=None,
                                  use_tree: bool = True) -> Stream:
    """Per-partition rolling aggregate over [t - range_ms, t] (see module
    doc). The stream must be keyed (partition, time). ``use_tree=False``
    forces the O(window) recompute path."""
    schema = require_schema(self, "partitioned_rolling_aggregate")
    if len(schema[0]) != 2:
        raise CircuitError(
            "partitioned_rolling_aggregate needs keys (partition, time), "
            f"got {len(schema[0])} key column(s)")
    out = self.circuit.add_unary_operator(
        RollingAggregateOp(agg, range_ms, schema, self.circuit.device, name,
                           use_tree=use_tree), self.trace())
    out.schema = (tuple(schema[0]), tuple(agg.out_dtypes))
    return out
