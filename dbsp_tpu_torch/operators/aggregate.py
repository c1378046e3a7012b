"""Incremental group-by aggregation (the general, trace-gather path).
Counterpart of ``dbsp_tpu/operators/aggregate.py``. Per tick:

  1. the distinct live keys Q of the delta (one compaction);
  2. every row of Q's groups from all input-spine levels, in one ladder
     gather launch (``cuda_kernels.gather_ladder``) with a grow-on-demand
     capacity;
  3. cross-level rows of one (key, val) netted by one consolidation;
  4. the aggregator's segment reduction per key (one segment-reduce
     launch, the presence mask included);
  5. the previous outputs gathered from the operator's own output spine,
     and -1 old / +1 new emitted where a key's output changed.

Every step's cost follows the delta and the touched groups, not the state.

The ``*_impl`` forms keep full capacity and return device scalars, with no
read of a device value on the host: the compiled engine's nodes
(``compiled/cnodes.py``) call them inside a tick.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from dbsp_tpu_torch.circuit.builder import Stream
from dbsp_tpu_torch.circuit.operator import UnaryOperator
from dbsp_tpu_torch.operators.registry import require_schema, stream_method
from dbsp_tpu_torch.operators.trace_op import TraceView
from dbsp_tpu_torch.trace.spine import Spine
from dbsp_tpu_torch.zset import cuda_kernels, kernels
from dbsp_tpu_torch.zset.batch import Batch, bucket_cap

# ---------------------------------------------------------------------------
# Aggregators
# ---------------------------------------------------------------------------


class Aggregator:
    """A segment reduction of the gathered group rows. The built-ins
    declare it as ``reduce_spec()``, a tuple of ``(op, source column)``
    pairs over the count/sum/min/max/avg vocabulary, which the segment
    reduce and the compiled aggregate's fused kernel run; a spec-less
    aggregator (``Fold``) writes its own :meth:`reduce`. The reduction
    sees every gathered row, absent ones (net w <= 0) included, and must
    ignore those itself."""

    out_dtypes: Tuple = ()
    name = "agg"
    #: semigroup aggregates set this: when a group's delta holds only
    #: insertions, the new output is combine(old output, reduce(delta)),
    #: with no re-gather of the group's history (the compiled fast path)
    insert_combinable = False

    def reduce_spec(self) -> Optional[Tuple[Tuple[str, int], ...]]:
        """``((op, src_col), ...)`` per output, or None for a hand-written
        reduction, which the fused kernels do not take."""
        return None

    def reduce(self, val_cols, weights, seg, num_segments: int
               ) -> Tuple[torch.Tensor, ...]:
        """The outputs per segment id: the reduce spec in one segment
        reduction; a spec-less aggregator writes its own."""
        spec = self.reduce_spec()
        if spec is None:
            raise NotImplementedError
        return segment_reduce(spec, val_cols, weights, seg, num_segments)

    def combine(self, a_vals, a_present, b_vals, b_present):
        """Semigroup combine of two per-segment partial outputs (needed
        only when ``insert_combinable``); an absent side must not leak its
        identity into the result."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Count(Aggregator):
    out_dtypes = (torch.int64,)
    name = "count"

    def reduce_spec(self):
        return (("count", 0),)


@dataclasses.dataclass(frozen=True)
class Sum(Aggregator):
    col: int = 0
    out_dtypes = (torch.int64,)
    name = "sum"

    def reduce_spec(self):
        return (("sum", self.col),)


@dataclasses.dataclass(frozen=True)
class Min(Aggregator):
    col: int = 0
    out_dtypes = (torch.int64,)
    name = "min"
    insert_combinable = True

    def reduce_spec(self):
        return (("min", self.col),)

    def combine(self, a_vals, a_present, b_vals, b_present):
        a, b = a_vals[0], b_vals[0].to(a_vals[0].dtype)
        return (torch.where(a_present & b_present, torch.minimum(a, b),
                            torch.where(a_present, a, b)),)


@dataclasses.dataclass(frozen=True)
class Average(Aggregator):
    """Integer average sum // count, truncating toward zero (SQL
    semantics, not Python's floor): -7 / 2 == -3."""

    col: int = 0
    out_dtypes = (torch.int64,)
    name = "avg"

    def reduce_spec(self):
        return (("avg", self.col),)


@dataclasses.dataclass(frozen=True)
class Max(Aggregator):
    col: int = 0
    out_dtypes = (torch.int64,)
    name = "max"
    insert_combinable = True

    def reduce_spec(self):
        return (("max", self.col),)

    def combine(self, a_vals, a_present, b_vals, b_present):
        a, b = a_vals[0], b_vals[0].to(a_vals[0].dtype)
        return (torch.where(a_present & b_present, torch.maximum(a, b),
                            torch.where(a_present, a, b)),)


@dataclasses.dataclass(frozen=True)
class Fold(Aggregator):
    """A general user-defined aggregation: ``reduce_fn(val_cols, weights,
    seg, num_segments) -> out_cols`` is any segment reduction of the
    gathered group rows, on torch tensors. Rows of net weight <= 0 must
    be ignored by masking on ``weights > 0``, as the built-ins do. For
    example a sum of squares::

        Fold(lambda v, w, s, n: (kernels.segment_sum(
            v[0] ** 2 * torch.clamp(w, min=0), s, n),))

    It has no reduce spec, so the compiled aggregate takes the stitched
    route for it (``cursor.agg_ladder``)."""

    reduce_fn: Callable = None
    out_dtypes: Tuple = (torch.int64,)
    name: str = "fold"

    def reduce(self, val_cols, weights, seg, num_segments):
        return tuple(self.reduce_fn(val_cols, weights, seg, num_segments))


@dataclasses.dataclass(frozen=True)
class _TupleMax(Aggregator):
    """Internal: recover the (unique) previous output row per key — one
    max op per column over the net-positive rows."""

    ncols: int = 1

    def reduce_spec(self):
        return tuple(("max", i) for i in range(self.ncols))


# ---------------------------------------------------------------------------
# Segment reduction
# ---------------------------------------------------------------------------


def _seg_out_dtype(op: str, col: int, val_cols, weights) -> torch.dtype:
    """Result dtype of one op, as the reference's formulation has it."""
    if op == "count":
        return weights.dtype
    if op == "present":
        return torch.int64
    v = val_cols[col]
    if op in ("min", "max"):
        return v.dtype
    return torch.promote_types(v.dtype, weights.dtype)  # sum / avg


def segment_reduce(spec, val_cols, weights: torch.Tensor, seg: torch.Tensor,
                   num_segments: int, seg_reduce=None
                   ) -> Tuple[torch.Tensor, ...]:
    """A whole reduce spec per segment id in ONE call: by default
    ``cuda_kernels.segment_reduce`` (the CUDA segment-reduce kernel on a
    CUDA tensor, its plain version on a CPU tensor); ``seg_reduce``
    names another function of its signature (the plain version)."""
    out_dtypes = tuple(_seg_out_dtype(op, col, val_cols, weights)
                       for op, col in spec)
    fn = seg_reduce or cuda_kernels.segment_reduce
    return fn(spec, val_cols, weights, seg, num_segments, out_dtypes)


def reduce_with_present(agg: Aggregator, val_cols, weights, seg,
                        num_segments: int, seg_reduce=None):
    """(outputs, presence): a spec'd aggregator's spec plus a ``present``
    op in one segment reduction; a spec-less one's own reduce, then the
    presence alone."""
    spec = agg.reduce_spec()
    if spec is None:
        outs = agg.reduce(val_cols, weights, seg, num_segments)
        (present,) = segment_reduce((("present", 0),), val_cols, weights,
                                    seg, num_segments, seg_reduce)
        return tuple(outs), present
    res = segment_reduce((*spec, ("present", 0)), val_cols, weights, seg,
                         num_segments, seg_reduce)
    return tuple(res[:-1]), res[-1]


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _delta_groups_impl(delta: Batch, nk: int):
    """Group structure of a consolidated delta in ONE run-boundary scan:
    ``(unique key cols, unique live mask, row live mask, segment id per
    row)``, all at the delta's capacity. The same first-of-group mask
    feeds the unique-key compaction and the fast path's per-row segment
    ids."""
    keys = delta.keys[:nk]
    first = ~kernels.rows_equal_prev(keys, delta.cap, delta.device)
    anylive = delta.weights != 0
    live = anylive & first
    cols, w = kernels.compact(keys, live.to(torch.int32), live)
    seg = torch.cumsum(live.to(torch.int64), 0) - 1
    return cols, w != 0, anylive, seg


def _unique_keys_impl(delta: Batch, nk: int):
    """Distinct live keys of a consolidated batch, packed to the front,
    with their live mask, at the delta's capacity."""
    cols, qlive, _, _ = _delta_groups_impl(delta, nk)
    return cols, qlive


def _unique_keys(delta: Batch, nk: int):
    """:func:`_unique_keys_impl` cut to the bucket of the distinct key
    count, so the rest of the host eval scales with the touched keys, not
    the delta's capacity (one scalar device-to-host read)."""
    qkeys, qlive = _unique_keys_impl(delta, nk)
    cap = bucket_cap(max(int(torch.count_nonzero(qlive)), 1))
    if cap < qlive.shape[-1]:
        qkeys = tuple(k[:cap] for k in qkeys)
        qlive = qlive[:cap]
    return qkeys, qlive


def _gather_level_impl(qkeys, qlive: torch.Tensor, level: Batch,
                       out_cap: int, gather=None):
    """Expand ONE level's rows matching the query keys into ``out_cap``
    slots: ``(qrow int32, val cols, w, unclamped total)``, sorted by
    (qrow, vals); dead slots carry qrow == q_cap (the trash segment) and
    sentinel vals. It is the ladder gather over a one-level ladder:
    ``gather`` names it (default ``cuda_kernels.gather_ladder``, the CUDA
    kernel on a CUDA tensor, its plain version on a CPU tensor)."""
    fn = gather or cuda_kernels.gather_ladder
    (qrow, vals, w), total = fn(qkeys, qlive, [level], out_cap)
    return qrow, vals, w, total


class GroupGather:
    """Host driver of the ladder gather: one launch over all levels, one
    monotone output capacity, one read of the match total per eval."""

    def __init__(self):
        self.out_cap = 0

    def __call__(self, qkeys, qlive, levels: Sequence[Batch], q_cap: int):
        """The gathered ``(qrow, val_cols, w)`` part, or None for an empty
        ladder."""
        if not levels:
            return None
        if not self.out_cap:
            self.out_cap = bucket_cap(max(64, q_cap))
        part, total = cuda_kernels.gather_ladder(qkeys, qlive, levels,
                                                 self.out_cap)
        t = int(total)
        if t > self.out_cap:  # overflow: grow and relaunch
            self.out_cap = bucket_cap(t)
            part, _ = cuda_kernels.gather_ladder(qkeys, qlive, levels,
                                                 self.out_cap)
        return part


def _reduce_groups_impl(part, agg: Aggregator, q_cap: int, net: bool,
                        seg_reduce=None):
    """Reduce a gathered part per query segment. A part from one level
    holds unique rows; one gathered from several levels (``net``) may hold
    insert/retract rows of one (qrow, vals), netted by a consolidation
    first. ``seg_reduce`` as in :func:`segment_reduce`."""
    qrow, val_cols, w = part
    if net:
        cols, w = kernels.consolidate_cols((qrow, *val_cols), w)
        qrow, val_cols = cols[0], cols[1:]
    # dead rows carry qrow >= q_cap (the q_cap marker, or the int32
    # sentinel after a compaction): all of them go to the trash segment
    seg = torch.clamp(qrow, max=q_cap).to(torch.int32)
    outs, present = reduce_with_present(agg, val_cols, w, seg, q_cap + 1,
                                        seg_reduce)
    return tuple(o[:q_cap] for o in outs), present[:q_cap] > 0


def _diff_outputs_impl(qkeys, qlive, new_vals, new_present, old_vals,
                       old_present):
    """The retract/insert output delta (2*q_cap capacity), consolidated."""
    changed = new_present != old_present
    for nv, ov in zip(new_vals, old_vals):
        changed = changed | ~kernels._col_eq(nv.to(ov.dtype), ov)
    insert_w = torch.where(qlive & new_present & changed, 1, 0)
    retract_w = torch.where(qlive & old_present & changed, -1, 0)
    keys = tuple(torch.cat([c, c]) for c in qkeys)
    vals = tuple(torch.cat([nv.to(ov.dtype), ov])
                 for nv, ov in zip(new_vals, old_vals))
    w = torch.cat([insert_w, retract_w]).to(torch.int64)
    return kernels.consolidate_cols((*keys, *vals), w)


class AggregateOp(UnaryOperator):
    """Incremental aggregate over a traced indexed Z-set."""

    def __init__(self, agg: Aggregator, key_dtypes, device, name=None):
        self.agg = agg
        self.name = name or f"aggregate<{agg.name}>"
        self.key_dtypes = tuple(key_dtypes)
        self.device = device
        self.out_schema = (self.key_dtypes, tuple(agg.out_dtypes))
        self.out_spine = Spine(*self.out_schema, device=device)
        self._group_gather = GroupGather()
        self._old_gather = GroupGather()

    def eval(self, view: TraceView) -> Batch:
        delta = view.delta
        nk = len(self.key_dtypes)
        if int(delta.live_count()) == 0:
            return Batch.empty(*self.out_schema, device=self.device)
        qkeys, qlive = _unique_keys(delta, nk)
        q_cap = qlive.shape[-1]

        levels = view.spine.batches
        gathered = self._group_gather(qkeys, qlive, levels, q_cap)
        if gathered is None:
            new_vals = tuple(torch.zeros(qlive.shape, dtype=d,
                                         device=self.device)
                             for d in self.agg.out_dtypes)
            new_present = torch.zeros(qlive.shape, dtype=torch.bool,
                                      device=self.device)
        else:
            new_vals, new_present = _reduce_groups_impl(
                gathered, self.agg, q_cap, net=len(levels) > 1)

        old_levels = self.out_spine.batches
        old = self._old_gather(qkeys, qlive, old_levels, q_cap)
        if old is None:
            old_vals = tuple(kernels.sentinel_fill(qlive.shape, d,
                                                   self.device)
                             for d in self.agg.out_dtypes)
            old_present = torch.zeros(qlive.shape, dtype=torch.bool,
                                      device=self.device)
        else:
            # previous outputs are one row per key: a max over the
            # net-positive rows recovers the value, presence its weight
            old_vals, old_present = _reduce_groups_impl(
                old, _TupleMax(len(self.agg.out_dtypes)), q_cap,
                net=len(old_levels) > 1)

        cols, w = _diff_outputs_impl(qkeys, qlive, new_vals, new_present,
                                     old_vals, old_present)
        # the diff has 2*q_cap capacity but few live rows
        out = Batch(cols[:nk], cols[nk:], w,
                    runs=(int(w.shape[-1]),)).shrink_to_fit()
        self.out_spine.insert(out)
        return out


@stream_method
def aggregate(self: Stream, agg, name=None) -> Stream:
    """Incremental aggregate by the stream's key columns; output is an
    indexed Z-set (key -> aggregate value) maintained under retractions.
    A linear aggregator (``LinearAverage``) takes the linear path, which
    needs no input trace; others gather their groups from the trace."""
    from dbsp_tpu_torch.operators.aggregate_linear import (LinearAggregateOp,
                                                           LinearAggregator)

    schema = require_schema(self, "aggregate")
    dev = self.circuit.device
    if isinstance(agg, LinearAggregator):
        out = self.circuit.add_unary_operator(
            LinearAggregateOp(agg, schema[0], dev, name), self)
    else:
        out = self.circuit.add_unary_operator(
            AggregateOp(agg, schema[0], dev, name), self.trace())
    out.schema = (tuple(schema[0]), tuple(agg.out_dtypes))
    return out
