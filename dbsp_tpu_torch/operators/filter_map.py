"""Linear per-record operators: map, filter, flat_map, index. Counterpart of
``dbsp_tpu/operators/filter_map.py``. The user function is a columnar
transform: it receives the batch's columns as tensors and returns new key
and value columns, so one call handles the whole batch. Transforms run on
dead (sentinel) rows too; their weight stays 0 and consolidation drops
them, so user functions must be total. PyTorch runs them eagerly (the
reference wraps them in ``jax.jit``)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from dbsp_tpu_torch.circuit.builder import CircuitError, Stream
from dbsp_tpu_torch.circuit.operator import UnaryOperator
from dbsp_tpu_torch.operators.registry import stream_method
from dbsp_tpu_torch.zset import kernels
from dbsp_tpu_torch.zset.batch import Batch

Cols = Tuple[torch.Tensor, ...]
RowFn = Callable[[Cols, Cols], Tuple[Cols, Cols]]
PredFn = Callable[[Cols, Cols], torch.Tensor]


def _pin_schema(nk: Cols, nv: Cols, out_schema, name: str
                ) -> Tuple[Cols, Cols]:
    """Cast transform outputs to the declared (key_dtypes, val_dtypes) so
    downstream spines and probes never see drifted dtypes."""
    kd, vd = out_schema
    if len(nk) != len(kd) or len(nv) != len(vd):
        raise CircuitError(f"{name}: transform arity ({len(nk)},{len(nv)}) "
                           f"!= declared schema arity ({len(kd)},{len(vd)})")
    return (tuple(c.to(d) for c, d in zip(nk, kd)),
            tuple(c.to(d) for c, d in zip(nv, vd)))


def _dead_to_sentinel(cols: Cols, weights: torch.Tensor) -> Cols:
    dead = weights == 0
    return tuple(c.masked_fill(dead, kernels.sentinel_scalar(c.dtype))
                 for c in cols)


class MapOp(UnaryOperator):
    """Per-row transform + re-consolidation (transforms may collide rows).

    ``preserves_order=True`` asserts the transform is monotone in the row
    order (e.g. currency scaling, dropping trailing columns) and skips the
    sort: colliding outputs are then adjacent, so one run-boundary scan
    merges them. The input must be consolidated (the compiled placement
    pass keeps it so)."""

    def __init__(self, fn: RowFn, out_schema, name: str = "map",
                 preserves_order: bool = False):
        self.fn = fn
        self.name = name
        self.out_schema = out_schema
        self.preserves_order = preserves_order

    def _transform(self, batch: Batch) -> Cols:
        nk, nv = self.fn(batch.keys, batch.vals)
        nk, nv = _pin_schema(tuple(nk), tuple(nv), self.out_schema, self.name)
        return (*nk, *nv)

    def eval_raw(self, batch: Batch) -> Batch:
        """The transformed rows without the consolidation (order unknown),
        dead rows at their sentinels: for a compiled consumer that
        canonicalizes anyway (row-wise transforms commute with netting)."""
        cols = _dead_to_sentinel(self._transform(batch), batch.weights)
        nk = len(self.out_schema[0])
        return Batch(cols[:nk], cols[nk:], batch.weights)

    def eval(self, batch: Batch) -> Batch:
        cols = self._transform(batch)
        if self.preserves_order:
            # sort-free consolidation: sorted input, monotone map, so
            # equal output rows are adjacent
            cap = batch.cap
            live = batch.weights != 0
            cols = _dead_to_sentinel(cols, batch.weights)
            dup = kernels.rows_equal_prev(cols, cap, batch.device) & live
            seg = torch.cumsum((~dup).to(torch.int64), 0) - 1
            sums = kernels.segment_sum(batch.weights, seg, cap)
            w = torch.where(dup, 0, sums[seg]).to(batch.weights.dtype)
            cols, w = kernels.compact(cols, w, w != 0)
        else:
            cols, w = kernels.consolidate_cols(cols, batch.weights)
        nk = len(self.out_schema[0])
        return Batch(cols[:nk], cols[nk:], w, runs=(batch.cap,))


class FilterOp(UnaryOperator):
    """Keep rows where the predicate holds: a mask and a compaction, no
    sort (input order is kept)."""

    def __init__(self, pred: PredFn, name: str = "filter"):
        self.pred = pred
        self.name = name

    def eval(self, batch: Batch) -> Batch:
        keep = self.pred(batch.keys, batch.vals) & (batch.weights != 0)
        return batch.compacted(keep)


class FlatMapOp(UnaryOperator):
    """Each row expands to up to ``fanout`` rows (a static bound).

    ``fn(keys, vals) -> (new_keys, new_vals, keep)``: each new column has
    shape ``[fanout, cap]`` and ``keep`` is a ``[fanout, cap]`` bool
    mask."""

    def __init__(self, fn, fanout: int, out_schema, name: str = "flat_map"):
        self.fn = fn
        self.fanout = fanout
        self.name = name
        self.out_schema = out_schema

    def _expand(self, batch: Batch):
        """The expanded columns ``[fanout * cap]`` and their weights (0
        where ``keep`` is off)."""
        nk, nv, keep = self.fn(batch.keys, batch.vals)
        nk, nv = _pin_schema(tuple(nk), tuple(nv), self.out_schema, self.name)
        f, cap = self.fanout, batch.cap
        w = torch.where(keep, batch.weights.expand(f, cap), 0)
        return (tuple(c.reshape(f * cap) for c in (*nk, *nv)),
                w.reshape(f * cap).to(batch.weights.dtype))

    def eval_raw(self, batch: Batch) -> Batch:
        """The expansion without the consolidation (see MapOp)."""
        cols, w = self._expand(batch)
        cols = _dead_to_sentinel(cols, w)
        nk = len(self.out_schema[0])
        return Batch(cols[:nk], cols[nk:], w)

    def eval(self, batch: Batch) -> Batch:
        cols, w = self._expand(batch)
        cols, w = kernels.consolidate_cols(cols, w)
        nk = len(self.out_schema[0])
        return Batch(cols[:nk], cols[nk:], w, runs=(int(w.shape[-1]),))


@stream_method
def map_rows(self: Stream, fn: RowFn, key_dtypes, val_dtypes=(),
             name: str = "map", preserves_order: bool = False,
             preserves_first_key: bool = False) -> Stream:
    """General columnar map; declares the output schema (outputs are cast
    to it). ``preserves_first_key`` asserts that every output row's first
    key column is its input row's: the reference keeps the stream's
    worker placement by it; with one worker it changes nothing."""
    schema = (tuple(key_dtypes), tuple(val_dtypes))
    out = self.circuit.add_unary_operator(
        MapOp(fn, schema, name, preserves_order), self)
    out.schema = schema
    return out


@stream_method
def filter_rows(self: Stream, pred: PredFn, name: str = "filter") -> Stream:
    out = self.circuit.add_unary_operator(FilterOp(pred, name), self)
    out.schema = self.schema
    return out


@stream_method
def flat_map_rows(self: Stream, fn, fanout: int, key_dtypes, val_dtypes=(),
                  name: str = "flat_map") -> Stream:
    schema = (tuple(key_dtypes), tuple(val_dtypes))
    out = self.circuit.add_unary_operator(
        FlatMapOp(fn, fanout, schema, name), self)
    out.schema = schema
    return out


@stream_method
def index_by(self: Stream, key_fn: Callable[[Cols, Cols], Cols], key_dtypes,
             val_fn: Callable[[Cols, Cols], Cols] = None, val_dtypes=None,
             name: str = "index", preserves_first_key: bool = False
             ) -> Stream:
    """Re-key a Z-set: the new key columns are what joins and aggregates
    group by. Without ``val_fn`` the values are the old keys and values.
    ``preserves_first_key`` as in :func:`map_rows`."""
    if val_fn is None:
        val_fn = lambda k, v: (*k, *v)  # noqa: E731
        if val_dtypes is None:
            if self.schema is None:
                raise CircuitError("index_by needs val_dtypes when the input "
                                   "stream has no schema")
            val_dtypes = (*self.schema[0], *self.schema[1])
    fn = lambda k, v: (key_fn(k, v), val_fn(k, v))  # noqa: E731
    return map_rows(self, fn, key_dtypes, val_dtypes, name=name,
                    preserves_first_key=preserves_first_key)
