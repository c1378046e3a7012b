"""Linear per-record operators: map, filter, index. Counterpart of
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


class MapOp(UnaryOperator):
    """Per-row transform + re-consolidation (transforms may collide rows)."""

    def __init__(self, fn: RowFn, out_schema, name: str = "map"):
        self.fn = fn
        self.name = name
        self.out_schema = out_schema

    def eval_raw(self, batch: Batch) -> Batch:
        """The transformed rows without the consolidation (order unknown):
        for a compiled consumer that canonicalizes anyway."""
        nk, nv = self.fn(batch.keys, batch.vals)
        nk, nv = _pin_schema(tuple(nk), tuple(nv), self.out_schema, self.name)
        return Batch(nk, nv, batch.weights)

    def eval(self, batch: Batch) -> Batch:
        raw = self.eval_raw(batch)
        nk = len(raw.keys)
        cols, w = kernels.consolidate_cols(raw.cols, raw.weights)
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


@stream_method
def map_rows(self: Stream, fn: RowFn, key_dtypes, val_dtypes=(),
             name: str = "map") -> Stream:
    """General columnar map; declares the output schema (outputs are cast
    to it)."""
    schema = (tuple(key_dtypes), tuple(val_dtypes))
    out = self.circuit.add_unary_operator(MapOp(fn, schema, name), self)
    out.schema = schema
    return out


@stream_method
def filter_rows(self: Stream, pred: PredFn, name: str = "filter") -> Stream:
    out = self.circuit.add_unary_operator(FilterOp(pred, name), self)
    out.schema = self.schema
    return out


@stream_method
def index_by(self: Stream, key_fn: Callable[[Cols, Cols], Cols], key_dtypes,
             val_fn: Callable[[Cols, Cols], Cols] = None, val_dtypes=None,
             name: str = "index") -> Stream:
    """Re-key a Z-set: the new key columns are what joins and aggregates
    group by. Without ``val_fn`` the values are the old keys and values."""
    if val_fn is None:
        val_fn = lambda k, v: (*k, *v)  # noqa: E731
        if val_dtypes is None:
            if self.schema is None:
                raise CircuitError("index_by needs val_dtypes when the input "
                                   "stream has no schema")
            val_dtypes = (*self.schema[0], *self.schema[1])
    fn = lambda k, v: (key_fn(k, v), val_fn(k, v))  # noqa: E731
    return map_rows(self, fn, key_dtypes, val_dtypes, name=name)
