"""Incremental distinct: set semantics over Z-set multiplicities.
Counterpart of ``dbsp_tpu/operators/distinct.py`` for root circuits.

For each row of the delta, compare the row's accumulated weight before the
tick with the weight after it: emit +1 where it becomes positive, -1 where
it stops being positive. The weight before the tick comes from ONE ladder
probe of the input's pre-tick trace (``cursor.old_weights_ladder``: the
CUDA probe kernel on the card), the rest is elementwise. Cost:
O(|delta| log |trace|).

The reference's nested (recursive-scope) distinct and its multi-worker
lifting are not part of the port: its circuits are root circuits with one
worker, and :func:`distinct` refuses any other circuit.
"""

from __future__ import annotations

import torch

from dbsp_tpu_torch.circuit.builder import CircuitError, RootCircuit, Stream
from dbsp_tpu_torch.circuit.operator import UnaryOperator
from dbsp_tpu_torch.operators.registry import stream_method
from dbsp_tpu_torch.operators.trace_op import TraceView
from dbsp_tpu_torch.zset import cursor, kernels
from dbsp_tpu_torch.zset.batch import Batch


def _distinct_delta(delta: Batch, old_w: torch.Tensor) -> Batch:
    """The output delta from each row's weight before the tick."""
    new_w = old_w + delta.weights
    became = (old_w <= 0) & (new_w > 0)
    ceased = (old_w > 0) & (new_w <= 0)
    live = delta.weights != 0
    out_w = torch.where(live & became, 1,
                        torch.where(live & ceased, -1, 0)
                        ).to(delta.weights.dtype)
    cols, w = kernels.compact(delta.cols, out_w, out_w != 0)
    # a consolidated delta's row order survives the compaction
    runs = (delta.cap,) if delta.sorted_runs == 1 else None
    return Batch(cols[:len(delta.keys)], cols[len(delta.keys):], w, runs)


class DistinctOp(UnaryOperator):
    name = "distinct"

    def eval(self, view: TraceView) -> Batch:
        delta = view.delta
        if not view.pre_levels:
            return _distinct_delta(delta, torch.zeros_like(delta.weights))
        return _distinct_delta(
            delta, cursor.old_weights_ladder(delta, view.pre_levels))


class StreamDistinct(UnaryOperator):
    """Per-tick set projection: weight > 0 -> 1, else the row drops."""

    name = "stream_distinct"

    def eval(self, batch: Batch) -> Batch:
        w = torch.where(batch.weights > 0, 1, 0).to(batch.weights.dtype)
        cols, w = kernels.compact(batch.cols, w, w != 0)
        runs = (batch.cap,) if batch.sorted_runs == 1 else None
        return Batch(cols[:len(batch.keys)], cols[len(batch.keys):], w, runs)


@stream_method
def distinct(self: Stream) -> Stream:
    """Incremental distinct over the stream's integral."""
    if not isinstance(self.circuit, RootCircuit):
        raise CircuitError("distinct: the port builds root circuits only; "
                           "a nested (recursive-scope) distinct is not "
                           "ported")
    t = self.trace()
    out = self.circuit.add_unary_operator(DistinctOp(), t)
    out.schema = self.schema
    return out


@stream_method
def stream_distinct(self: Stream) -> Stream:
    out = self.circuit.add_unary_operator(StreamDistinct(), self)
    out.schema = self.schema
    return out
