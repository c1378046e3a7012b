"""Semijoin, antijoin and ``stream_fold``: derived relational operators.
Counterpart of ``dbsp_tpu/operators/semijoin.py``.

They are built from the core incremental operators, as the reference
builds them (antijoin = A - A semijoin distinct(keys(B))), so they are
incremental as those are: on the card ``keys_distinct`` runs the lex
probe (through ``distinct``), ``semijoin`` the ladder join and
``antijoin`` the rank merge as well.
"""

from __future__ import annotations

from typing import Any, Callable

from dbsp_tpu_torch.circuit.builder import Stream
from dbsp_tpu_torch.circuit.operator import UnaryOperator
from dbsp_tpu_torch.operators.registry import require_schema, stream_method
from dbsp_tpu_torch.zset.batch import Batch


@stream_method
def keys_distinct(self: Stream) -> Stream:
    """The distinct set of this indexed Z-set's keys (the value columns
    dropped)."""
    schema = require_schema(self, "keys_distinct")
    projected = self.map_rows(lambda k, v: (k, ()), schema[0], (),
                              name="keys")
    return projected.distinct()


@stream_method
def semijoin(self: Stream, other: Stream) -> Stream:
    """Rows of self whose key appears in other, with self's weights."""
    schema = require_schema(self, "semijoin")
    return self.join_index(other.keys_distinct(), lambda k, lv, rv: (k, lv),
                           schema[0], schema[1], name="semijoin")


@stream_method
def antijoin(self: Stream, other: Stream) -> Stream:
    """Rows of self whose key does not appear in other."""
    return self.minus(self.semijoin(other))


class StreamFold(UnaryOperator):
    """Running fold over the stream's per-tick batches; the accumulator is
    any host or device value, emitted after every tick."""

    name = "stream_fold"

    def __init__(self, init: Any, fold: Callable[[Any, Batch], Any]):
        self.init = init
        self.fold = fold
        self.acc = init

    def eval(self, batch: Batch) -> Any:
        self.acc = self.fold(self.acc, batch)
        return self.acc


@stream_method
def stream_fold(self: Stream, init: Any, fold) -> Stream:
    return self.circuit.add_unary_operator(StreamFold(init, fold), self)
