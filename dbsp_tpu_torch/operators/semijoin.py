"""``stream_fold``: a host-side running fold over a stream's per-tick
values. Counterpart of ``StreamFold`` in ``dbsp_tpu/operators/semijoin.py``
(the semijoin and antijoin operators of that module are not ported yet)."""

from __future__ import annotations

from typing import Any, Callable

from dbsp_tpu_torch.circuit.builder import Stream
from dbsp_tpu_torch.circuit.operator import UnaryOperator
from dbsp_tpu_torch.operators.registry import stream_method
from dbsp_tpu_torch.zset.batch import Batch


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
