"""The trace operator: one integrated spine of a stream, shared by its
consumers, with the view before this tick's append for bilinear
operators. Counterpart of ``dbsp_tpu/operators/trace_op.py``."""

from __future__ import annotations

import dataclasses
from typing import List

from dbsp_tpu_torch.circuit.builder import Stream
from dbsp_tpu_torch.circuit.operator import UnaryOperator
from dbsp_tpu_torch.operators.registry import require_schema, stream_method
from dbsp_tpu_torch.trace.spine import Spine
from dbsp_tpu_torch.zset.batch import Batch


@dataclasses.dataclass
class TraceView:
    """What downstream operators see on a trace stream each tick:
    ``spine`` after appending this tick's ``delta``, and ``pre_levels``,
    the level list before the append (batches are immutable, so the
    snapshot is free)."""

    spine: Spine
    delta: Batch
    pre_levels: List[Batch]


class TraceOp(UnaryOperator):
    """Maintains the integral of a stream as a spine."""

    name = "trace"

    def __init__(self, key_dtypes, val_dtypes, device):
        self.spine = Spine(key_dtypes, val_dtypes, device=device)

    def eval(self, delta: Batch) -> TraceView:
        pre = list(self.spine.batches)
        self.spine.insert(delta)
        return TraceView(self.spine, delta, pre)


@stream_method
def trace(self: Stream) -> Stream:
    """Stream of TraceViews of this stream's integral; built once per
    source stream through the circuit cache."""
    key = ("trace", self.node_index)
    cached = self.circuit.cache.get(key)
    if cached is not None:
        return cached
    schema = require_schema(self, "trace()")
    out = self.circuit.add_unary_operator(
        TraceOp(*schema, self.circuit.device), self)
    out.schema = schema
    self.circuit.cache[key] = out
    return out
