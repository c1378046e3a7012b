"""Input and output handles: the host <-> circuit data boundary.
Counterpart of ``dbsp_tpu/operators/io_handles.py`` for batch inputs on
one worker."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dbsp_tpu_torch.circuit.builder import Circuit, Stream
from dbsp_tpu_torch.circuit.operator import SinkOperator, SourceOperator
from dbsp_tpu_torch.operators.registry import stream_method
from dbsp_tpu_torch.zset.batch import Batch, Row


class ZSetInput(SourceOperator):
    """Source draining the batches pushed since the last tick."""

    name = "input"

    def __init__(self, key_dtypes: Sequence[torch.dtype],
                 val_dtypes: Sequence[torch.dtype], device: torch.device):
        self.key_dtypes = tuple(key_dtypes)
        self.val_dtypes = tuple(val_dtypes)
        self.device = device
        self._batches: List[Tuple[Batch, bool]] = []  # (batch, consolidated)

    def eval(self) -> Batch:
        # swap the buffer out first: batches pushed during the eval belong
        # to the next tick
        batches, self._batches = self._batches, []
        parts = [b if done else b.consolidate() for b, done in batches]
        if not parts:
            return Batch.empty(self.key_dtypes, self.val_dtypes,
                               device=self.device)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc.merge_with(p)
        return acc


class InputHandle:
    """Host-side feeder of a :class:`ZSetInput`."""

    def __init__(self, op: ZSetInput):
        self._op = op

    @property
    def device(self) -> torch.device:
        """Where the circuit's state lives; pushed batches go there."""
        return self._op.device

    def push_batch(self, batch: Batch, consolidated: bool = False) -> None:
        """Feed a batch; ``consolidated=True`` vouches that it already is
        (sorted, unique, dead sentinel tail), which skips its sort."""
        if batch.device != self._op.device:
            raise ValueError(f"batch on {batch.device}, circuit on "
                             f"{self._op.device}")
        self._op._batches.append((batch, consolidated))


class OutputOperator(SinkOperator):
    name = "output"

    def __init__(self):
        self.current: Optional[Batch] = None

    def eval(self, v: Batch) -> None:
        self.current = v


class OutputHandle:
    """Reads the value a stream produced in the latest step."""

    def __init__(self, op: OutputOperator):
        self._op = op

    def take(self) -> Optional[Batch]:
        v, self._op.current = self._op.current, None
        return v

    def to_dict(self) -> Dict[Row, int]:
        v = self._op.current
        return {} if v is None else v.to_dict()


def add_input_zset(circuit: Circuit, key_dtypes: Sequence[torch.dtype],
                   val_dtypes: Sequence[torch.dtype] = ()
                   ) -> Tuple[Stream, InputHandle]:
    op = ZSetInput(key_dtypes, val_dtypes, circuit.device)
    s = circuit.add_source(op)
    s.schema = (op.key_dtypes, op.val_dtypes)
    return s, InputHandle(op)


@stream_method
def output(self: Stream) -> OutputHandle:
    op = OutputOperator()
    self.circuit.add_sink(op, self)
    return OutputHandle(op)
