"""Watermarks: lateness bounds over an event-time column. Counterpart of
``dbsp_tpu/timeseries/watermark.py`` (without its checkpoint state).

Given a timestamp extraction, the watermark after tick t is ``max(event
time seen so far) - lateness``: a host scalar stream (``None`` until the
first live row) that drives window bounds and trace GC."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from dbsp_tpu_torch.circuit.builder import Stream
from dbsp_tpu_torch.circuit.operator import UnaryOperator
from dbsp_tpu_torch.operators.registry import stream_method
from dbsp_tpu_torch.zset.batch import Batch


def _max_live(col: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The largest value of ``col`` on a live row (device scalar); the
    caller checked that one is live."""
    lo = float("-inf") if col.dtype.is_floating_point \
        else torch.iinfo(col.dtype).min
    return torch.where(weights != 0, col, lo).max()


class WatermarkMonotonic(UnaryOperator):
    """Emits the running max of a timestamp column minus lateness. The
    running max tolerates late (but allowed) rows and retractions: the
    watermark never regresses."""

    name = "watermark"

    def __init__(self, ts_fn: Callable[[Tuple, Tuple], torch.Tensor],
                 lateness: int):
        self.ts_fn = ts_fn
        self.lateness = lateness
        self._wm: Optional[int] = None
        self._max_ts: Optional[int] = None  # the event-time frontier
        self._last_batch_max: Optional[int] = None  # the latest batch's

    def eval(self, batch: Batch) -> Optional[int]:
        if int(batch.live_count()) > 0:
            m = int(_max_live(self.ts_fn(batch.keys, batch.vals),
                              batch.weights))
            self._last_batch_max = m
            self._max_ts = m if self._max_ts is None else max(self._max_ts, m)
            cand = m - self.lateness
            self._wm = cand if self._wm is None else max(self._wm, cand)
        return self._wm  # None until the first event arrives

    def metadata(self):
        return {"watermark": self._wm, "max_event_time": self._max_ts,
                "last_batch_max": self._last_batch_max}


@stream_method
def watermark_monotonic(self: Stream, ts_fn, lateness: int = 0) -> Stream:
    """Host-scalar stream of the current watermark (``None`` before the
    first event)."""
    return self.circuit.add_unary_operator(
        WatermarkMonotonic(ts_fn, lateness), self)
